"""The tracing registry of cliora_tpu_torch (utils/observability.py): its
bounded rings, its switch, its profiler events on the records' clock, the
spans and counters of ``Trainer.steps``, ``Trainer.parse`` and the
device prefetch, the phase markers of the train step, and the tools'
busy time as a union of intervals."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from cliora_tpu_torch.models.config import ModelConfig
from cliora_tpu_torch.tools import common
from cliora_tpu_torch.training import trainer as tt
from cliora_tpu_torch.utils import observability as obs

V, B, L, K = 30, 4, 5, 3


@pytest.fixture
def registry(monkeypatch):
    """An empty registry, tracing on; emptied again afterwards."""
    monkeypatch.setattr(obs, "TRACING", True)
    obs.reset()
    yield obs
    obs.reset()


def _trainer(accum_steps=1):
    cfg = ModelConfig(size=8, input_size=12, attn_dropout=0.0)
    tc = tt.TrainConfig(k_neg=K, emb_trainable=True, accum_steps=accum_steps)
    return tt.Trainer.build(cfg, tc, V, seed=0, device="cpu")


def _batch(seed=0):
    rs = np.random.RandomState(seed)
    return {"sentences": rs.randint(2, V, (B, L)),
            "neg_samples": rs.choice(V, K, replace=False)}


def _names(snap):
    """Every span record as ``(start_ns, end_ns, name)``, in time order."""
    return sorted((a, b, name) for name, s in snap["spans"].items()
                  for a, b in s["records"])


def test_ring_keeps_the_last_records_of_a_name(registry):
    for _ in range(obs.RING + 10):
        with obs.span("x"):
            pass
    snap = obs.snapshot()["spans"]["x"]
    assert snap["count"] == obs.RING + 10
    assert len(snap["records"]) == obs.RING
    assert snap["sum_ns"] >= sum(b - a for a, b in snap["records"])
    assert all(a <= b for a, b in snap["records"])


def test_tracing_off_records_and_counts_nothing(registry, monkeypatch):
    monkeypatch.setattr(obs, "TRACING", False)
    with obs.span("x"):
        obs.count("y", 3)
    tr = _trainer()
    tr.steps([_batch()])
    tr.parse(_batch())
    assert obs.snapshot() == {"counters": {}, "spans": {}}


def test_annotations_lie_on_the_records_clock(registry):
    """Under ``torch.profiler`` every span is the host event
    ``cliora.<name>``, whose start and end lie within 50 us of the
    registry's record: one clock for both."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.span("warm"):      # the profiler's first event is slow
            pass
        for _ in range(20):
            with obs.span("work"):
                torch.ones(64).sum()
    got = sorted((e.start_ns(), e.end_ns())
                 for e in prof.profiler.kineto_results.events()
                 if e.name() == "cliora.work")
    want = obs.snapshot()["spans"]["work"]["records"]
    assert len(got) == len(want) == 20
    for (a, b), (c, d) in zip(got, want):
        assert abs(a - c) <= 50_000 and abs(b - d) <= 50_000


def test_cpu_steps_record_eager_steps(registry):
    _trainer().steps([_batch(0), _batch(1)])
    snap = obs.snapshot()
    assert snap["counters"]["train.eager_steps"] == 2
    assert snap["spans"]["train.eager"]["count"] == 2
    assert snap["spans"]["train.place"]["count"] == 1
    assert "train.replays" not in snap["counters"]


def test_parse_records_its_parts_in_order(registry):
    _trainer().parse(_batch())
    snap = obs.snapshot()
    assert [n for _, _, n in _names(snap)] == [
        "parse.route", "parse.upload", "parse.forward", "parse.copy_back"]
    assert snap["counters"] == {"parse.route.plain": 1}


@pytest.mark.parametrize("accum_steps", [1, 2])
def test_train_step_marks_its_phases_in_order(registry, monkeypatch,
                                              accum_steps):
    """Forward and backward once a microbatch, then update and end."""
    seen = []
    monkeypatch.setattr(tt.Trainer, "_mark",
                        lambda self, phase: seen.append(phase))
    _trainer(accum_steps).step(_batch())
    assert seen == (["forward", "backward"] * accum_steps
                    + ["update", "end"])


def test_tools_busy_time_is_a_union():
    """Two kernels that overlap on two streams over a 12 ms step: a sum of
    their durations reads an idle share of -0.67, the union 0."""
    kernels = [(0.0, 10.0), (2.0, 12.0)]
    assert common.busy_ms(kernels) == pytest.approx(12.0)
    assert common.idle_share(common.busy_ms(kernels), 12.0) >= 0
    assert common.busy_ms([(0.0, 1.0), (2.0, 3.0), (2.5, 2.7)]) == \
        pytest.approx(2.0)


def test_prefetch_stages_each_batch_once(registry):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: on the CPU the prefetch passes "
                    "batches through unstaged")
    from cliora_tpu_torch.data.prefetch import device_prefetch

    batches = [_batch(i) for i in range(5)]
    got = list(device_prefetch(iter(batches), torch.device("cuda", 0), 2))
    torch.cuda.synchronize()
    assert len(got) == 5
    assert obs.snapshot()["spans"]["prefetch.stage"]["count"] == 5
