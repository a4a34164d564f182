"""The port's measuring tools (cliora_tpu_torch/tools/) on the CPU: each
tool that measures the card refuses without one, the epoch plan of
``bench_bucketed`` against the JAX package's batching on the same lengths
and seed, ``autotune_buckets``' choice and flags, ``bench_l40``'s configs
and failure tags against the JAX tool's, ``bench_serving``,
``bench_bucketed`` host-side runs at D = 16, ``profile_step`` and an
``autotune_buckets`` probe on small batches,
``bench_decode``'s two decoders, the profiler aggregation of
``profile_step`` on a hand-written trace, and the ``--remat auto``
arithmetic that ``mem_analysis`` reports.  Tiny shapes; no JAX step is
compiled."""

import importlib
import importlib.util
import json
import os
import types

import numpy as np
import pytest
import torch

from cliora_tpu_torch import native
from cliora_tpu_torch.models.config import ModelConfig
from cliora_tpu_torch.ops import chart_pass
from cliora_tpu_torch.tools import (
    autotune_buckets,
    bench_bucketed,
    bench_decode,
    bench_l40,
    common,
    mem_analysis,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool(name):
    """The JAX package's tool ``tools/<name>.py`` as a module (it imports
    JAX inside its functions only)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(capsys, module, argv):
    """``module.main(argv)``: (exit code, the JSON of its last line)."""
    code = 0
    try:
        module.main(argv)
    except SystemExit as err:
        code = err.code
    lines = capsys.readouterr().out.strip().splitlines()
    return code, json.loads(lines[-1])


CARD_TOOLS = [("profile_step", []), ("bench_bucketed", []),
              ("bench_l40", []), ("autotune_buckets", []),
              ("mem_analysis", []), ("bench_serving", []),
              ("bench_matmul_pad", []),
              ("mem_analysis", ["--device", "cpu"])]


@pytest.mark.parametrize("name,argv", CARD_TOOLS,
                         ids=[n + "".join(a) for n, a in CARD_TOOLS])
def test_card_tool_refuses_without_a_card(name, argv, capsys, monkeypatch):
    """No card and no ``--device cpu``: one JSON line with ``error`` and
    exit 1, before any model is built; ``mem_analysis`` refuses with
    ``--device cpu`` too (it reads the card's allocator)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    module = importlib.import_module(f"cliora_tpu_torch.tools.{name}")
    code, out = _run(capsys, module, argv)
    assert code == 1
    assert set(out) == {"error"}
    assert "CUDA" in out["error"]


def test_sample_lengths_match_the_jax_tool():
    jax_tool = _jax_tool("bench_bucketed")
    got = bench_bucketed.sample_lengths(5000, 5, 40, np.random.RandomState(3))
    want = jax_tool.sample_lengths(5000, 5, 40, np.random.RandomState(3))
    np.testing.assert_array_equal(got, want)


def _jax_plan(lengths, rs, n_buckets, policy, batch, sizes, mixed):
    """The JAX tool's epoch (tools/bench_bucketed.py:115-163) through the
    JAX package's batching."""
    from cliora_tpu.data.batching import BatchIterator, choose_buckets
    from cliora_tpu.data.sampler import NegativeSampler

    V = common.V
    buckets = choose_buckets(lengths, n_buckets, policy=policy)
    dataset = [(i, rs.randint(2, V, n).tolist(),
                np.zeros(1, np.float32), np.zeros(1, np.float32), 0)
               for i, n in enumerate(lengths)]
    sampler = NegativeSampler(np.ones(V) / V)
    sampler.set_seed(1)
    length_to_size = None
    if sizes:
        length_to_size, prev = {}, 0
        for Lb in buckets:
            for n in range(prev + 1, Lb + 1):
                length_to_size[n] = sizes.get(Lb, batch)
            prev = Lb
    it = BatchIterator(dataset, negative_sampler=sampler, k_neg=common.KNEG,
                       batch_size=batch, include_partial=False,
                       length_buckets=buckets, prefetch=0,
                       length_to_size=length_to_size, mixed_buckets=mixed,
                       pad_batches=False)
    n_batches, rep, covered = {}, {}, 0
    for bm in it.get_iterator(random_seed=0):
        key = (bm["padded_length"], bm["batch_size"])
        n_batches[key] = n_batches.get(key, 0) + 1
        rep.setdefault(key, bm)
        covered += bm["real_size"]
    return buckets, n_batches, rep, covered


@pytest.mark.parametrize("policy", ["quantile", "work"])
@pytest.mark.parametrize("mixed", [False, True], ids=["exact", "mixed"])
@pytest.mark.parametrize("sized", [False, True], ids=["batch", "sizes"])
def test_epoch_plan_matches_jax(policy, mixed, sized):
    """The same lengths and seed: the same bucket edges, batches per
    (padded length, batch size), covered sentences and representative
    batches as the JAX tool's plan, with and without ``--mixed`` and
    ``--bucket_sizes``."""
    n, batch = 3000, 32
    lengths = bench_bucketed.sample_lengths(n, 5, 40,
                                            np.random.RandomState(0))
    sizes = None
    if sized:
        from cliora_tpu.data.batching import choose_buckets

        edges = choose_buckets(lengths, 3, policy=policy)
        sizes = {edges[0]: 64, edges[-1]: 16}
    want_b, want_n, want_rep, want_cov = _jax_plan(
        lengths, np.random.RandomState(1), 3, policy, batch, sizes, mixed)
    got = bench_bucketed.epoch_plan(
        lengths, np.random.RandomState(1), n_buckets=3, policy=policy,
        batch=batch, bucket_sizes=sizes, mixed=mixed)
    assert got["buckets"] == want_b
    assert got["n_batches"] == want_n
    assert got["covered"] == want_cov and got["dropped"] == n - want_cov
    assert set(got["rep"]) == set(want_rep)
    for key, bm in want_rep.items():
        for k in ("sentences", "lengths", "neg_samples"):
            np.testing.assert_array_equal(got["rep"][key][k], bm[k])
    if sized:
        assert {B for _, B in got["n_batches"]} >= {64, 16}


def test_parse_bucket_sizes_and_size_map():
    assert bench_bucketed.parse_bucket_sizes("9:512,12:256") == {9: 512,
                                                                 12: 256}
    got = bench_bucketed.bucket_size_map([3, 5], {5: 64}, 32)
    assert got == {1: 32, 2: 32, 3: 32, 4: 64, 5: 64}


def _probe(L, B, sps, remat=False):
    return {"B": B, "L": L, "ms_per_step": B / sps * 1e3,
            "sents_per_sec": sps, "remat": remat}


def test_autotune_choice_and_flags():
    """``--min_gain``: a 4 % win keeps the default size, a 10 % win
    upsizes; a bucket whose default probe ran out of memory takes the
    best probe that ran; a bucket where every probe failed keeps the
    default.  The flags line lists the edges and the upsized buckets."""
    cands = [128, 256, 512]
    results = {(10, 128): _probe(10, 128, 1000.0),
               (10, 256): _probe(10, 256, 1040.0),
               (10, 512): _probe(10, 512, 1030.0),
               (20, 128): _probe(20, 128, 1000.0),
               (20, 256): _probe(20, 256, 1100.0),
               (20, 512): None,
               (40, 128): None, (40, 256): _probe(40, 256, 500.0, True),
               (40, 512): None,
               (60, 128): None, (60, 256): None, (60, 512): None}
    chosen, upsized = autotune_buckets.choose(results, [10, 20, 40, 60],
                                              128, cands, 0.05)
    assert chosen == {10: 128, 20: 256, 40: 256, 60: 128}
    assert upsized == [20, 40]
    assert autotune_buckets.flags_line(4, [10, 20, 40, 60], chosen,
                                       upsized) == (
        "--n_length_buckets 4 --length_buckets 10,20,40,60 "
        "--bucket_sizes 20:256,40:256")
    chosen, upsized = autotune_buckets.choose(results, [10], 128, cands,
                                              0.02)
    assert chosen == {10: 256} and upsized == [10]
    assert autotune_buckets.flags_line(1, [10], {10: 128}, []) == (
        "--n_length_buckets 1 --length_buckets 10")


def test_autotune_projection_follows_the_chosen_sizes():
    """The projected sentences/s re-runs the sampler at the chosen sizes:
    each bucket's batches at its chosen size, weighted by its probe's ms
    a step."""
    lengths = bench_bucketed.sample_lengths(2000, 5, 40,
                                            np.random.RandomState(0))
    buckets = [12, 20, 40]
    chosen = {12: 64, 20: 32, 40: 32}
    results = {(L, B): _probe(L, B, 100.0 * (50 - L)) for L, B in
               chosen.items()}
    got = autotune_buckets.project(lengths, np.random.RandomState(1),
                                   buckets, chosen, results, 32)
    from cliora_tpu_torch.data.batching import BatchIterator
    from cliora_tpu_torch.data.sampler import NegativeSampler

    rs = np.random.RandomState(1)
    dataset = [(i, rs.randint(2, common.V, n).tolist(),
                np.zeros(1, np.float32), np.zeros(1, np.float32), 0)
               for i, n in enumerate(lengths)]
    sampler = NegativeSampler(np.ones(common.V) / common.V)
    it = BatchIterator(dataset, negative_sampler=sampler, k_neg=common.KNEG,
                       batch_size=32, length_buckets=buckets, prefetch=0,
                       length_to_size=bench_bucketed.bucket_size_map(
                           buckets, chosen, 32))
    sents, seconds = 0, 0.0
    for bm in it.get_iterator(random_seed=0):
        L = bm["padded_length"]
        sents += bm["batch_size"]
        seconds += results[(L, chosen[L])]["ms_per_step"] / 1e3
    assert got == round(sents / seconds, 1)


def test_bench_l40_configs_and_error_tags():
    """The JAX tool's nine configs, and a child's failure read as ``OOM``
    from torch's out-of-memory error (the JAX tool looks for
    RESOURCE_EXHAUSTED), else as its last line."""
    assert bench_l40.CONFIGS == _jax_tool("bench_l40").CONFIGS
    oom = ("Traceback (most recent call last):\n  ...\n"
           "torch.OutOfMemoryError: CUDA out of memory. Tried to allocate "
           "2.00 GiB\n\nThe above exception was the direct cause of the "
           "following exception:\n\nRuntimeError: CUDA graph capture of "
           "the train step failed for shape key (128, 40)")
    assert bench_l40.error_tag(oom) == "OOM"
    assert bench_l40.error_tag("x\nValueError: bad spec\n") == (
        "ValueError: bad spec")
    assert bench_l40.error_tag("") == "no output"


def test_autotune_probe_runs_on_the_cpu():
    """A probe (child mode) of a small batch on the CPU: its record's
    fields."""
    spec = {"B": 4, "L": 6, "cliora": False, "steps_per_call": 2,
            "timed_calls": 1, "remat_frac": 0.85}
    got = autotune_buckets.probe_one(spec, torch.device("cpu"))
    assert set(got) == {"B", "L", "ms_per_step", "sents_per_sec", "remat"}
    assert got["B"] == 4 and got["L"] == 6 and got["ms_per_step"] > 0
    assert got["remat"] is False


def test_bench_serving_on_the_cpu(capsys):
    """Export, load, warm and time the bundle against the live parse at
    D = 16 with four concurrent clients: the JSON fields, no eager call
    after the warm-up on the CPU's own route, and the bundle's trees
    equal to the live parse's."""
    from cliora_tpu_torch.tools import bench_serving

    code, out = _run(capsys, bench_serving, [
        "--device", "cpu", "--hidden", "16", "--batch", "8", "--length",
        "6", "--steps", "2", "--concurrency", "4", "--requests", "8"])
    assert code == 0
    for key in ("export_s", "bundle_mb", "load_s", "warmup_s",
                "bundle_ms_per_batch", "bundle_sents_per_s",
                "live_ms_per_batch", "live_sents_per_s", "parse_impl",
                "trees_equal", "device", "power_limit"):
        assert key in out, key
    assert out["parse_impl"] == "plain" and out["weights"] == "args"
    assert out["trees_equal"] == 8
    assert out["concurrency"]["clients"] == 4
    assert out["device"] == "cpu" and out["power_limit"] is None


def test_bench_bucketed_on_the_cpu(capsys):
    """Two buckets at D = 16: the JAX tool's JSON fields, and its
    throughput arithmetic from the per-bucket records."""
    code, out = _run(capsys, bench_bucketed, [
        "--device", "cpu", "--hidden", "16", "--batch", "8",
        "--sentences", "200", "--min_len", "3", "--max_len", "20",
        "--n_buckets", "2", "--steps_per_call", "2", "--timed_calls", "1"])
    assert code == 0
    for key in ("metric", "value", "unit", "buckets", "batch", "mixed",
                "covered_sentences", "dropped_sentences", "remat",
                "remat_frac", "steps_per_call", "per_bucket", "device",
                "power_limit"):
        assert key in out, key
    assert len(out["buckets"]) == 2
    assert out["covered_sentences"] + out["dropped_sentences"] == 200
    epoch_s = sum(r["n_batches"] * r["ms_per_step"] / 1e3
                  for r in out["per_bucket"].values())
    assert out["value"] == round(out["covered_sentences"] / epoch_s, 1)
    for rec in out["per_bucket"].values():
        assert set(rec) == {"ms_per_step", "sents_per_sec", "n_batches",
                            "remat", "capture_s", "loss_finite"}
        assert rec["loss_finite"] and rec["remat"] is False


def test_profile_step_on_the_cpu(capsys):
    """The bench model on a 4 x 5 batch on the CPU: wall ms and the
    fields; the device columns say "not measured" (no device trace)."""
    from cliora_tpu_torch.tools import profile_step

    code, out = _run(capsys, profile_step, [
        "--device", "cpu", "--batch", "4", "--length", "5", "--steps",
        "2"])
    assert code == 0
    assert out["wall_ms_per_step"] > 0 and out["top"] == []
    assert out["device_ms_per_step"] == "not measured"
    assert np.isfinite(out["total_loss_last"])


def test_bench_decode_trees_equal_and_cache_restored(capsys):
    """The C and Python decoders give the same trees, and the C decoder
    is in place again after the run."""
    before = native.load()
    code, out = _run(capsys, bench_decode, ["--batch", "16", "--length",
                                            "9", "--reps", "2"])
    assert code == 0
    assert native._CACHE is before
    assert out["decoders"]["python"] == "python"
    if before is not None:
        assert out["decoders"]["native_C"] == "native"
        assert out["trees_equal"] is True and out["speedup"] > 0


def test_kernel_table_averages_traced_launches():
    """Three traced calls: a kernel of two launches a call with one launch
    dropped from the trace, a kernel of one a call, and a kernel seen
    once in three calls."""
    k2 = "void span_region::k2_fwd_bf16<128>(...)"
    k4 = "void span_region::k4_dobj_regs(...)"
    events = ([("elementwise", 1.0)] * 5 + [(k2, 0.3)] * 3
              + [("once", 0.9)] + [(k4, 0.5)] * 6)
    table = common.kernel_table(events, reps=3)
    assert table["elementwise"]["count"] == 2          # 5 of 6 traced
    assert table["elementwise"]["traced"] == 5
    assert table["elementwise"]["ms"] == pytest.approx(2.0)
    assert table[k2]["count"] == 1
    assert table[k2]["ms"] == pytest.approx(0.3)
    assert table["once"]["count"] == 0
    assert table["once"]["ms"] == pytest.approx(0.3)
    assert table[k4]["count"] == 2
    classes = common.by_class(table)
    assert classes["hand"] == {"ms": pytest.approx(1.3), "launches": 3}
    assert classes["elementwise"]["launches"] == 2
    assert classes["other"]["launches"] == 0
    assert common.kernel_class("void at::native::index_elementwise_kernel"
                               "<128, 4>(...)") == "index"
    assert common.kernel_class("sm90_xmma_gemm_bf16bf16_bf16f32") == "gemm"
    launches = common.hand_launches(table)
    assert launches["span_region_fwd"] == 1
    assert launches["span_region_dobj"] == 2
    assert launches["span_region_dspan"] == 0
    assert launches["inside_cky"] == 0


def test_kernel_sources_name_op_and_port_line():
    """A forward op is named by the innermost frame of the port in its
    stack (the tool's own frames skipped); a backward op, with no Python
    stack, by the autograd function above it; each kernel's call sites
    are counted, most launches first."""
    Kernel = types.SimpleNamespace
    node = types.SimpleNamespace(
        name="autograd::engine::evaluate_function: MmBackward0",
        cpu_parent=None, stack=[], kernels=[])
    fwd = types.SimpleNamespace(
        name="aten::mm", cpu_parent=None, kernels=[Kernel(name="gemm_a")],
        stack=["/x/cliora_tpu_torch/tools/profile_step.py(90): main",
               "/x/cliora_tpu_torch/ops/chart_pass.py(123): _run_level",
               "/x/cliora_tpu_torch/training/trainer.py(620): _train_step"])
    bwd = types.SimpleNamespace(name="aten::mm", cpu_parent=node, stack=[],
                                kernels=[Kernel(name="gemm_b"),
                                         Kernel(name="gemm_a")])
    got = common.kernel_sources([fwd, bwd, node, fwd])
    assert got == {"gemm_a": [["aten::mm @ cliora_tpu_torch/ops/"
                               "chart_pass.py:123 _run_level", 2],
                              ["aten::mm < MmBackward0", 1]],
                   "gemm_b": [["aten::mm < MmBackward0", 1]]}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mem_analysis_estimate_is_remat_enabled_arithmetic(dtype):
    """``mem_analysis``' estimate is ``_ACT_COPY_FACTOR * B * D * (n^3 -
    n)/2 * itemsize``, and ``--remat auto`` remats exactly where it
    exceeds the budget."""
    itemsize = 2 if dtype == "bfloat16" else 4
    cfg = ModelConfig(size=400, compute_dtype=dtype)
    auto = ModelConfig(size=400, compute_dtype=dtype, remat="auto")
    for B, n in ((128, 20), (64, 40), (128, 40), (32, 40), (512, 12)):
        chart = B * 400 * (n ** 3 - n) // 2 * itemsize
        est = mem_analysis.estimate(cfg, B, n)
        assert est["chart_gb"] == chart / mem_analysis.GB
        assert est["estimate_gb"] == pytest.approx(
            chart_pass._ACT_COPY_FACTOR * chart / mem_analysis.GB,
            rel=1e-15)
        assert est["auto_remat"] == (
            chart_pass._ACT_COPY_FACTOR * chart > 10.0 * 2 ** 30)
        assert est["auto_remat"] == chart_pass.remat_enabled(auto, B, n, 400)
    assert mem_analysis.estimate(cfg, 128, 40)["auto_remat"]
    assert mem_analysis.estimate(cfg, 128, 20)["auto_remat"] is False
