"""The readers of the per-layer metrics that read the program's tracing
registry and its phase markers, each on a synthetic trace and registry
snapshot: the train step's phases over a stretch of five steps in three
buckets, a trace whose markers do not match its steps, the dispatch and
upload spans, the parse's host spans and the idle time inside them, and
a program with no registry."""

from __future__ import annotations

import pytest

from benchmark.core import cell
from benchmark.core.trace import Trace

T0 = 1_700_000_000.0            # a Unix time, as the profiler's clock reads
MS = 1e-3
TRAIN_CFG = {"accum_steps": 1}


def ns(t: float) -> int:
    return int(round(t * 1e9))


def read(name, run):
    return cell.reader(name)(run)


@pytest.fixture
def registry(monkeypatch):
    """Makes ``snapshot()`` of the program's registry return what a test
    sets."""
    from cliora_tpu_torch.utils import observability

    snap = {"counters": {}, "spans": {}}
    monkeypatch.setattr(observability, "snapshot", lambda: snap)
    return snap


def put(snap, name, records):
    snap["spans"][name] = {"count": len(records),
                           "sum_ns": sum(b - a for a, b in records),
                           "records": list(records)}


# five traced steps of three buckets: (B, n) -> (forward, backward, update) ms
STEPS = [((128, 9), (10.0, 20.0, 1.0)), ((128, 40), (60.0, 120.0, 2.0)),
         ((128, 13), (15.0, 30.0, 1.0)), ((128, 9), (12.0, 22.0, 1.0)),
         ((128, 40), (64.0, 124.0, 2.0))]


def train_trace(steps=STEPS, drop_marker=False):
    """Each step: its four markers, one kernel a phase filling it, and
    between steps a device-to-device copy of the outputs; an upload's
    host-to-device copy on its own stream overlaps each forward."""
    ops, t = [], T0
    for k, (_, (f, b, u)) in enumerate(steps):
        for phase, ms in (("forward", f), ("backward", b), ("update", u)):
            if not (drop_marker and k == 2 and phase == "backward"):
                ops.append((f"cliora_mark_{phase}", t, t + 1e-6))
            ops.append((f"void kernel_{phase}<128>(...)", t, t + ms * MS))
            if phase == "forward":
                ops.append(("Memcpy HtoD (Pinned -> Device)", t,
                            t + 2 * ms * MS))
            t += ms * MS
        ops.append(("cliora_mark_end", t, t + 1e-6))
        ops.append(("Memcpy DtoD (Device -> Device)", t + 1e-6, t + 0.5 * MS))
        t += 1 * MS
    return Trace(ops, [], (T0, t))


def train_run(trace=None, steps=STEPS):
    run = cell.Run(kind="train", cfg=dict(TRAIN_CFG), spans=None)
    run.trace = train_trace(steps) if trace is None else trace
    run.traced_work = [shape for shape, _ in steps]
    return run


def test_phases_read_one_round_of_a_five_step_stretch():
    run = train_run()
    # bucket means: n=9 (10+12)/2, n=40 (60+64)/2, n=13 15
    assert read("forward_ms_per_round.train", run) == pytest.approx(
        11.0 + 62.0 + 15.0, abs=1e-3)
    assert read("backward_ms_per_round.train", run) == pytest.approx(
        21.0 + 122.0 + 30.0, abs=1e-3)
    assert read("update_ms_per_round.train", run) == pytest.approx(
        1.0 + 2.0 + 1.0, abs=1e-3)
    # the L=40 steps: 182 and 190 ms from the first marker to the last
    assert read("longest_step_ms.train", run) == pytest.approx(
        186.0, abs=1e-3)


def test_markers_that_do_not_match_the_steps_read_none():
    for trace in (train_trace(drop_marker=True), train_trace(STEPS[:4])):
        run = train_run(trace)
        for name in ("forward_ms_per_round.train",
                     "backward_ms_per_round.train",
                     "update_ms_per_round.train", "longest_step_ms.train"):
            assert read(name, run) is None, name


def test_a_trace_of_the_parent_reads_none():
    """A program without markers: every phase reads nothing."""
    ops = [op for op in train_trace().ops if "cliora_mark" not in op[0]]
    run = train_run(Trace(ops, [], (T0, T0 + 1.0)))
    assert read("forward_ms_per_round.train", run) is None
    assert read("longest_step_ms.train", run) is None


def test_dispatch_reads_the_host_parts_of_replays_outside_the_stretch(
        registry):
    """Two groups outside the stretch (two replays, then one) and one
    inside it: place / group + copy-in + reseed + collect, the launch
    left out."""
    groups = [(T0 - 10.0, 2, 0.4 * MS, [0.1, 0.2]),
              (T0 - 5.0, 1, 0.3 * MS, [0.3]),
              (T0 + 0.1, 1, 9.0 * MS, [9.0])]
    place, copy_in, reseed, launch, collect = [], [], [], [], []
    for t, n, placed, parts in groups:
        place.append((ns(t), ns(t + placed)))
        t += placed
        for ms in parts:
            for spans, dt in ((copy_in, ms), (reseed, ms), (launch, 50.0),
                              (collect, ms)):
                spans.append((ns(t), ns(t + dt * MS)))
                t += dt * MS
    for name, recs in (("train.place", place), ("train.copy_in", copy_in),
                       ("train.reseed", reseed), ("train.launch", launch),
                       ("train.collect", collect)):
        put(registry, name, recs)
    run = train_run()
    # per replay: 0.2 + 3 * 0.1, 0.2 + 3 * 0.2, 0.3 + 3 * 0.3
    assert read("dispatch_host_ms_per_step.train", run) == pytest.approx(
        0.8, abs=1e-3)


def test_upload_reads_the_median_stage_outside_the_stretch(registry):
    put(registry, "prefetch.stage",
        [(ns(T0 - 3.0), ns(T0 - 3.0 + 8 * MS)),
         (ns(T0 - 2.0), ns(T0 - 2.0 + 10 * MS)),
         (ns(T0 - 1.0), ns(T0 - 1.0 + 12 * MS)),
         (ns(T0 + 0.1), ns(T0 + 0.1 + 90 * MS))])
    assert read("upload_stage_ms_per_step.train", train_run()) == \
        pytest.approx(10.0, abs=1e-3)


def parse_run(registry, window=(T0, T0 + 0.1)):
    """Three requests before the stretch and two inside it; the device is
    busy 20-30 ms and 60-90 ms into the stretch."""
    parts = ("parse.route", "parse.upload", "parse.forward",
             "parse.copy_back")
    recs = {p: [] for p in parts}
    starts = [T0 - 3.0, T0 - 2.0, T0 - 1.0, T0 + 10 * MS, T0 + 50 * MS]
    host = [(0.1, 1.0, 2.0), (0.1, 2.0, 3.0), (0.1, 1.5, 2.5),
            (0.1, 4.9, 5.0), (0.1, 4.9, 5.0)]
    for t, ms in zip(starts, host):
        for p, dt in zip(parts, ms + (20.0,)):
            recs[p].append((ns(t), ns(t + dt * MS)))
            t += dt * MS
    for p in parts:
        put(registry, p, recs[p])
    run = cell.Run(kind="parse", cfg={}, spans=None)
    run.trace = Trace([("inside_cky", T0 + 20 * MS, T0 + 30 * MS),
                       ("inside_cky", T0 + 60 * MS, T0 + 90 * MS)],
                      [], window)
    run.traced_work = [(512, 20), (512, 21)]
    return run


def test_parse_host_reads_the_median_request_outside_the_stretch(registry):
    run = parse_run(registry)
    # route + upload + forward: 3.1, 5.1, 4.1 ms outside; 10.0 inside
    assert read("parse_host_ms_per_request.parse", run) == pytest.approx(
        4.1, abs=1e-3)


def test_program_idle_reads_the_idle_time_inside_the_parse_spans(registry):
    """Request 1 spans 10-40 ms, request 2 50-80 ms of the stretch; the
    device idles 0-20, 30-60 and 90-100 ms: 10 + 10 + 10 ms inside the
    spans, over two requests."""
    run = parse_run(registry)
    assert read("program_idle_ms_per_request.parse", run) == pytest.approx(
        15.0, abs=1e-3)
    # none of the registry's spans inside the stretch: nothing to read
    run.trace.window = (T0 + 200 * MS, T0 + 300 * MS)
    assert read("program_idle_ms_per_request.parse", run) is None


def test_a_program_without_a_registry_reads_none(monkeypatch):
    from cliora_tpu_torch.utils import observability

    monkeypatch.delattr(observability, "snapshot")
    train, parse = train_run(), cell.Run(kind="parse", cfg={}, spans=None)
    parse.trace, parse.traced_work = Trace([], [], (T0, T0 + 1.0)), [(8, 5)]
    for name in ("dispatch_host_ms_per_step.train",
                 "upload_stage_ms_per_step.train"):
        assert read(name, train) is None, name
    for name in ("parse_host_ms_per_request.parse",
                 "program_idle_ms_per_request.parse"):
        assert read(name, parse) is None, name
