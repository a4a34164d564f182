"""The driver of ``train`` mixes: the program's training stream, timed.

Set-up builds one trainer from the seed's weights and drives it through
its first steps, each bucket in turn from the longest, through the
window's own call and feed (``scripts/train.py:step_stream`` over
``data/prefetch.py:device_prefetch``), one call a step so that its state
can be read between them: a bucket takes steps until its graph is
captured and then ``CHECKED_REPLAYS`` more, each on a batch of its own.
Read are every step's losses, the clipped gradient of the first step and
of each bucket's last (from Adam's first moment before and after the
step, as ``Trainer.opt_state`` gives it), and the parameters after the
last step.  Then the window: rounds of one batch a bucket, handed out by
a producer thread, uploaded by ``device_prefetch``, dispatched by
``step_stream``, with ``IN_FLIGHT_STEPS`` steps enqueued ahead of the
oldest unfinished one; issuing stops at the first round boundary after
``--seconds``.  After the window the losses of every step are read, the
trainer is freed, and the plain reference takes the set-up's steps from
the same weights and batches.

Compared, each against its limit: each loss's relative gap, worst over
every set-up step; the worst leaf's gap of the gradient, worst over the
first step and each bucket's last (a replay of its captured graph on the
card); and the worst leaf's gap of the parameters' change over all the
set-up's steps (leaves whose reference gradient is below a thousandth of
the median leaf's move by round-off alone and are left out of it).  The
notes name the step and bucket (``b1`` the shortest) of each worst.
"""

from __future__ import annotations

import collections
import dataclasses
import gc
import math
import queue
import threading
import time
from typing import Callable, Dict, List, Optional

import torch

from benchmark.core import flops, traffic, weights
from benchmark.core.cell import Outcome, Run
from benchmark.core.spans import Spans
from benchmark.core.trace import Profiled
from benchmark.reference import model as ref

ROUND_OFF_GRAD = 1e-3      # a leaf's reference gradient under this share of
                           # the median leaf's: moved by round-off alone
IN_FLIGHT_STEPS = 8        # steps enqueued ahead of the oldest unfinished
QUEUE_ROUNDS = 2           # rounds the producer thread builds ahead
WARM_STEPS_MAX = 6         # set-up steps of a bucket before its capture
CHECKED_REPLAYS = 1        # set-up steps of a bucket after its capture's


def program_configs(cfg: Dict):
    from cliora_tpu_torch.models.config import ModelConfig
    from cliora_tpu_torch.training.trainer import TrainConfig

    pick = lambda cls: cls(**{f.name: cfg[f.name]  # noqa: E731
                              for f in dataclasses.fields(cls)
                              if f.name in cfg})
    return pick(ModelConfig), pick(TrainConfig)


def host_tree(tree):
    if isinstance(tree, dict):
        return {k: host_tree(v) for k, v in tree.items()}
    return tree.detach().to("cpu", copy=True)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class SetupSteps:
    """The program's readings of the set-up's steps."""

    def __init__(self):
        self.buckets: List[int] = []        # each step's index into the edges
        self.batches: List[Dict] = []
        self.losses: List[Dict[str, float]] = []
        # the clipped gradient of some steps: {step: {path: tensor}}
        self.grads: Dict[int, Dict[str, torch.Tensor]] = {}
        self.params: Dict[str, torch.Tensor] = {}   # after the last step


def drive(trainer, batches, device, spec) -> List[Dict]:
    """Each batch through the window's feed and call, one call a step."""
    from cliora_tpu_torch.data.prefetch import device_prefetch
    from cliora_tpu_torch.scripts.train import step_stream

    metrics = []
    feed = device_prefetch(iter(batches), device,
                           int(spec["prefetch_lookahead"]))
    for bm in feed:
        for _, m in step_stream(trainer, [bm], int(spec["steps_per_call"])):
            metrics.append(m)
    return metrics


def first_moment(trainer) -> Dict[str, torch.Tensor]:
    """Adam's first moment of each trainable leaf, on the host."""
    return {k: torch.from_numpy(v)
            for k, v in trainer.opt_state()["mu"].items()}


def setup_steps(trainer, mix, device, spec) -> SetupSteps:
    """The set-up's steps, each bucket from the longest (module
    docstring); a bucket whose graph is not captured within
    ``WARM_STEPS_MAX`` steps goes on to its last."""
    out = SetupSteps()
    b1 = ref.ADAM_BETAS[0]
    for b in sorted(range(len(mix.edges)), key=lambda i: -mix.edges[i]):
        left: Optional[int] = None     # steps still to take after capture
        taken = 0
        while left is None or left > 0:
            step = len(out.losses)
            read = step == 0 or left == 1
            mu0 = first_moment(trainer) if read and step else None
            before = len(trainer.capture_seconds)
            bm = mix.batch(mix.edges[b])
            (m,) = drive(trainer, [bm], device, spec)
            out.buckets.append(b)
            out.batches.append(bm)
            out.losses.append({k: float(v) for k, v in m.items()})
            if read:
                mu = first_moment(trainer)
                out.grads[step] = {
                    k: (v - b1 * mu0[k] if mu0 is not None else v) / (1 - b1)
                    for k, v in mu.items()}
            taken += 1
            if left is not None:
                left -= 1
            elif (device.type != "cuda" or taken >= WARM_STEPS_MAX
                  or len(trainer.capture_seconds) > before):
                left = CHECKED_REPLAYS
    names = set(first_moment(trainer))
    params = trainer.full_params()
    out.params = {k: t.detach().to("cpu", copy=True)
                  for k, t in zip(ref.leaf_paths(params),
                                  ref.leaves_of(params)) if k in names}
    return out


def _short(name: str) -> str:
    return name.replace("_softmax_loss", "").replace("_loss", "")


def judge(cfg: Dict, got: SetupSteps, want: Dict, limits: Dict[str, float],
          outcome: Outcome) -> Dict[str, float]:
    """Each compared number of the set-up's steps against its limit;
    returns the readings.  A number is the worst over the steps it is
    read at, so a fault in any bucket shows; the notes name the worst
    step's bucket and leaf."""
    readings: Dict[str, float] = {}
    worst: Dict[str, str] = {}

    def take(key, value, where):
        if key not in readings or value > readings[key] \
                or not math.isfinite(value):
            readings[key] = value
            worst[key] = where

    bucket = lambda k: f"b{got.buckets[k] + 1}"  # noqa: E731
    for name in want["losses"][0]:
        if name == "total_loss":
            continue
        for k, w in enumerate(want["losses"]):
            a = (got.losses[k].get(name, math.nan) if k < len(got.losses)
                 else math.nan)
            gap = (abs(a - w[name]) / max(abs(w[name]), 1e-30)
                   if math.isfinite(a) else math.inf)
            take(f"loss_gap.{_short(name)}", gap, f"step {k} {bucket(k)}")
    for k in sorted(want["grads"]):
        g = ref.worst_leaf_gap(got.grads.get(k, {}), want["grads"][k])
        take("grad_gap", g["value"], f"step {k} {bucket(k)} {g['leaf']}")
    grad_n = {k: ref.norm(v) for k, v in want["grads"][0].items()}
    med = sorted(grad_n.values())[len(grad_n) // 2]
    skip = {k for k, v in grad_n.items() if v < ROUND_OFF_GRAD * med}
    change_got = {k: got.params[k] - want["params0"][k] for k in got.params}
    change_want = {k: want["params"][k] - want["params0"][k]
                   for k in want["params"]}
    c = ref.worst_leaf_gap(change_got, change_want, skip)
    take("param_change_gap", c["value"], c["leaf"])
    for name, value in readings.items():
        outcome.check(name, value, limits.get(name))
    edges = sorted({(b, got.batches[k]["sentences"].shape[1])
                    for k, b in enumerate(got.buckets)})
    outcome.notes.append(
        f"{len(got.losses)} set-up steps, buckets "
        f"{', '.join(f'b{b + 1}=L{n}' for b, n in edges)}, gradients read "
        f"at steps {sorted(want['grads'])}; worst: "
        f"{'; '.join(f'{k} at {v}' for k, v in worst.items())}; left out "
        f"of the change as round-off {sorted(skip)}")
    return readings


def reference_readings(cfg, params0, got: SetupSteps, device,
                       precision="float32"):
    """The reference over the set-up's steps: the same batches, and step
    ``k``'s dropout drawn from the program's stream of step ``k``."""
    from cliora_tpu_torch.training.trainer import DROPOUT_SEED

    seeds = [DROPOUT_SEED + k for k in range(len(got.batches))]
    return ref.train_steps(cfg, params0, got.batches, seeds, device,
                           precision, remat=device.type == "cuda",
                           grads_at=set(got.grads))


def build(cfg: Dict, spec: Dict, seed: int, device, fault=None):
    """Weights, the mix and the trainer of a run; ``fault`` breaks the
    trainer (the checks' own tests)."""
    from cliora_tpu_torch.training.trainer import Trainer

    mcfg, tcfg = program_configs(cfg)
    params = weights.make(cfg, seed, device)
    params0 = host_tree(params)
    bank = (traffic.image_bank(spec, cfg, seed, device)
            if cfg["use_obj"] else None)
    mix = traffic.TrainMix(spec, cfg, seed, bank)
    trainer = Trainer(mcfg, tcfg, params, device=device)
    if fault is not None:
        fault(trainer)
    return params0, mix, trainer


class _Dispatch:
    """The trainer as ``step_stream`` sees it: ``steps`` inside the
    ``dispatch`` span, with the profiled stretch started before the
    first step of a round that asks for it and ended after the last."""

    def __init__(self, trainer, spans: Spans, device):
        self.trainer, self.spans, self.device = trainer, spans, device
        self.steps_done = 0
        self.profiled = None        # the active Profiled
        self.stretch = None         # (t0, steps0) of the profiled stretch
        self.traced = None          # (Trace, seconds, steps, [(B, n)])
        self.trace_round = None     # the round the profiled stretch takes
        self.traced_shapes: List[tuple] = []

    def steps(self, group):
        rounds = [b.get("bench_round") for b in group]
        if (self.trace_round is not None and self.profiled is None
                and self.traced is None and self.trace_round in rounds):
            self.stretch = (time.perf_counter(), self.steps_done)
            self.profiled = Profiled(self.device, drain=False).__enter__()
            self.spans.tracing = True
        with self.spans.span("dispatch"):
            out = self.trainer.steps(group)
        self.steps_done += len(group)
        if self.profiled is not None:
            self.traced_shapes += [tuple(b["sentences"].shape) for b in group]
            if any(b.get("bench_round") == self.trace_round
                   and b.get("bench_last") for b in group):
                self.profiled.__exit__(None, None, None)
                self.spans.tracing = False
                t0, s0 = self.stretch
                self.traced = (self.profiled.trace,
                               time.perf_counter() - t0,
                               self.steps_done - s0, self.traced_shapes)
                self.profiled = None
        return out


def _producer(mix, q: "queue.Queue", stop: threading.Event):
    for r, rnd in enumerate(mix.rounds()):
        for i, bm in enumerate(rnd):
            bm["bench_round"] = r
            bm["bench_last"] = i == len(rnd) - 1
        while not stop.is_set():
            try:
                q.put(rnd, timeout=0.1)
                break
            except queue.Full:
                continue
        if stop.is_set():
            return


def run(cfg: Dict, spec: Dict, seed: int, seconds: float, trace: bool,
        device, limits: Dict[str, float], setup_clock: Callable[[], float],
        fault=None):
    """One run of a ``train`` cell: ``(Run, Outcome, memory_peak_bytes)``."""
    from cliora_tpu_torch.data.prefetch import device_prefetch
    from cliora_tpu_torch.scripts.train import step_stream

    spans = Spans()
    params0, mix, trainer = build(cfg, spec, seed, device, fault)
    got = setup_steps(trainer, mix, device, spec)
    _sync(device)
    # what set-up made lives to the end: out of the collector's way
    gc.collect()
    gc.freeze()

    q: "queue.Queue" = queue.Queue(maxsize=QUEUE_ROUNDS)
    stop = threading.Event()
    thread = threading.Thread(target=_producer, args=(mix, q, stop),
                              daemon=True)
    thread.start()
    disp = _Dispatch(trainer, spans, device)
    t_start = [0.0]

    def batches():
        rounds = 0
        while True:
            rnd = q.get()
            if rounds and time.perf_counter() - t_start[0] >= seconds:
                return
            if trace and disp.trace_round is None and (
                    time.perf_counter() - t_start[0] >= seconds / 2):
                disp.trace_round = rnd[0]["bench_round"]
            rounds += 1
            yield from rnd

    def timed(it):
        while True:
            with spans.span("input"):
                try:
                    bm = next(it)
                except StopIteration:
                    return
            yield bm

    in_flight = collections.deque()
    losses, shapes = [], []
    try:
        while q.empty():
            time.sleep(0.01)
        setup_s = setup_clock()
        t_start[0] = time.perf_counter()
        feed = timed(device_prefetch(batches(), device,
                                     int(spec["prefetch_lookahead"])))
        for bm, m in step_stream(disp, feed, int(spec["steps_per_call"])):
            losses.append(m["total_loss"])
            shapes.append(tuple(bm["sentences"].shape))
            if device.type == "cuda":
                ev = torch.cuda.Event()
                ev.record()
                in_flight.append(ev)
                if len(in_flight) > IN_FLIGHT_STEPS:
                    in_flight.popleft().synchronize()
        _sync(device)
        window = time.perf_counter() - t_start[0]
    finally:
        stop.set()
        thread.join(timeout=30)
        gc.unfreeze()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)

    outcome = Outcome(attempted=len(losses))
    vals = torch.stack([x.float() for x in losses]).cpu() if losses \
        else torch.zeros(0)
    outcome.failed = int((~torch.isfinite(vals)).sum())
    steps_flops = [flops.total(flops.train_step(cfg, B, n))
                   for B, n in shapes]
    res = Run(kind="train", cfg=cfg, spans=spans)
    res.window_s, res.units = window, len(shapes)
    res.sentences = sum(B for B, _ in shapes)
    res.flops = sum(steps_flops)
    if disp.traced is not None:
        tr, t_s, t_steps, t_shapes = disp.traced
        res.trace, res.traced_work = tr, t_shapes
        res.window_s -= t_s
        res.units -= t_steps
        res.sentences -= sum(B for B, _ in t_shapes)
        res.flops -= sum(flops.total(flops.train_step(cfg, B, n))
                         for B, n in t_shapes)
    res.peak_flops = flops.PEAK_FLOPS[cfg["compute_dtype"]]
    res.end_to_end["train_sentences_per_s"] = res.sentences / res.window_s
    res.end_to_end["setup_s"] = setup_s
    outcome.notes.append(
        f"window {res.window_s:.3f} s, {res.units} steps: input "
        f"{spans.total('input'):.3f} s, dispatch {spans.total('dispatch'):.3f}"
        f" s")

    # the reference, on a card the program's state has left
    del trainer, disp, losses, vals
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    want = reference_readings(cfg, params0, got, device)
    judge(cfg, got, want, limits, outcome)
    return res, outcome, peak
