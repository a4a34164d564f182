"""The driver of ``parse`` mixes: a corpus parse through the program, timed.

Set-up builds the model from the seed's weights, starts the decoding
process and serves one request of every request shape of the corpus.
The window is a closed loop of one client: each request is
``Trainer.parse(batch, compute_loss=False, outside=False)`` followed by
``analysis/eval.py:eval_batch_trees``, as ``scripts/parse_diora.py``
runs a batch, with the decode in a process of its own, so that the card
parses the next request while the host decodes the last; a request's
latency runs from its parse's start to its trees.  Passes over the
corpus follow one another, each in its own order; issuing stops at the
first pass boundary after ``--seconds``, and the window closes once
every request issued is decoded.  A request fails where it raises or
returns another number of trees than it has rows.

Compared against its limit: for a sample of the requests drawn from the
seed, the largest request of the longest length among them, the widest
gap by which a served tree's cost exceeds the least cost of the
reference's split scores (``benchmark/reference/cky.py``); a tree that
is not a binary tree over its sentence reads infinite.
"""

from __future__ import annotations

import gc
import os
import pickle
import queue
import subprocess
import sys
import threading
import time
from multiprocessing.connection import Connection
from typing import Callable, Dict

import numpy as np
import torch

from benchmark.core import flops, traffic, weights
from benchmark.core.cell import REPO, Outcome, Run
from benchmark.core.spans import Spans
from benchmark.core.trace import Profiled
from benchmark.core.train import host_tree, program_configs
from benchmark.reference import cky

CHECK_REQUESTS = 12     # requests whose trees are judged, drawn from the seed
TRACE_REQUESTS = 40     # requests of the profiled stretch of a traced run
DECODE_DEPTH = 64       # requests waiting for or in the decode at most


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build(cfg: Dict, spec: Dict, seed: int, device, fault=None):
    from cliora_tpu_torch.training.trainer import Trainer

    mcfg, tcfg = program_configs(cfg)
    params = weights.make(cfg, seed, device)
    params0 = host_tree(params)
    mix = traffic.ParseMix(spec, cfg, seed)
    trainer = Trainer(mcfg, tcfg, params, device=device)
    if fault is not None:
        fault(trainer)
    return params0, mix, trainer


def sample(mix, seed: int):
    """The requests whose trees are judged: ``CHECK_REQUESTS`` drawn from
    the seed, with the largest request of the longest length first."""
    sizes = [(r.shape[1], r.shape[0]) for r in mix.requests]
    longest = int(np.argmax([n * 100000 + b for n, b in sizes]))
    rs = np.random.default_rng([int(seed), 1])
    rest = rs.permutation([i for i in range(len(sizes)) if i != longest])
    return [longest] + [int(i) for i in
                        rest[:CHECK_REQUESTS - 1]]


def serve(trainer, tokens, spans: Spans):
    """One request: parse and decode; ``(trees, route)``."""
    from cliora_tpu_torch.analysis.eval import eval_batch_trees

    with spans.span("parse"):
        res, _ = trainer.parse({"sentences": tokens}, compute_loss=False,
                               outside=False)
    with spans.span("decode"):
        trees = eval_batch_trees(res["cky_bp"], tokens.shape[1])
    return [t for t, _ in trees], res.get("parse_impl")


def judge(cfg, params0, mix, kept: Dict[int, list], device,
          limits: Dict[str, float], outcome: Outcome):
    params = _to(params0, device)
    worst = 0.0
    for idx, trees in kept.items():
        if isinstance(trees, bytes):
            trees = pickle.loads(trees)
        tokens = torch.as_tensor(mix.requests[idx], device=device)
        if trees is None or len(trees) != tokens.shape[0]:
            worst = float("inf")
            continue
        gaps = cky.tree_gaps(cfg, params, tokens, trees)
        worst = max(worst, float(np.max(gaps)))
    del params
    outcome.check("tree_gap", worst, limits.get("tree_gap"))
    return worst


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)




def _decode(bp, n: int, keep: bool):
    """``(trees or None, (wall, CPU) seconds, kept)``: ``eval_batch_trees``
    over one request's backpointers; ``kept`` is the pickled trees where
    asked."""
    from cliora_tpu_torch.analysis.eval import eval_batch_trees

    t0, c0 = time.perf_counter(), time.process_time()
    try:
        trees = [t for t, _ in eval_batch_trees(bp, n)]
    except Exception:   # a decode that raises has failed
        trees = None
    dt, cpu = time.perf_counter() - t0, time.process_time() - c0
    return trees, (dt, cpu), (pickle.dumps(trees) if keep else None)


def decoder_main(read_fd: int, write_fd: int):
    """The decoding process: a request's backpointers in, the count of its
    trees (-1 where the decode failed) and its decode seconds out."""
    from cliora_tpu_torch import native
    from cliora_tpu_torch.analysis import eval as _eval  # noqa: F401

    native.load()
    # the imported modules live to the end: out of the collector's way,
    # as the parsing process's set-up is
    gc.collect()
    gc.freeze()
    inbox = Connection(read_fd, writable=False)
    outbox = Connection(write_fd, readable=False)
    while True:
        try:
            msg = inbox.recv()
        except EOFError:   # the parent has gone
            break
        if msg is None:
            break
        key, bp, n, keep = msg
        trees, dt, kept = _decode(bp, n, keep)
        outbox.send((key, -1 if trees is None else len(trees), dt, kept))


class Decoder:
    """The host decode of parsed requests, in a process of its own beside
    the parsing thread, so that the card parses the next request while
    the host decodes the last one.

    ``submit`` hands over one request's backpointers and returns at once
    unless ``DECODE_DEPTH`` requests are already waiting for or in the
    decode; a thread sends them on, so that the parsing thread never
    waits for the pipe.  ``done(key, count, seconds, kept)`` is called
    as each ends, in another thread."""

    def __init__(self, done):
        self.done = done
        self.room = threading.Semaphore(DECODE_DEPTH)
        self.idle = threading.Condition()
        self.open = 0
        self.ended = False
        child_in, to_child = os.pipe()
        from_child, child_out = os.pipe()
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                      if p])
        self.proc = subprocess.Popen(
            [sys.executable, "-c", "from benchmark.core.parse import "
             f"decoder_main; decoder_main({child_in}, {child_out})"],
            pass_fds=(child_in, child_out), cwd=REPO, env=env)
        os.close(child_in)
        os.close(child_out)
        self.inbox = Connection(to_child, readable=False)
        self.outbox = Connection(from_child, writable=False)
        # the sending and receiving threads take the interpreter soon
        # after they wake, though the parsing thread is launching kernels
        sys.setswitchinterval(0.0005)
        self.queue: "queue.Queue" = queue.Queue()
        self.threads = [threading.Thread(target=f, daemon=True)
                        for f in (self._send, self._receive)]
        for t in self.threads:
            t.start()

    def submit(self, key, bp, n: int, keep: bool):
        self.room.acquire()
        if self.ended:
            raise RuntimeError("the decoding process has ended")
        with self.idle:
            self.open += 1
        self.queue.put((key, bp, n, keep))

    def _send(self):
        while True:
            msg = self.queue.get()
            try:
                self.inbox.send(msg)
            except OSError:
                return
            if msg is None:
                return

    def _receive(self):
        while True:
            try:
                key, count, dt, kept = self.outbox.recv()
            except (EOFError, OSError):
                # the process has ended: nothing more will be decoded
                with self.idle:
                    self.ended = True
                    self.idle.notify_all()
                self.room.release()
                return
            try:
                self.done(key, count, dt, kept)
            finally:
                with self.idle:
                    self.open -= 1
                    self.idle.notify_all()
                self.room.release()

    def drain(self, timeout: float = 300.0):
        """Wait until every submitted request is decoded."""
        with self.idle:
            self.idle.wait_for(lambda: self.open == 0 or self.ended,
                               timeout)
            if self.open:
                raise RuntimeError("the decode did not finish")

    def close(self):
        """Stop the decoding process and the threads, and wait for each."""
        self.queue.put(None)
        self.threads[0].join(30)
        try:
            self.proc.wait(30)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
        self.inbox.close()
        self.threads[1].join(30)
        self.outbox.close()


def run(cfg: Dict, spec: Dict, seed: int, seconds: float, trace: bool,
        device, limits: Dict[str, float], setup_clock: Callable[[], float],
        fault=None):
    """One run of a ``parse`` cell: ``(Run, Outcome, memory_peak_bytes)``."""
    spans = Spans()
    kept: Dict[int, bytes] = {}
    outcome = Outcome()
    lat: list = []
    book = {"served": 0, "decode_cpu": 0.0}
    lock = threading.Lock()
    pending: Dict[int, tuple] = {}

    def done(key, count, seconds, got):
        dt, cpu = seconds
        idx, t0, rows, timed = pending.pop(key)
        end = time.perf_counter()
        with lock:
            if got is not None and idx not in kept:
                kept[idx] = got
            if count != rows:
                outcome.failed += 1
            if timed:
                lat.append(end - t0)
                spans.seconds.setdefault("decode", []).append(dt)
                book["decode_cpu"] += cpu
                if count == rows:
                    book["served"] += rows

    # the decoding process starts its imports while the model is built
    decoder = Decoder(done)
    try:
        params0, mix, trainer = build(cfg, spec, seed, device, fault)
        judged = sample(mix, seed)
        warm = {}
        for i, r in enumerate(mix.requests):
            warm.setdefault(r.shape, i)
        for n_key, i in enumerate(warm.values()):
            res, _ = trainer.parse({"sentences": mix.requests[i]},
                                   compute_loss=False, outside=False)
            pending[-1 - n_key] = (i, 0.0, len(mix.requests[i]), False)
            decoder.submit(-1 - n_key, res["cky_bp"],
                           mix.requests[i].shape[1], False)
        decoder.drain()
        outcome.failed = 0
        _sync(device)
        # what set-up made lives to the end: out of the collector's way
        gc.collect()
        gc.freeze()

        routes: Dict[str, int] = {}
        shapes: list = []
        traced = None
        trace_at = None
        setup_s = setup_clock()
        t_start = time.perf_counter()
        for order in mix.passes():
            if shapes and time.perf_counter() - t_start >= seconds:
                break
            for idx in order:
                tokens = mix.requests[idx]
                if (trace and traced is None and trace_at is None
                        and time.perf_counter() - t_start >= seconds / 2):
                    trace_at = (len(shapes), time.perf_counter(),
                                Profiled(device).__enter__())
                    spans.tracing = True
                timed = trace_at is None or traced is not None
                key = len(shapes)
                t0 = time.perf_counter()
                outcome.attempted += 1
                shapes.append(tokens.shape)
                try:
                    with spans.span("parse"):
                        res, _ = trainer.parse({"sentences": tokens},
                                               compute_loss=False,
                                               outside=False)
                    route = res.get("parse_impl")
                except Exception as err:   # a request that raises has failed
                    res, route = None, f"raised {type(err).__name__}: {err}"
                routes[route] = routes.get(route, 0) + 1
                if res is None:
                    with lock:
                        outcome.failed += 1
                else:
                    pending[key] = (idx, t0, tokens.shape[0], timed)
                    with spans.span("handoff"):
                        decoder.submit(key, res["cky_bp"], tokens.shape[1],
                                       idx in judged and idx not in kept)
                if trace_at is not None and traced is None:
                    if len(shapes) - trace_at[0] >= TRACE_REQUESTS:
                        prof = trace_at[2]
                        prof.__exit__(None, None, None)
                        spans.tracing = False
                        traced = (prof.trace,
                                  time.perf_counter() - trace_at[1],
                                  shapes[trace_at[0]:])
        decoder.drain()
        _sync(device)
        window = time.perf_counter() - t_start
    finally:
        decoder.close()
    gc.unfreeze()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)

    res = Run(kind="parse", cfg=cfg, spans=spans)
    res.window_s = window
    res.units = len(lat)
    res.sentences = book["served"]
    res.flops = sum(flops.total(flops.parse_forward(cfg, b, n))
                    for b, n in shapes)
    if traced is not None:
        res.trace, res.traced_work = traced[0], traced[2]
        res.window_s -= traced[1]
        res.flops -= sum(flops.total(flops.parse_forward(cfg, b, n))
                         for b, n in traced[2])
    res.peak_flops = flops.PEAK_FLOPS[cfg["compute_dtype"]]
    res.counters.update({f"route.{k}": v for k, v in routes.items()})
    res.end_to_end["parse_sentences_per_s"] = book["served"] / res.window_s
    res.counters["request_ms_p95"] = float(
        np.percentile(np.asarray(lat) * 1e3, 95))
    res.end_to_end["setup_s"] = setup_s
    outcome.notes.append(
        f"routes {routes}; window {res.window_s:.3f} s, {len(lat)} requests:"
        f" parse {spans.total('parse'):.3f} s, handoff "
        f"{spans.total('handoff'):.3f} s, decode {spans.total('decode'):.3f} s"
        f" ({book['decode_cpu']:.3f} s of CPU), slowest "
        f"{max(lat) * 1e3:.1f} ms")

    del trainer
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    judge(cfg, params0, mix, {i: kept.get(i) for i in judged}, device,
          limits, outcome)
    return res, outcome, peak
