"""Experiment logging (file+console logger, running-mean accumulators,
per-batch/epoch loss reporting) and the port's tracing registry.

(reference: cliora/logging/configuration.py, cliora/logging/accumulator.py,
cliora/net/experiment_logger.py)

The tracing registry is process-wide: ``span(name)`` times a stretch of
host work, ``count(name, n)`` adds to a counter, ``snapshot()`` reads
both and ``reset()`` clears them.  Span records carry
Unix-epoch nanoseconds (``time.time_ns``), the clock of the events of
``torch.profiler``'s trace; while a profiler is active each span is also
the host event ``cliora.<name>`` of that trace (``--profile_steps``
Chrome traces show them on the thread that ran the span).  Each name
keeps its last ``RING`` records besides a running count and sum.
``TRACING = False`` turns spans, counters and the train step's phase
markers (training/trainer.py) off; README.md "Tracing" names every
span, counter and marker the port records.
"""

from __future__ import annotations

import collections
import contextlib
import logging
import os
import sys
import threading
import time
from typing import Deque, Dict, List, Optional, Tuple

import torch.autograd.profiler as _profiler

LOGGER_NAME = "cliora_tpu_torch"
LOGGING_FORMAT = "[%(asctime)s] %(message)s"


def get_logger() -> logging.Logger:
    return logging.getLogger(LOGGER_NAME)


def configure_experiment(experiment_path: str,
                         rank: Optional[int] = None) -> logging.Logger:
    """File (``experiment.log[.rank]``) + console logging.

    (reference: cliora/logging/configuration.py:10-54)
    """
    os.makedirs(experiment_path, exist_ok=True)
    name = "experiment.log" if rank is None else f"experiment.log.{rank}"
    log_file = os.path.join(experiment_path, name)

    logger = get_logger()
    logger.setLevel(logging.INFO)
    logger.handlers.clear()
    fmt = logging.Formatter(LOGGING_FORMAT)
    fh = logging.FileHandler(log_file)
    fh.setFormatter(fmt)
    logger.addHandler(fh)
    ch = logging.StreamHandler(sys.stdout)
    ch.setFormatter(fmt)
    logger.addHandler(ch)
    return logger


class Accumulator:
    """Running mean over named values (reference: logging/accumulator.py).

    Values may be device scalars; they are only synced (float()) when a
    mean is read, so recording never blocks the dispatch pipeline.
    """

    def __init__(self):
        self.table = {}

    def record(self, key, value):
        self.table.setdefault(key, []).append(value)

    def get_mean(self, key):
        vals = self.table[key]
        return float(sum(float(v) for v in vals) / len(vals))

    def keys(self):
        return self.table.keys()

    def reset(self):
        self.table = {}


# the registry's counters an EPOCH-END line reports, as the epoch's deltas
EPOCH_COUNTERS = ("train.captures", "train.eager_steps", "train.replays",
                  "inside_cky.calls", "span_region_fwd.calls",
                  "span_region_dspan.calls", "span_region_dobj.calls",
                  "kernels.builds")


class ExperimentLogger:
    """Per-batch loss means + sentence-length distribution.

    (reference: cliora/net/experiment_logger.py:9-68)
    """

    def __init__(self):
        self.logger = get_logger()
        self.accumulator = Accumulator()
        self.length_hist = {}
        self._counted = counters()

    def record(self, result):
        for k, v in result.items():
            if "loss" in k:
                self.accumulator.record(k, v)
        length = result.get("length")
        if length is not None:
            self.length_hist[length] = self.length_hist.get(length, 0) + 1

    def log_batch(self, epoch, step, batch_idx, batch_size=None):
        keys = sorted(self.accumulator.keys())
        stats = " ".join(
            f"{k}={self.accumulator.get_mean(k):.5f}" for k in keys)
        self.logger.info(
            f"epoch={epoch} step={step} batch={batch_idx} {stats}")
        self.accumulator.reset()

    def log_epoch(self, epoch, step, n_sentences=None, wall_s=None):
        """Epoch summary; with counters, also wall-clock throughput
        (the reference logs no timing at all -- tqdm it/s only,
        cliora/scripts/train.py:148), and the epoch's deltas of the
        tracing registry's ``EPOCH_COUNTERS``: graph captures, eager
        steps, graph replays, kernel calls and kernel builds."""
        extra = ""
        if n_sentences is not None and wall_s:
            extra = (f" sents={n_sentences} wall={wall_s:.1f}s "
                     f"sents_per_sec={n_sentences / wall_s:.1f}")
        now = counters()
        extra += "".join(
            f" {k}={now.get(k, 0) - self._counted.get(k, 0)}"
            for k in EPOCH_COUNTERS)
        self._counted = now
        self.logger.info(f"epoch={epoch} step={step} EPOCH-END "
                         f"length-hist={sorted(self.length_hist.items())}"
                         f"{extra}")
        self.length_hist = {}


# -- the tracing registry ---------------------------------------------------

TRACING = True          # spans, counters and phase markers on
RING = 8192             # records kept of each span name

_LOCK = threading.Lock()
_COUNTERS: Dict[str, int] = {}
_TOTALS: Dict[str, List[int]] = {}      # name -> [count, sum of ns]
_RINGS: Dict[str, Deque[Tuple[int, int]]] = {}
_NULL = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "t0", "annotation")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.annotation = None
        if _profiler._is_profiler_enabled:
            # a host op rather than ``record_function``'s user annotation,
            # which the profiler also copies onto the device's timeline,
            # where a trace reader without activity types (torch 2.11)
            # takes it for device work.  The class is private to torch:
            # where a build lacks it the span is recorded without the event.
            try:
                from torch._C._profiler import _RecordFunctionFast
            except ImportError:
                _RecordFunctionFast = None
            if _RecordFunctionFast is not None:
                self.annotation = _RecordFunctionFast("cliora." + self.name)
                self.t0 = time.time_ns()
                self.annotation.__enter__()
                return self
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        t1 = time.time_ns()
        with _LOCK:
            total = _TOTALS.get(self.name)
            if total is None:
                total = _TOTALS[self.name] = [0, 0]
                _RINGS[self.name] = collections.deque(maxlen=RING)
            total[0] += 1
            total[1] += t1 - self.t0
            _RINGS[self.name].append((self.t0, t1))
        return False


def span(name: str):
    """Context manager that records one span of ``name``: its start and
    end in Unix-epoch ns, and, under an active profiler, the host event
    ``cliora.<name>``.  Does nothing while ``TRACING`` is false."""
    return _Span(name) if TRACING else _NULL


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (nothing while ``TRACING`` is
    false)."""
    if TRACING:
        with _LOCK:
            _COUNTERS[name] = _COUNTERS.get(name, 0) + n


def counters() -> Dict[str, int]:
    """A copy of every counter."""
    with _LOCK:
        return dict(_COUNTERS)


def snapshot() -> Dict:
    """``{"counters": {name: n}, "spans": {name: {"count", "sum_ns",
    "records": [(start_ns, end_ns), ...]}}}``, the records oldest first
    (at most ``RING`` of each name)."""
    with _LOCK:
        return {"counters": dict(_COUNTERS),
                "spans": {k: {"count": t[0], "sum_ns": t[1],
                              "records": list(_RINGS[k])}
                          for k, t in _TOTALS.items()}}


def reset() -> None:
    """Forget every span and counter."""
    with _LOCK:
        _COUNTERS.clear()
        _TOTALS.clear()
        _RINGS.clear()

