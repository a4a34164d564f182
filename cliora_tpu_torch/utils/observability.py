"""Experiment logging: file+console logger, running-mean accumulators,
per-batch/epoch loss reporting.

(reference: cliora/logging/configuration.py, cliora/logging/accumulator.py,
cliora/net/experiment_logger.py)
"""

from __future__ import annotations

import logging
import os
import sys
from typing import Optional

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


class ExperimentLogger:
    """Per-batch loss means + sentence-length distribution.

    (reference: cliora/net/experiment_logger.py:9-68)
    """

    def __init__(self):
        self.logger = get_logger()
        self.accumulator = Accumulator()
        self.length_hist = {}

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
        cliora/scripts/train.py:148)."""
        extra = ""
        if n_sentences is not None and wall_s:
            extra = (f" sents={n_sentences} wall={wall_s:.1f}s "
                     f"sents_per_sec={n_sentences / wall_s:.1f}")
        self.logger.info(f"epoch={epoch} step={step} EPOCH-END "
                         f"length-hist={sorted(self.length_hist.items())}"
                         f"{extra}")
        self.length_hist = {}
