"""Shared fixtures of the benchmark's tests: small widths of the cells'
configurations and mixes, and the card."""

from __future__ import annotations

import pytest
import torch

from benchmark.core import cell

TINY = dict(size=16, input_size=24, vocab_size=300, n_regions=4,
            obj_feat_size=8, k_neg=5)
SHORT = {"law": "lognormal", "mean": 1.6, "sigma": 0.4, "min": 3, "max": 8}


def tiny_config(name: str, **kw):
    cfg = dict(cell.config(cell.manifest(), name))
    cfg.update(TINY)
    cfg.update(kw)
    return cfg


def tiny_train_mix(**kw):
    spec = dict(cell.traffic("train-mix"))
    spec.update(batch=6, corpus=300, lengths=SHORT, images={"bank": 10})
    spec.update(kw)
    return spec


def tiny_parse_mix(**kw):
    spec = dict(cell.traffic("parse-corpus"))
    spec.update(corpus=400, max_batch=16, lengths=SHORT)
    spec.update(kw)
    return spec


@pytest.fixture
def card():
    """The first CUDA card; skips where there is none (the card-only
    tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the program's kernels have no CPU "
                    "mode")
    return torch.device("cuda", 0)
