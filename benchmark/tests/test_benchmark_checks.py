"""The check that decides ``correct``: a sound run passes it, and a run
with its timed path broken underneath, or with the reference in a lower
precision in the program's place, does not.  Small widths on the CPU,
with each cell's own limits."""

from __future__ import annotations

import pytest
import torch

import benchmark.calibrate as calibrate
from benchmark.core import cell, faults, parse, train
from benchmark.tests.conftest import (
    tiny_config,
    tiny_parse_mix,
    tiny_train_mix,
)

CPU = torch.device("cpu")
TRAIN = "cliora-flickr-bf16.train-mix"
PARSE = "diora-flickr-f32.parse-corpus"


def _train(fault=None, seed=11, **cfg_kw):
    cfg = tiny_config("cliora-flickr-bf16", **cfg_kw)
    return train.run(cfg, tiny_train_mix(), seed, 0.3, False, CPU,
                     cell.limits(TRAIN), lambda: 0.0, fault)


def _parse(fault=None, seed=12):
    cfg = tiny_config("diora-flickr-f32")
    return parse.run(cfg, tiny_parse_mix(), seed, 0.3, False, CPU,
                     cell.limits(PARSE), lambda: 0.0, fault)


@pytest.mark.parametrize("seed", [11, 2 ** 31 + 11])
def test_a_sound_train_run_is_correct(seed):
    run, outcome, _ = _train(seed=seed, compute_dtype="float32")
    assert outcome.attempted > 0 and outcome.failed == 0
    assert outcome.correct, outcome.checks
    assert run.end_to_end["train_sentences_per_s"] > 0


@pytest.mark.parametrize("name", sorted(faults.FAULTS["train"]))
def test_a_broken_train_step_is_not_correct(name):
    _, outcome, _ = _train(faults.FAULTS["train"][name],
                           compute_dtype="float32")
    assert not outcome.correct, outcome.checks


def test_a_sound_parse_run_is_correct():
    run, outcome, _ = _parse()
    assert outcome.attempted > 0 and outcome.failed == 0
    assert outcome.correct, outcome.checks
    assert run.end_to_end["parse_sentences_per_s"] > 0
    assert run.counters["request_ms_p95"] > 0


@pytest.mark.parametrize("name", sorted(faults.FAULTS["parse"]))
def test_a_broken_parse_is_not_correct(name):
    _, outcome, _ = _parse(faults.FAULTS["parse"][name])
    assert not outcome.correct, (outcome.failed, outcome.checks)


def test_the_train_control_fails_the_limits():
    """The reference in fp8 in the program's place (the configuration
    states bfloat16) fails at least one of the cell's numbers."""
    cfg = tiny_config("cliora-flickr-bf16")
    limits = cell.limits(TRAIN)
    for seed in (1, 2, 3):
        readings, _ = calibrate.train_readings(cfg, tiny_train_mix(), seed,
                                               CPU, "control")
        assert any(v > limits[k] for k, v in readings.items()), readings


def test_the_parse_control_fails_the_limit():
    """The reference in TF32 in the program's place (the configuration
    states float32 with TF32 off) picks trees the f32 reference scores
    worse by more than the limit."""
    cfg = tiny_config("diora-flickr-f32", size=64, input_size=64)
    spec = tiny_parse_mix(corpus=3000, max_batch=256,
                          lengths={"law": "fixed", "value": 14})
    limit = cell.limits(PARSE)["tree_gap"]
    for seed in (1, 2, 3):
        readings, _ = calibrate.parse_readings(cfg, spec, seed, CPU,
                                               "control")
        assert readings["tree_gap"] > limit, readings
