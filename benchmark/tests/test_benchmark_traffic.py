"""The traffic generator, the harness's refusal without a card, and a
new cell made of new files only."""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys

import numpy as np

from benchmark.core import cell, traffic
from benchmark.tests.conftest import tiny_config, tiny_parse_mix

REPO = cell.REPO


def _mix(seed, **kw):
    spec = cell.traffic("train-mix")
    spec.update(kw)
    cfg = tiny_config("cliora-flickr-bf16")
    bank = np.zeros((8, cfg["n_regions"], cfg["obj_feat_size"]), np.float32)
    bank += np.arange(8, dtype=np.float32)[:, None, None]
    return traffic.TrainMix(spec, cfg, seed, bank)


def _rounds(mix, k):
    it = mix.rounds()
    return [next(it) for _ in range(k)]


def _same(a, b):
    return all(np.array_equal(x[key], y[key]) for x, y in zip(a, b)
               for key in x)


def test_same_seed_same_schedule_other_seed_other():
    a = _rounds(_mix(2 ** 31 + 3), 3)
    b = _rounds(_mix(2 ** 31 + 3), 3)
    c = _rounds(_mix(2 ** 31 + 4), 3)
    assert all(_same(x, y) for x, y in zip(a, b))
    assert not all(_same(x, y) for x, y in zip(a, c))
    # the work is the same: every seed has the same bucket edges
    assert _mix(5).edges == _mix(6).edges


def test_every_round_holds_one_full_batch_a_bucket():
    mix = _mix(7)
    for rnd in _rounds(mix, 5):
        widths = sorted(b["sentences"].shape[1] for b in rnd)
        assert widths == mix.edges
        lo = [0] + mix.edges[:-1]
        for b in rnd:
            n = b["sentences"].shape[1]
            assert b["sentences"].shape[0] == mix.B == 128
            low = lo[mix.edges.index(n)]
            assert np.all((b["lengths"] > low) & (b["lengths"] <= n))
            pad = np.arange(n)[None, :] >= b["lengths"][:, None]
            assert np.all(b["sentences"][pad] == 0)
            assert len(set(b["neg_samples"].tolist())) == mix.cfg["k_neg"]
            assert b["obj_feats"].shape == (128, 4, 8)


def test_bucket_edges_are_quantiles_of_the_drawn_lengths():
    spec = cell.traffic("train-mix")
    lengths = traffic.corpus_lengths(spec)
    assert lengths.min() >= 5 and lengths.max() <= 40
    edges = traffic.quantile_edges(lengths, 4)
    ls = np.sort(lengths)
    for q, e in zip((0.25, 0.5, 0.75), edges):
        assert e == ls[int(q * len(ls))]
    assert edges[-1] == 40
    assert _mix(1).edges == edges


def test_batches_of_a_bucket_are_distinct_rows_of_its_edge():
    mix = _mix(8)
    edge = mix.edges[-1]
    first = [mix.batch(edge) for _ in range(3)]
    assert {b["sentences"].shape[1] for b in first} == {edge}
    rows = {r.tobytes() for b in first for r in b["sentences"]}
    assert len(rows) == 3 * mix.B


def test_parse_corpus_groups_exact_lengths_in_requests_of_at_most_512():
    spec = cell.traffic("parse-corpus")
    cfg = tiny_config("diora-flickr-f32")
    mix = traffic.ParseMix(spec, cfg, 2 ** 32 + 5)
    lengths = traffic.corpus_lengths(spec)
    assert sum(r.shape[0] for r in mix.requests) == len(lengths) == 145000
    by_n = {}
    for r in mix.requests:
        assert 1 <= r.shape[0] <= 512
        by_n.setdefault(r.shape[1], []).append(r.shape[0])
    for n, sizes in by_n.items():
        assert sum(sizes) == int(np.sum(lengths == n))
        assert sum(s < 512 for s in sizes) <= 1
    it = mix.passes()
    p1, p2 = next(it), next(it)
    assert sorted(p1) == sorted(p2) == list(range(len(mix.requests)))
    assert not np.array_equal(p1, p2)
    again = traffic.ParseMix(spec, cfg, 2 ** 32 + 5)
    assert all(np.array_equal(a, b) for a, b in zip(mix.requests,
                                                     again.requests))


def _run(args, cwd, env_path):
    env = dict(os.environ, PYTHONPATH=env_path, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "-m", "benchmark.run", *args],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=300)


def test_without_a_card_the_harness_prints_no_result():
    out = _run(["--workload", "cliora-flickr-bf16.train-mix", "--seed",
                "1", "--seconds", "1", "--trace", "0"], REPO, REPO)
    assert out.returncode == 2
    assert out.stdout == ""
    assert "no CUDA device" in out.stderr


def test_only_the_benchmark_files_are_not_enough(tmp_path):
    """In a directory that holds only BENCHMARK.json and benchmark/, a run
    stops with an error and prints no result."""
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(REPO, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(["--workload", "diora-flickr-f32.parse-corpus", "--seed",
                "1", "--seconds", "1", "--trace", "0"], tmp_path,
               str(tmp_path))
    assert out.returncode != 0 and out.stdout == ""


def _digest(root):
    h = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            if "__pycache__" in dirpath:
                continue
            p = os.path.join(dirpath, f)
            h[os.path.relpath(p, root)] = hashlib.sha1(
                open(p, "rb").read()).hexdigest()
    return h


NEW_METRIC = '''"""Sentences a request, read from the run's record."""


def read(run):
    return run.sentences / run.units if run.units else None
'''

DRIVE = r'''
import json, sys, torch
from benchmark.core import cell
man = cell.manifest()
work = cell.workload(man, "tiny-diora.short-parse")
cfg = cell.config(man, work["config"])
spec = cell.traffic(work["traffic"])
limits = cell.limits(work["name"])
driver = __import__("benchmark.core." + spec["kind"], fromlist=["run"])
run, outcome, _ = driver.run(cfg, spec, 3, 0.2, False, torch.device("cpu"),
                             limits, lambda: 0.0)
names = [m["name"] for m in cell.reported(man, work["name"], True)]
print(json.dumps({"per_layer": names,
                  "value": cell.reader("sentences_per_request.parse")(run),
                  "correct": outcome.correct}))
'''


def test_a_new_cell_is_new_files_only(tmp_path):
    """A configuration, a mix, a per-layer metric and the cell's limits
    added as files, and entries added to BENCHMARK.json, make a cell the
    harness runs; no file of the benchmark changes."""
    shutil.copytree(os.path.join(REPO, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digest(tmp_path / "benchmark")
    man = cell.manifest()
    cfg = tiny_config("diora-flickr-f32")
    spec = tiny_parse_mix(lengths={"law": "fixed", "value": 6})
    b = tmp_path / "benchmark"
    (b / "configs" / "tiny-diora.json").write_text(json.dumps(cfg))
    (b / "traffic" / "short-parse.json").write_text(json.dumps(spec))
    (b / "metrics" / "sentences_per_request.parse.py").write_text(NEW_METRIC)
    (b / "limits" / "tiny-diora.short-parse.json").write_text(
        json.dumps({"limits": {"tree_gap": {"limit": 1e-3}}}))
    man["configs"].append({"name": "tiny-diora", "source": "test",
                           "file": "benchmark/configs/tiny-diora.json",
                           "reduced": [], "why": "test"})
    man["workloads"].append({"name": "tiny-diora.short-parse",
                             "config": "tiny-diora",
                             "traffic": "short-parse", "chips": 1,
                             "why": "test"})
    for m in man["end_to_end"]:
        if "workloads" in m and m["name"].startswith("parse_"):
            m["workloads"].append("tiny-diora.short-parse")
    man["per_layer"].append({"name": "sentences_per_request.parse",
                             "unit": "sentences", "better": "higher",
                             "source": "host_clock", "layer": "test",
                             "moves": "parse_sentences_per_s",
                             "workloads": ["tiny-diora.short-parse"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    after = _digest(b)
    assert all(after[k] == v for k, v in before.items())
    env = dict(os.environ, PYTHONPATH=f"{tmp_path}{os.pathsep}{REPO}")
    out = subprocess.run([sys.executable, "-c", DRIVE], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["per_layer"] == ["sentences_per_request.parse"]
    assert res["value"] > 0 and res["correct"] is True
