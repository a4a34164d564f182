"""The plain reference against the program, at small widths on the CPU,
and its independence from the program and from the JAX package."""

from __future__ import annotations

import ast
import os

import numpy as np
import pytest
import torch

from benchmark.core import parse, train
from benchmark.core.cell import Outcome
from benchmark.core.spans import Spans
from benchmark.reference import cky
from benchmark.tests.conftest import (
    tiny_config,
    tiny_parse_mix,
    tiny_train_mix,
)

CPU = torch.device("cpu")
REFERENCE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "reference")
FORBIDDEN = {"jax", "jaxlib", "flax", "cliora_tpu", "cliora_tpu_torch"}


def readings(cfg, spec, seed, fault=None):
    params0, mix, trainer = train.build(cfg, spec, seed, CPU, fault)
    got = train.setup_steps(trainer, mix, CPU, spec)
    want = train.reference_readings(cfg, params0, got, CPU)
    return train.judge(cfg, got, want, {}, Outcome()), got, want


@pytest.mark.parametrize("config", ["cliora-flickr-bf16", "diora-flickr-f32"])
@pytest.mark.parametrize("seed", [3, 2 ** 31 + 17])
def test_reference_follows_the_program_in_f32(config, seed):
    """Losses of each step, the clipped gradients read and the parameters
    after the set-up's steps, with dropout on, in f32 on both sides."""
    cfg = tiny_config(config, compute_dtype="float32")
    got_r, got, want = readings(cfg, tiny_train_mix(), seed)
    for name, value in got_r.items():
        assert value < 1e-5, (name, value)
    assert len(got.losses) == len(want["losses"]) == len(got.batches)
    for g, w in zip(got.losses, want["losses"]):
        for k in w:
            assert abs(g[k] - w[k]) <= 1e-5 * max(1.0, abs(w[k])), k
    assert set(got.grads) == set(want["grads"]) and 0 in got.grads
    for step, grads in want["grads"].items():
        scale = max(float(v.abs().max()) for v in grads.values())
        for k, v in grads.items():
            torch.testing.assert_close(got.grads[step][k], v, rtol=1e-4,
                                       atol=1e-5 * scale)
    # Adam moves a leaf whose gradient is nought to rounding (the VG
    # encoder's bias, under softmax) by round-off alone: the other leaves'
    # entries are held to a tenth of one step's largest move
    norms = {k: float(v.norm()) for k, v in want["grads"][0].items()}
    median = sorted(norms.values())[len(norms) // 2]
    for k, v in want["params"].items():
        if norms[k] < train.ROUND_OFF_GRAD * median:
            continue
        torch.testing.assert_close(got.params[k], v, rtol=0,
                                   atol=0.1 * cfg["lr"])


def test_set_up_reads_each_bucket_after_its_capture():
    """Every bucket of the mix takes set-up steps, longest first, and the
    gradient of each bucket's last step is read, with the first step's."""
    cfg = tiny_config("cliora-flickr-bf16", compute_dtype="float32")
    spec = tiny_train_mix()
    _, mix, trainer = train.build(cfg, spec, 9, CPU)
    got = train.setup_steps(trainer, mix, CPU, spec)
    edges = [got.batches[k]["sentences"].shape[1] for k in
             range(len(got.batches))]
    assert sorted(set(got.buckets)) == list(range(len(mix.edges)))
    assert edges == sorted(edges, reverse=True)
    last = {b: k for k, b in enumerate(got.buckets)}
    assert set(got.grads) == {0} | set(last.values())
    rows = {r.tobytes() for b in got.batches for r in b["sentences"]}
    assert len(rows) == len(got.batches) * mix.B


def test_reference_steps_move_every_trainable_leaf():
    cfg = tiny_config("cliora-flickr-bf16", compute_dtype="float32")
    _, _, want = readings(cfg, tiny_train_mix(), 5)
    moved = [k for k in want["params"]
             if not torch.equal(want["params"][k], want["params0"][k])]
    assert set(moved) >= set(want["params"]) - {"img_encoder/fc_vis/b"}
    assert "embed/embeddings" not in want["params"]    # frozen, as the
    #                                                    fine-tune has it


@pytest.mark.parametrize("seed", [4, 2 ** 33 + 1])
def test_parse_trees_score_as_the_reference_best(seed):
    """The trees the program serves (CPU: the plain chart pass) and the
    trees of K1's plain version cost what the reference's best trees
    cost."""
    from cliora_tpu_torch.analysis.eval import eval_batch_trees
    from cliora_tpu_torch.models.diora import embed_span, leaf_transform
    from cliora_tpu_torch.ops.inside_cky import fused_inside_cky_plain

    cfg = tiny_config("diora-flickr-f32")
    spec = tiny_parse_mix()
    params0, mix, trainer = parse.build(cfg, spec, seed, CPU)
    for i in parse.sample(mix, seed):
        tokens = mix.requests[i]
        served, route = parse.serve(trainer, tokens, Spans())
        tok = torch.as_tensor(tokens)
        gaps = cky.tree_gaps(cfg, params0, tok, served)
        assert np.all(np.abs(gaps) < 1e-4), gaps
        dp = trainer.params["diora"]
        h0, _ = leaf_transform(trainer.cfg, dp,
                               embed_span(trainer.params["embed"], tok))
        _, bp, _ = fused_inside_cky_plain(dp, h0)
        k1 = [t for t, _ in eval_batch_trees(bp.numpy(), tokens.shape[1])]
        assert np.all(np.abs(cky.tree_gaps(cfg, params0, tok, k1)) < 1e-4)
        best = cky.best_trees(cfg, params0, tok)
        assert np.all(cky.tree_gaps(cfg, params0, tok, best) == 0.0)


def test_tree_judge_refuses_what_is_not_a_tree():
    cfg = tiny_config("diora-flickr-f32")
    params0, mix, _ = parse.build(cfg, tiny_parse_mix(), 1, CPU)
    tok = torch.as_tensor(mix.requests[-1][:3])
    n = tok.shape[1]
    right = n - 1
    for leaf in range(n - 2, -1, -1):
        right = (leaf, right)
    bad = [((0, 2), 1), right, (0,)]
    gaps = cky.tree_gaps(cfg, params0, tok, bad)
    assert np.isinf(gaps[0]) and np.isinf(gaps[2]) and np.isfinite(gaps[1])


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_reference_imports_neither_the_program_nor_jax():
    files = [os.path.join(REFERENCE, f) for f in os.listdir(REFERENCE)
             if f.endswith(".py")]
    assert files
    for path in files:
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)


def test_card_trees_of_k1_score_as_the_reference_best(card):
    """On the card the parse takes K1; its trees are held to the
    reference's split costs at f32 rounding."""
    cfg = tiny_config("diora-flickr-f32", size=64, input_size=64)
    spec = tiny_parse_mix(corpus=2000, max_batch=64,
                          lengths={"law": "fixed", "value": 12})
    params0, mix, trainer = parse.build(cfg, spec, 7, card)
    tokens = mix.requests[0]
    trees, route = parse.serve(trainer, tokens, Spans())
    assert route == "cuda"
    gaps = cky.tree_gaps(cfg, train.host_tree(params0),
                         torch.as_tensor(tokens), trees)
    assert np.all(gaps < 1e-3), gaps.max()
