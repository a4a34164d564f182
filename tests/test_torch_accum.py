"""Gradient accumulation (``TrainConfig.accum_steps``): the port's
``accum_steps=2`` step against the JAX package's, with and without
``lengths``; against its own per-microbatch gradients averaged under one
update; and ``steps`` composed with it -- the contract of
tests/test_training.py:269-400."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from cliora_tpu.models.config import ModelConfig as JaxConfig
from cliora_tpu.training import trainer as jt
from cliora_tpu.training.checkpoint import flatten
from cliora_tpu_torch.models.config import ModelConfig
from cliora_tpu_torch.training import trainer as tt
from cliora_tpu_torch.training.checkpoint import flatten as tflatten
from cliora_tpu_torch.training.checkpoint import params_from_numpy
from torch_parity import adam_moved, jax_tree, port_init

D, E, V, R, F, K = 16, 24, 50, 3, 16, 5
B, L = 8, 6
LR = 1e-3
LENGTHS = np.array([5, 6, 4, 6, 6, 3, 5, 2], np.int32)


def _configs(use_obj, accum_steps=2):
    model = dict(size=D, input_size=E)
    train = dict(lr=LR, k_neg=K, emb_trainable=True, accum_steps=accum_steps)
    if use_obj:
        model.update(use_obj=True, n_regions=R, obj_feat_size=F,
                     attn_dropout=0.0)
        train.update(vg_loss=True, use_contr=True)
    return (JaxConfig(**model), jt.TrainConfig(attn_impl="einsum", **train),
            ModelConfig(**model), tt.TrainConfig(attn_impl="cuda", **train))


def _batch(use_obj, lengths, seed=0):
    rs = np.random.RandomState(seed)
    toks = rs.randint(2, V, (B, L))
    batch = {"sentences": toks, "neg_samples": rs.choice(V, K, replace=False)}
    if use_obj:
        batch["obj_feats"] = rs.randn(B, R, F).astype(np.float32)
    if lengths:
        for r, m in enumerate(LENGTHS):
            toks[r, m:] = 0
        batch["lengths"] = LENGTHS
    return batch


def _port(cfg, tc, flat):
    return tt.Trainer(cfg, tc, params_from_numpy(flat, "cpu"), device="cpu")


@pytest.mark.parametrize("use_obj,lengths", [(True, False), (False, True)],
                         ids=["cliora", "diora-lengths"])
def test_accum_step_matches_jax(use_obj, lengths):
    """Metrics at rtol 1e-4; parameters after the clipped Adam update at
    atol 1e-3 * lr on the entries whose averaged gradient exceeds 1e-6 --
    the one-step check's tolerances (tests/test_torch_train_step.py)."""
    jcfg, jtc, cfg, tc = _configs(use_obj)
    params = port_init(cfg, tc, V, seed=2)
    batch = _batch(use_obj, lengths)
    ttr = _port(cfg, tc, params)
    got = ttr.step(batch)
    jtr = jt.Trainer(jcfg, jtc, jax_tree(params))
    want = jtr.step(batch, rng=jax.random.PRNGKey(0))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-4,
                                   err_msg=k)
    moved = adam_moved(jtr, 1)
    want_p = flatten(jtr.params)
    for k, v in tflatten(ttr.params).items():
        np.testing.assert_allclose(v[moved[k]], want_p[k][moved[k]],
                                   atol=1e-3 * LR, err_msg=f"param {k}")


@pytest.mark.parametrize("lengths", [False, True], ids=["full", "lengths"])
def test_accum_equals_averaged_microbatch_grads(lengths):
    """``accum_steps=2`` equals the two microbatches' gradients from one
    set of weights, averaged, then one clip and Adam update; its metrics
    are the microbatches' mean (rtol 1e-6, params atol 1e-7, as
    tests/test_training.py:269-317 holds the JAX package)."""
    _, _, cfg, tc = _configs(True)
    params = port_init(cfg, tc, V, seed=3)
    batch = _batch(True, lengths, seed=1)
    ttr = _port(cfg, tc, params)
    got = ttr.step(batch)

    ref = _port(cfg, dataclasses.replace(tc, accum_steps=1), params)
    tokens, neg, obj, lens = ref._place_batch(batch)
    trainable = [p for _, p in ref._trainable()]
    grads, totals = [], []
    for sl in (slice(0, B // 2), slice(B // 2, B)):
        total, _ = tt.compute_losses(
            cfg, tc, ref.params, tokens[sl], neg, obj_feats=obj[sl],
            train=True, lengths=None if lens is None else lens[sl])
        grads.append([torch.zeros_like(p) if g is None else g
                      for p, g in zip(trainable, torch.autograd.grad(
                          total, trainable, allow_unused=True))])
        totals.append(total.item())
    avg = [(a + b) / 2 for a, b in zip(*grads)]
    clipped, _ = tt.clip_by_global_norm(avg, tc.grad_clip)
    for p, g in zip(trainable, clipped):
        p.grad = g
    ref.optimizer.step()

    np.testing.assert_allclose(got["total_loss"].item(), np.mean(totals),
                               rtol=1e-6)
    want = tflatten(ref.params)
    for k, v in tflatten(ttr.params).items():
        np.testing.assert_allclose(v, want[k], atol=1e-7, err_msg=k)


def test_steps_with_accum():
    """``steps`` composes with ``accum_steps``: two steps of two
    microbatches each, dropout on, leave the state of two ``step`` calls
    (metrics rtol 1e-5, parameters atol 1e-6; tests/test_training.py:
    378-400)."""
    _, _, cfg, tc = _configs(True)
    cfg = dataclasses.replace(cfg, attn_dropout=0.1)
    params = port_init(cfg, tc, V, seed=4)
    batches = [_batch(True, True, seed=s) for s in (5, 6)]
    seq_tr, grp_tr = _port(cfg, tc, params), _port(cfg, tc, params)
    seq = [seq_tr.step(b) for b in batches]
    grouped = grp_tr.steps(batches)
    for a, b in zip(seq, grouped):
        for k in a:
            np.testing.assert_allclose(a[k].item(), b[k].item(), rtol=1e-5,
                                       err_msg=k)
    want = tflatten(seq_tr.params)
    for k, v in tflatten(grp_tr.params).items():
        np.testing.assert_allclose(v, want[k], atol=1e-6, err_msg=k)


def test_accum_refusals():
    """A batch that microbatches do not divide raises, as the JAX package
    asserts; ``accum_steps`` below 1 is refused."""
    _, _, cfg, tc = _configs(False, accum_steps=3)
    ttr = _port(cfg, tc, port_init(cfg, tc, V, seed=0))
    before = tflatten(ttr.params)
    with pytest.raises(ValueError, match="accum_steps 3"):
        ttr.step(_batch(False, False))
    assert ttr._host_step == 0
    for k, v in tflatten(ttr.params).items():
        np.testing.assert_array_equal(v, before[k])
    with pytest.raises(ValueError, match="accum_steps"):
        tt.TrainConfig(accum_steps=0)
