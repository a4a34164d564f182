"""Port training/losses.py vs the JAX package's on the same inputs, with
and without padded-bucket ``lengths``."""

import numpy as np
import pytest
import torch

from cliora_tpu.training import losses as jl
from cliora_tpu_torch.training import losses as tl

B, n, D, E, V, K, R = 4, 6, 12, 10, 30, 7, 5
NC = n * (n + 1) // 2
RTOL = 1e-5
LENGTHS = np.array([6, 3, 5, 2], np.int32)


@pytest.fixture
def data():
    rs = np.random.RandomState(21)
    return {
        "recon": {"mat": rs.randn(D, E).astype(np.float32)},
        "table": rs.randn(V, E).astype(np.float32),
        "tokens": rs.randint(0, V, (B, n)),
        "neg": rs.choice(V, K, replace=False),
        "outside_h": rs.randn(B, NC, D).astype(np.float32),
        "vg": rs.randn(B, B, n, R).astype(np.float32),
        "ins": (0.3 * rs.randn(B, NC, 1)).astype(np.float32),
        "outs": (0.3 * rs.randn(B, NC, 1)).astype(np.float32),
        "all": rs.randn(B, B, NC, R).astype(np.float32),
    }


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _lens(padded):
    return (LENGTHS, _t(LENGTHS)) if padded else (None, None)


@pytest.mark.parametrize("padded", [False, True])
def test_reconstruction_loss_matches_jax(data, padded):
    jlen, tlen = _lens(padded)
    want = jl.reconstruction_loss(data["recon"], data["table"],
                                  data["tokens"], data["neg"],
                                  data["outside_h"], lengths=jlen)
    got = tl.reconstruction_loss(
        {"mat": _t(data["recon"]["mat"])}, _t(data["table"]),
        _t(data["tokens"]), _t(data["neg"]), _t(data["outside_h"]),
        lengths=tlen)
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL)


@pytest.mark.parametrize("padded", [False, True])
def test_vg_losses_match_jax(data, padded):
    jlen, tlen = _lens(padded)
    want = jl.vg_loss(data["vg"], alpha_vg=0.7, lengths=jlen)
    got = tl.vg_loss(_t(data["vg"]), alpha_vg=0.7, lengths=tlen)
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL)
    prm = data["vg"].max(-1)
    want = jl.vg_loss_from_scores(prm, alpha_vg=0.7, lengths=jlen)
    got = tl.vg_loss_from_scores(_t(prm), alpha_vg=0.7, lengths=tlen)
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL)


@pytest.mark.parametrize("padded", [False, True])
def test_contrastive_losses_match_jax(data, padded):
    jlen, tlen = _lens(padded)
    want = jl.contrastive_loss(data["ins"], data["outs"], data["all"],
                               margin=0.3, alpha_contr=1.5, lengths=jlen)
    got = tl.contrastive_loss(_t(data["ins"]), _t(data["outs"]),
                              _t(data["all"]), margin=0.3, alpha_contr=1.5,
                              lengths=tlen)
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL)
    scores = data["all"].max(-1)
    want = jl.contrastive_loss_from_scores(
        data["ins"], data["outs"], scores, margin=0.3, alpha_contr=1.5,
        lengths=jlen)
    got = tl.contrastive_loss_from_scores(
        _t(data["ins"]), _t(data["outs"]), _t(scores), margin=0.3,
        alpha_contr=1.5, lengths=tlen)
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL)


def test_contrastive_hinge_clamps_before_zeroing_the_diagonal(data):
    """A margin of -1e3 drives every hinge below zero: each off-diagonal
    term clamps at MIN_VAL and the diagonal is zeroed after the clamp."""
    ins = np.zeros((B, NC, 1), np.float32)
    got = tl.contrastive_loss(_t(ins), _t(ins), _t(data["all"]),
                              margin=-1e3)
    want = jl.contrastive_loss(ins, ins, data["all"], margin=-1e3)
    # per cell: 2 directions x (B-1)/B clamped terms of MIN_VAL
    expect = (NC // 2) * 2 * (B - 1) / B * tl.MIN_VAL
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL)
    np.testing.assert_allclose(got.item(), expect, rtol=1e-6)


@pytest.mark.parametrize("fn", ["valid_cell_mask", "contrastive_cell_mask",
                                "root_cell_index"])
def test_masks_match_jax(fn):
    want = getattr(jl, fn)(n, LENGTHS)
    got = getattr(tl, fn)(n, _t(LENGTHS))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(tl.word_mask(_t(LENGTHS), n).numpy(),
                                  np.asarray(jl.word_mask(LENGTHS, n)))


def test_loss_grads_match_jax(data):
    """Gradients of the padded contrastive + VG losses w.r.t. their score
    inputs, port autograd vs JAX autodiff."""
    import jax

    def jloss(ins, outs, all_, vg):
        return (jl.contrastive_loss(ins, outs, all_, lengths=LENGTHS)
                + jl.vg_loss(vg, lengths=LENGTHS))

    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        data["ins"], data["outs"], data["all"], data["vg"])
    xs = [_t(data[k]).requires_grad_() for k in ("ins", "outs", "all", "vg")]
    (tl.contrastive_loss(*xs[:3], lengths=_t(LENGTHS))
     + tl.vg_loss(xs[3], lengths=_t(LENGTHS))).backward()
    for x, w in zip(xs, want):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(w),
                                   rtol=1e-4, atol=1e-6)
