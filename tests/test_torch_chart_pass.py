"""Port chart passes vs JAX ``run_chart`` on the same leaves, regions
and weights: the inside pass (+ fused CKY) alone, then both passes for
DIORA (shared and unshared weights, ``compress``, hard aggregation),
CLIORA and padded buckets, and their gradients."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cliora_tpu.models.config import ModelConfig as JaxConfig
from cliora_tpu.ops.chart_pass import run_chart
from cliora_tpu_torch.models.config import ModelConfig
from cliora_tpu_torch.ops.chart_pass import inside_pass
from cliora_tpu_torch.ops.chart_pass import run_chart as run_chart_t
from torch_parity import jax_diora_params, leaves

D = 16
B = 4


def _charts(n, aggregate, compute_dtype="float32", seed=0):
    rs = np.random.RandomState(100 + n)
    dp_j, dp_t = jax_diora_params(D, seed=seed)
    h0 = leaves(dp_j, rs.randn(B, n, D).astype(np.float32))
    # jitted: one compile is faster than eager dispatch of every op
    want = jax.jit(functools.partial(
        run_chart, JaxConfig(size=D, aggregate=aggregate,
                             compute_dtype=compute_dtype),
        with_cky=True, outside=False))(dp_j, jnp.asarray(h0))
    got = inside_pass(ModelConfig(size=D, aggregate=aggregate,
                                  compute_dtype=compute_dtype),
                      dp_t, torch.from_numpy(h0), with_cky=True)
    return want, got


@pytest.mark.parametrize("aggregate", ["soft", "hard"])
@pytest.mark.parametrize("n", [3, 7, 12])
def test_inside_pass_matches_jax(n, aggregate):
    want, (ih, is_, _, bp, val) = _charts(n, aggregate)
    # the tolerances of tests/test_reference_parity.py:66-74
    np.testing.assert_allclose(ih.numpy(), np.asarray(want.inside_h),
                               atol=2e-5)
    np.testing.assert_allclose(is_.numpy(), np.asarray(want.inside_s),
                               atol=2e-4)
    np.testing.assert_allclose(val.numpy(), np.asarray(want.cky_val),
                               atol=1e-4)
    assert bp.dtype == torch.int32
    np.testing.assert_array_equal(bp.numpy(), np.asarray(want.cky_bp))


def test_inside_pass_bf16_tracks_jax():
    """bf16 charts round at the same points in both packages (compose in
    bf16, ``a @ M`` stored in bf16, bf16 h chart with f32 scores); the
    CPU matmuls differ in summation order, so backpointers may differ on
    near-ties.  The JAX backends themselves disagree on ~0.5% of cells
    (cliora_tpu/ops/pallas_chart.py:44-45)."""
    want, (ih, is_, _, bp, val) = _charts(12, "soft", "bfloat16")
    assert ih.dtype == torch.bfloat16
    agree = np.mean(bp.numpy() == np.asarray(want.cky_bp))
    assert agree >= 0.95, agree
    np.testing.assert_allclose(is_.numpy(), np.asarray(want.inside_s),
                               atol=0.1)


# -- the outside pass, CLIORA region attention, padded buckets, autograd --

def _full_chart(n, B=4, obj=False, lengths=None, compute_dtype="float32",
                seed=1, **cfg_kwargs):
    """(JAX InsideOut, port InsideOut, inputs) of ``run_chart(outside=True,
    with_cky=True)`` on the same leaves, regions and weights."""
    rs = np.random.RandomState(300 + n)
    dp_j, dp_t = jax_diora_params(D, seed=seed, **cfg_kwargs)
    h0 = leaves(dp_j, rs.randn(B, n, D).astype(np.float32))
    regions = (0.5 * rs.randn(B, 3, D)).astype(np.float32) if obj else None
    kw = dict(size=D, use_obj=obj, attn_dropout=0.0,
              compute_dtype=compute_dtype, **cfg_kwargs)
    want = jax.jit(functools.partial(
        run_chart, JaxConfig(**kw), with_cky=True, outside=True))(
        dp_j, jnp.asarray(h0),
        obj=None if regions is None else jnp.asarray(regions),
        lengths=None if lengths is None else jnp.asarray(lengths, jnp.int32))
    got = run_chart_t(
        ModelConfig(**kw), dp_t, torch.from_numpy(h0),
        obj=None if regions is None else torch.from_numpy(regions),
        with_cky=True, outside=True,
        lengths=None if lengths is None else torch.as_tensor(lengths))
    return want, got


def _assert_chart_close(want, got, h_atol=2e-5, s_atol=2e-4):
    # the tolerances of tests/test_reference_parity.py:66-74
    for name, atol in (("inside_h", h_atol), ("outside_h", h_atol),
                       ("inside_s", s_atol), ("outside_s", s_atol)):
        np.testing.assert_allclose(
            getattr(got, name).float().numpy(),
            np.asarray(getattr(want, name), np.float32), atol=atol,
            err_msg=name)


@pytest.mark.parametrize("n,obj,lengths,kwargs", [
    (7, False, None, {}),
    (6, False, None, {"share": False}),
    (5, False, None, {"compress": True}),
    (6, False, None, {"aggregate": "hard"}),
    (6, True, None, {}),
    (7, False, [7, 3, 5, 2], {}),
    (7, True, [4, 7, 2, 6], {"share": False, "compress": True}),
], ids=["diora", "unshared", "compress", "hard", "cliora", "lengths",
        "cliora-lengths-unshared-compress"])
def test_run_chart_matches_jax(n, obj, lengths, kwargs):
    want, got = _full_chart(n, obj=obj, lengths=lengths, **kwargs)
    _assert_chart_close(want, got)
    np.testing.assert_array_equal(got.cky_bp.numpy(),
                                  np.asarray(want.cky_bp))


def test_run_chart_bf16_tracks_jax():
    """bf16 CLIORA charts: both packages round at the same points, the
    CPU matmuls sum in other orders; closeness as tests/test_bf16.py
    holds bf16 charts to f32 ones."""
    want, got = _full_chart(6, obj=True, compute_dtype="bfloat16")
    assert got.inside_h.dtype == got.outside_h.dtype == torch.bfloat16
    _assert_chart_close(want, got, h_atol=0.05, s_atol=0.1)


def test_chart_autograd_matches_jax():
    """Gradients of a random linear read-out of both charts w.r.t. the
    leaves, the regions and every chart weight, port autograd vs JAX
    autodiff (the level outputs are built new and concatenated, so no
    tensor autograd saved is written in place)."""
    n, B = 5, 3
    rs = np.random.RandomState(7)
    dp_j, dp_t = jax_diora_params(D, seed=2, share=False)
    h0 = leaves(dp_j, rs.randn(B, n, D).astype(np.float32))
    regions = (0.5 * rs.randn(B, 3, D)).astype(np.float32)
    nc = n * (n + 1) // 2
    wh = rs.randn(2, B, nc, D).astype(np.float32)
    ws = rs.randn(2, B, nc, 1).astype(np.float32)
    lengths = np.array([5, 3, 4], np.int32)
    kw = dict(size=D, use_obj=True, attn_dropout=0.0, share=False)

    def jloss(dp, h0, obj):
        out = run_chart(JaxConfig(**kw), dp, h0, obj=obj, outside=True,
                        lengths=jnp.asarray(lengths))
        return (jnp.sum(out.inside_h * wh[0]) + jnp.sum(out.outside_h * wh[1])
                + jnp.sum(out.inside_s * ws[0])
                + jnp.sum(out.outside_s * ws[1]))

    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(
        dp_j, jnp.asarray(h0), jnp.asarray(regions))
    leaves_t = [t.requires_grad_() for t in _tensors(dp_t)]
    th0 = torch.from_numpy(h0).requires_grad_()
    tobj = torch.from_numpy(regions).requires_grad_()
    out = run_chart_t(ModelConfig(**kw), dp_t, th0, obj=tobj, outside=True,
                      lengths=torch.as_tensor(lengths))
    (torch.sum(out.inside_h * torch.from_numpy(wh[0]))
     + torch.sum(out.outside_h * torch.from_numpy(wh[1]))
     + torch.sum(out.inside_s * torch.from_numpy(ws[0]))
     + torch.sum(out.outside_s * torch.from_numpy(ws[1]))).backward()
    np.testing.assert_allclose(th0.grad.numpy(), np.asarray(want[1]),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tobj.grad.numpy(), np.asarray(want[2]),
                               rtol=1e-4, atol=1e-4)
    from cliora_tpu.training.checkpoint import flatten

    want_dp = flatten(want[0])
    # leaf_fc runs outside run_chart: no gradient (JAX: zeros)
    got_dp = {k: torch.zeros_like(v) if v.grad is None else v.grad
              for k, v in _named(dp_t)}
    assert set(got_dp) == set(want_dp)
    for k, g in got_dp.items():
        scale = max(1.0, float(np.abs(want_dp[k]).max()))
        np.testing.assert_allclose(g.numpy(), want_dp[k], rtol=1e-4,
                                   atol=1e-4 * scale, err_msg=k)
    assert len(leaves_t) == len(got_dp)


def _named(tree, prefix=()):
    if isinstance(tree, dict):
        return [kv for k, v in tree.items() for kv in _named(v, prefix + (k,))]
    return [("/".join(prefix), tree)]


def _tensors(tree):
    return [v for _, v in _named(tree)]
