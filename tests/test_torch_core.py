"""Port ops/core.py vs the JAX package's, on the same inputs and weights."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cliora_tpu.ops import core as jcore
from cliora_tpu_torch.ops import core as tcore
from torch_parity import jax_diora_params

D = 16
ATOL = 1e-5


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, dtype=np.float32)


@pytest.fixture
def data():
    rs = np.random.RandomState(11)
    dp_j, dp_t = jax_diora_params(D, seed=4)
    return {
        "dp_j": dp_j, "dp_t": dp_t,
        "a": rs.randn(3, 5, D).astype(np.float32),
        "b": rs.randn(3, 5, D).astype(np.float32),
    }


def _pair(name, d):
    """(JAX result, port result) of one ops/core.py function."""
    a, b = d["a"], d["b"]
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    cj, ct = d["dp_j"]["inside_compose"], d["dp_t"]["inside_compose"]
    mj, mt = d["dp_j"]["inside_score"]["mat"], d["dp_t"]["inside_score"]["mat"]
    if name == "unit_norm":
        return jcore.unit_norm(a), tcore.unit_norm(ta)
    if name == "unit_norm_tiny":
        z = np.zeros_like(a)
        return jcore.unit_norm(z), tcore.unit_norm(torch.from_numpy(z))
    if name == "normalize_none":
        return jcore.normalize("none", a), tcore.normalize("none", ta)
    if name == "normalize_unit":
        return jcore.normalize("unit", a), tcore.normalize("unit", ta)
    if name == "linear":
        return jcore.linear(cj["fc1"], a), tcore.linear(ct["fc1"], ta)
    if name == "leaf_mlp":
        return jcore.leaf_mlp(cj, a), tcore.leaf_mlp(ct, ta)
    if name == "compose_mlp":
        return jcore.compose_mlp(cj, a, b), tcore.compose_mlp(ct, ta, tb)
    if name == "bilinear":
        return jcore.bilinear(mj, a, b), tcore.bilinear(mt, ta, tb)
    raise KeyError(name)


@pytest.mark.parametrize("name", [
    "unit_norm", "unit_norm_tiny", "normalize_none", "normalize_unit",
    "linear", "leaf_mlp", "compose_mlp", "bilinear"])
def test_core_f32_matches_jax(name, data):
    want, got = _pair(name, data)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL)


def test_unit_norm_bf16_keeps_dtype_and_matches_jax(data):
    """Low precision: f32 sum of squares, scale rounded once, result in
    bf16 (ops/core.py:19-32).  Compared at one bf16 ulp of a unit
    vector's entries."""
    a = data["a"]
    want = jcore.unit_norm(jnp.asarray(a, jnp.bfloat16))
    got = tcore.unit_norm(torch.from_numpy(a).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want.astype(jnp.float32)),
                               atol=2 ** -8)


def test_bilinear_bf16_matches_jax(data):
    """``a @ M`` stored in bf16 before the f32-accumulated dot with b."""
    a, b = data["a"], data["b"]
    want = jcore.bilinear(data["dp_j"]["inside_score"]["mat"], a, b,
                          compute_dtype=jnp.bfloat16)
    got = tcore.bilinear(data["dp_t"]["inside_score"]["mat"],
                         torch.from_numpy(a), torch.from_numpy(b),
                         compute_dtype=torch.bfloat16)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-2, atol=1e-2)


def test_region_attention_matches_jax(data):
    """f32 context and its gradients, per-example diagonal, temperature."""
    import jax

    rs = np.random.RandomState(3)
    h = data["a"]
    obj = rs.randn(3, 4, D).astype(np.float32)

    def jf(h, obj):
        return jcore.region_attention(h, obj, temp=0.7)

    want = jf(h, obj)
    th = torch.from_numpy(h).requires_grad_()
    tobj = torch.from_numpy(obj).requires_grad_()
    got = tcore.region_attention(th, tobj, temp=0.7)
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL)
    w = rs.randn(*h.shape).astype(np.float32)
    gh, gobj = jax.grad(lambda a, b: jnp.sum(jf(a, b) * w),
                        argnums=(0, 1))(h, obj)
    torch.sum(got * torch.from_numpy(w)).backward()
    np.testing.assert_allclose(_np(th.grad), _np(gh), atol=ATOL)
    np.testing.assert_allclose(_np(tobj.grad), _np(gobj), atol=ATOL)


def test_region_attention_dropout_uses_the_generator():
    """Train-mode dropout draws from the caller's generator: the same seed
    gives the same context, kept probabilities are scaled by 1/(1-p), and
    eval mode or p=0 leave the context deterministic."""
    rs = np.random.RandomState(4)
    h = torch.from_numpy(rs.randn(2, 5, D).astype(np.float32))
    obj = torch.from_numpy(rs.randn(2, 6, D).astype(np.float32))

    def run(seed, **kw):
        return tcore.region_attention(
            h, obj, dropout=0.5,
            generator=torch.Generator().manual_seed(seed), **kw)

    assert torch.equal(run(0, train=True), run(0, train=True))
    assert not torch.equal(run(0, train=True), run(1, train=True))
    full = tcore.region_attention(h, obj)
    assert torch.equal(run(0, train=False), full)
    # the expectation over masks is the undropped context
    mean = torch.stack([run(s, train=True) for s in range(1000)]).mean(0)
    assert (mean - full).norm() / full.norm() < 0.1
    with pytest.raises(ValueError, match="Generator"):
        tcore.region_attention(h, obj, dropout=0.5, train=True)


@pytest.mark.parametrize("pattern,xs,ys", [
    ("blnd,bln->bld", (2, 3, 4, D), (2, 3, 4)),
    ("bld,brd->blr", (2, 3, D), (2, 5, D)),
    ("...md,...md->...m", (2, 3, D), (2, 3, D)),
])
def test_lowp_einsum_bf16_matches_jax(pattern, xs, ys):
    """bf16 operands, f32 accumulation, each cotangent in its operand's
    dtype (a bf16 x and an f32 y), against JAX's ``lowp_einsum``."""
    import jax

    rs = np.random.RandomState(5)
    x = rs.randn(*xs).astype(np.float32)
    y = rs.randn(*ys).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = jcore.lowp_einsum(pattern, xb, y, jnp.bfloat16, jnp.float32)
    g = rs.randn(*want.shape).astype(np.float32)
    gx, gy = jax.grad(lambda a, b: jnp.sum(jcore.lowp_einsum(
        pattern, a, b, jnp.bfloat16, jnp.float32) * g), argnums=(0, 1))(xb, y)
    tx = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    ty = torch.from_numpy(y).requires_grad_()
    got = tcore.lowp_einsum(pattern, tx, ty, torch.bfloat16, torch.float32)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)
    torch.sum(got * torch.from_numpy(g)).backward()
    assert tx.grad.dtype == torch.bfloat16 and ty.grad.dtype == torch.float32
    # dx is rounded to bf16 once: one bf16 ulp of its magnitude
    np.testing.assert_allclose(_np(tx.grad), _np(gx.astype(jnp.float32)),
                               rtol=2 ** -7, atol=1e-2)
    np.testing.assert_allclose(_np(ty.grad), _np(gy), rtol=1e-5, atol=1e-5)
