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
