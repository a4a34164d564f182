"""Port inside pass (+ fused CKY) vs JAX ``run_chart(outside=False,
with_cky=True)`` on the same leaves and weights."""

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
    want, (ih, is_, bp, val) = _charts(n, aggregate)
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
    want, (ih, is_, bp, val) = _charts(12, "soft", "bfloat16")
    assert ih.dtype == torch.bfloat16
    agree = np.mean(bp.numpy() == np.asarray(want.cky_bp))
    assert agree >= 0.95, agree
    np.testing.assert_allclose(is_.numpy(), np.asarray(want.inside_s),
                               atol=0.1)
