"""Fused inside+CKY: the port's plain version vs the JAX Pallas kernel
(interpret mode, as tests/test_pallas_chart.py runs it), the wrapper's
CPU route, and -- on a machine with a CUDA card -- the CUDA kernel vs
the plain version.

JAX is imported inside the JAX tests only, and they need JAX on the CPU
(tests/conftest.py sets it), so that this file also runs on a machine
with a card, where JAX may be missing or on the GPU:
``python -m pytest --noconftest tests/test_torch_inside_cky.py``.
"""

import numpy as np
import pytest
import torch

from cliora_tpu_torch.models.config import ModelConfig
from cliora_tpu_torch.models.params import init_diora_params, to_device
from cliora_tpu_torch.ops import inside_cky
from cliora_tpu_torch.ops.chart_pass import inside_pass
from cliora_tpu_torch.ops.core import unit_norm

D = 16


def _jax_case(B, n, seed):
    """Same weights and leaves for the JAX kernel and the port."""
    jax = pytest.importorskip("jax")
    if jax.default_backend() != "cpu":
        pytest.skip("the JAX parity tests hold the port to JAX on the CPU")
    from torch_parity import jax_diora_params, leaves

    rs = np.random.RandomState(200 + n)
    dp_j, dp_t = jax_diora_params(D, seed=seed)
    return dp_j, dp_t, leaves(dp_j, rs.randn(B, n, D).astype(np.float32))


@pytest.mark.parametrize("B,n", [(16, 3), (16, 7), (48, 5)])
def test_plain_matches_jax_pallas_kernel(B, n):
    dp_j, dp_t, h0 = _jax_case(B, n, seed=2)
    import jax.numpy as jnp

    from cliora_tpu.ops.pallas_chart import fused_inside_cky_pallas

    want_s, want_bp, want_val = fused_inside_cky_pallas(dp_j, jnp.asarray(h0))
    s, bp, val = inside_cky.fused_inside_cky_plain(dp_t, torch.from_numpy(h0))
    assert s.shape == (B, n * (n + 1) // 2, 1) and bp.dtype == torch.int32
    np.testing.assert_array_equal(bp.numpy(), np.asarray(want_bp))
    np.testing.assert_allclose(s.numpy(), np.asarray(want_s), atol=1e-4)
    np.testing.assert_allclose(val.numpy(), np.asarray(want_val), atol=1e-4)


@pytest.mark.parametrize("B,n", [(16, 5), (16, 7)])
def test_plain_matches_jax_pallas_kernel_bf16(B, n):
    """The bf16 semantics the card's bf16 kernels are held to: h1 and hk
    rounded to bf16, products of bf16 values summed in f32, l M in f32."""
    dp_j, dp_t, h0 = _jax_case(B, n, seed=3)
    import jax.numpy as jnp

    from cliora_tpu.ops.pallas_chart import fused_inside_cky_pallas

    want_s, want_bp, want_val = fused_inside_cky_pallas(
        dp_j, jnp.asarray(h0), compute_dtype="bfloat16")
    s, bp, val = inside_cky.fused_inside_cky_plain(
        dp_t, torch.from_numpy(h0), compute_dtype="bfloat16")
    np.testing.assert_array_equal(bp.numpy(), np.asarray(want_bp))
    np.testing.assert_allclose(s.numpy(), np.asarray(want_s), atol=1e-4)
    np.testing.assert_allclose(val.numpy(), np.asarray(want_val), atol=1e-4)


def _port_case(B, n, D, seed=0):
    dp = init_diora_params(torch.Generator().manual_seed(seed),
                           ModelConfig(size=D))
    gen = torch.Generator().manual_seed(seed + 1)
    return dp, unit_norm(torch.randn(B, n, D, generator=gen))


@pytest.mark.parametrize("n", [2, 6, 9])
def test_plain_matches_port_chart_pass(n):
    """The two port routes decode the same trees at f32."""
    dp, h0 = _port_case(5, n, D)
    s, bp, val = inside_cky.fused_inside_cky_plain(dp, h0)
    _, want_s, _, want_bp, want_val = inside_pass(ModelConfig(size=D), dp, h0,
                                               with_cky=True)
    torch.testing.assert_close(bp, want_bp, atol=0, rtol=0)
    torch.testing.assert_close(s, want_s, atol=1e-4, rtol=0)
    torch.testing.assert_close(val, want_val, atol=1e-4, rtol=0)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_wrapper_cpu_route_is_plain(compute_dtype):
    """On a CPU tensor the wrapper runs the plain version and launches
    nothing."""
    dp, h0 = _port_case(3, 6, D)
    before = inside_cky.launches
    got = inside_cky.fused_inside_cky(dp, h0, compute_dtype=compute_dtype)
    want = inside_cky.fused_inside_cky_plain(dp, h0,
                                             compute_dtype=compute_dtype)
    assert inside_cky.launches == before == 0
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=0, rtol=0)


def test_supports():
    assert inside_cky.supports(20, 400, 128, "float32")
    assert inside_cky.supports(20, 400, 37, "bfloat16")
    assert inside_cky.supports(2, 16, 1)
    assert not inside_cky.supports(1, 400, 128)        # no level to run
    assert not inside_cky.supports(20, 400, 128, "float16")
    assert not inside_cky.supports(20, 20000, 8)       # combine smem
    assert not inside_cky.supports(20, 402, 8)         # 4-wide tile loads
    assert inside_cky.supports(20, 404, 8, "float32")
    assert not inside_cky.supports(20, 404, 8, "bfloat16")  # TMA rows
    assert not inside_cky.supports(2, 4, 1, "bfloat16")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("B,n,D_,norm", [(5, 7, 48, "unit"),
                                         (37, 12, 400, "unit"),
                                         (2, 2, 24, "unit"),
                                         (6, 3, 16, "none")])
def test_cuda_kernel_matches_plain(cuda, B, n, D_, norm):
    """f32: backpointers identical, scores and values within 1e-4; bf16:
    backpointers agree on >= 99% of cells (bf16 chart rounding makes
    near-ties order-dependent)."""
    dp, h0 = _port_case(B, n, D_)
    dp, h0 = to_device(dp, cuda), h0.to(cuda)
    for dt in ("float32", "bfloat16"):
        before = inside_cky.launches
        s, bp, val = inside_cky.fused_inside_cky(dp, h0, norm=norm,
                                                 compute_dtype=dt)
        torch.cuda.synchronize()
        assert inside_cky.launches == before + 1
        ps, pbp, pval = inside_cky.fused_inside_cky_plain(dp, h0, norm=norm,
                                                          compute_dtype=dt)
        if dt == "float32":
            torch.testing.assert_close(bp, pbp, atol=0, rtol=0)
            torch.testing.assert_close(s, ps, atol=1e-4, rtol=0)
            torch.testing.assert_close(val, pval, atol=1e-4, rtol=0)
        else:
            assert (bp == pbp).float().mean().item() >= 0.99
            assert torch.isfinite(s).all() and torch.isfinite(val).all()
