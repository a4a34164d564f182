"""Span x region max: the port's plain versions and ``span_region_max``
under every impl vs the JAX package's (``einsum``, ``chunked``, and the
Pallas kernels in interpret mode, as tests/test_span_region.py runs
them), the custom gradient vs JAX autodiff, the wrappers' CPU route, and
-- on a machine with a CUDA card -- kernels K2-K4 vs their plain
versions.

JAX is imported inside the JAX tests only, so this file also runs on a
machine with a card and no JAX:
``python -m pytest --noconftest tests/test_torch_span_region.py``.
"""

import numpy as np
import pytest
import torch

from cliora_tpu_torch.ops import span_region as sr
from cliora_tpu_torch.utils import observability as obs

A, C, M, R, D = 3, 5, 17, 7, 24
ATOL = 1e-5


KERNELS = ("span_region_fwd", "span_region_dspan", "span_region_dobj")


def _calls():
    """Each wrapper's calls that launched its kernel, from the tracing
    registry."""
    counts = obs.counters()
    return {k: counts.get(k + ".calls", 0) for k in KERNELS}


def _data(seed=11):
    rs = np.random.RandomState(seed)
    return (rs.randn(A, M, D).astype(np.float32),
            rs.randn(C, R, D).astype(np.float32),
            rs.randn(A, C, M).astype(np.float32))


def _jax():
    jax = pytest.importorskip("jax")
    if jax.default_backend() != "cpu":
        pytest.skip("the JAX parity tests hold the port to JAX on the CPU")
    import cliora_tpu.ops.span_region as jsr
    return jax, jsr


@pytest.mark.parametrize("impl,jax_impl", [
    ("einsum", "einsum"), ("chunked", "chunked"), ("cuda", "pallas")])
def test_forward_matches_jax(impl, jax_impl):
    jax, jsr = _jax()
    span, obj, _ = _data()
    want_mx, want_am = jsr._IMPLS[jax_impl](span, obj)
    got = sr.span_region_max(torch.from_numpy(span), torch.from_numpy(obj),
                             impl)
    assert got.dtype == torch.float32 and got.shape == (A, C, M)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_mx), atol=ATOL)
    mx, am = sr.span_region_fwd_plain(torch.from_numpy(span),
                                      torch.from_numpy(obj))
    assert am.dtype == torch.int32
    np.testing.assert_array_equal(am.numpy(), np.asarray(want_am))
    np.testing.assert_allclose(mx.numpy(), np.asarray(want_mx), atol=ATOL)


@pytest.mark.parametrize("impl", sr.IMPLS)
def test_grads_match_jax_autodiff(impl):
    """The argmax-routed gradient equals autodiff of max(einsum) off ties
    (random inputs have none)."""
    jax, _ = _jax()
    import jax.numpy as jnp

    span, obj, _ = _data(seed=3)

    def ref_loss(s, o):
        return jnp.sum(jnp.tanh(jnp.max(jnp.einsum("amd,crd->acmr", s, o),
                                        -1)))

    want = jax.grad(ref_loss, argnums=(0, 1))(span, obj)
    ts = torch.from_numpy(span).requires_grad_()
    to = torch.from_numpy(obj).requires_grad_()
    torch.sum(torch.tanh(sr.span_region_max(ts, to, impl))).backward()
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(want[0]),
                               atol=ATOL)
    np.testing.assert_allclose(to.grad.numpy(), np.asarray(want[1]),
                               atol=ATOL)


def test_plain_backward_matches_jax_pallas_backward():
    """K3 and K4's plain versions vs the JAX Pallas backward kernels on
    the same ``g`` and argmax, at f32 (where the Pallas kernels' bf16
    rounding of the weighted one-hot is absent)."""
    _, jsr = _jax()
    span, obj, g = _data(seed=5)
    _, am = jsr._max_and_argmax_einsum(span, obj)
    want_dspan, want_dobj = jsr._bwd_pallas(span, obj, am, g)
    tam = torch.from_numpy(np.array(am))
    dspan = sr.span_region_dspan_plain(torch.from_numpy(obj), tam,
                                       torch.from_numpy(g), torch.float32)
    dobj = sr.span_region_dobj_plain(torch.from_numpy(span), tam,
                                      torch.from_numpy(g), R, torch.float32)
    np.testing.assert_allclose(dspan.numpy(), np.asarray(want_dspan),
                               atol=ATOL)
    np.testing.assert_allclose(dobj.numpy(), np.asarray(want_dobj),
                               atol=ATOL)


def test_bf16_span_keeps_dtypes():
    """bf16 span: the forward contracts bf16 operands into f32 scores,
    ``dspan`` comes back bf16 and ``dobj`` in obj's f32."""
    span, obj, _ = _data()
    ts = torch.from_numpy(span).to(torch.bfloat16).requires_grad_()
    to = torch.from_numpy(obj).requires_grad_()
    out = sr.span_region_max(ts, to, "chunked")
    want, _ = sr.span_region_fwd_plain(
        ts.detach().float(), to.detach().to(torch.bfloat16).float())
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, want, atol=ATOL, rtol=0)
    out.sum().backward()
    assert ts.grad.dtype == torch.bfloat16 and to.grad.dtype == torch.float32


def test_wrappers_cpu_route_is_plain():
    """On CPU tensors the wrappers run the plain versions and launch
    nothing."""
    span, obj, g = (torch.from_numpy(x) for x in _data())
    before = _calls()
    mx, am = sr.span_region_fwd(span, obj)
    pmx, pam = sr.span_region_fwd_plain(span, obj)
    assert torch.equal(mx, pmx) and torch.equal(am, pam)
    assert torch.equal(sr.span_region_dspan(obj, am, g, torch.float32),
                       sr.span_region_dspan_plain(obj, am, g, torch.float32))
    assert torch.equal(sr.span_region_dobj(span, am, g, R, torch.float32),
                       sr.span_region_dobj_plain(span, am, g, R,
                                                 torch.float32))
    sr.span_region_max(span.requires_grad_(), obj, "cuda").sum().backward()
    assert _calls() == before == {k: 0 for k in KERNELS}


def test_supports_and_segments():
    assert sr.supports(400, 36) and sr.supports(24, 7)
    assert not sr.supports(402, 36)          # 16-byte bf16 rows (TMA)
    assert not sr.supports(400, 145)         # wider than a column tile
    assert not sr.supports(1032, 36)         # wider than the card tests
    # K4 keeps no shared accumulator on bf16 spans, and its f32 kernel
    # takes 2 images a block where 4 do not fit: every R up to 144
    assert sr.supports(400, 113) and sr.supports(400, 114)
    assert sr.supports(400, 144)
    assert sr._dobj_group(113) == 4 and sr._dobj_group(114) == 2
    # bf16: 36 x 2 tiles of (128 region rows, 200 columns), 792 / 72
    # segments of whole 64-row k tiles; f32, R = 36: 32 image groups x 2 D
    # slices of the register kernel, round(132 / 64) segments at both calls
    assert sr.dobj_segments(128 * 210, 128, 36, 400, True) == 11
    assert sr.dobj_segments(128 * 210, 128, 36, 400, False) == 2
    assert sr.dobj_segments(128 * 20, 128, 36, 400, False) == 2
    # other R keep the shared-memory scatter's rule
    assert sr.dobj_segments(128 * 210, 128, 37, 400, False) == 9
    assert sr.dobj_segments(128 * 20, 128, 36, 400, True) == 10
    assert sr.dobj_segments(A * M, C, R, D, True) == 1
    assert sr.dobj_segments(A * M, C, R, D, False) == 1
    # K3: 105 row tiles x 13 D slices fill the card at the contrastive
    # call; VG's 10 x 13 blocks take round(528 / 130) image segments; the
    # test shape's single block would want 528, but its 5 images make one
    assert sr.dspan_segments(128 * 210, 128, 400) == 1
    assert sr.dspan_segments(128 * 20, 128, 400) == 4
    assert sr.dspan_segments(A * M, C, D) == 1
    assert sr.dspan_segments(37 * 13, 37, 400) == 4      # C // 8 images
    assert sr.dspan_segments(128 * 20, 0, 400) == 1
    with pytest.raises(ValueError):
        sr.span_region_max(torch.zeros(1, 1, 8), torch.zeros(1, 1, 8),
                           "pallas")


def _segmented_dspan(obj, am, g, segs):
    """K3's order with the images cut into ``segs`` segments, as the
    kernel cuts them (segment z takes images [C z / segs, C (z + 1) /
    segs)): each segment's f32 sum, then the segments added in order."""
    C = g.shape[1]
    out = None
    for z in range(segs):
        c0, c1 = C * z // segs, C * (z + 1) // segs
        part = sr.span_region_dspan_plain(obj[c0:c1], am[:, c0:c1],
                                          g[:, c0:c1], torch.float32)
        out = part if out is None else out + part
    return out


@pytest.mark.parametrize("a,m,c,r,d", [
    (128, 20, 128, 36, 64), (37, 13, 37, 36, 40), (9, 5, 130, 3, 16)])
def test_dspan_segments_sum_matches_plain(a, m, c, r, d):
    """K3's segmented sum, in the segment count and order the kernel takes
    at these shapes (VG's rows and images at a narrow D, and more segments
    than a block count), within the f32 tolerance of the plain version;
    every image lands in exactly one segment."""
    segs = sr.dspan_segments(a * m, c, d)
    assert segs > 1
    bounds = [(c * z // segs, c * (z + 1) // segs) for z in range(segs)]
    assert bounds[0][0] == 0 and bounds[-1][1] == c
    assert all(hi == lo for (_, hi), (lo, _) in zip(bounds, bounds[1:]))
    rs = np.random.RandomState(a + m + c)
    obj = torch.from_numpy(rs.randn(c, r, d).astype(np.float32))
    am = torch.from_numpy(rs.randint(0, r, (a, c, m)).astype(np.int32))
    g = torch.from_numpy(rs.randn(a, c, m).astype(np.float32))
    want = sr.span_region_dspan_plain(obj, am, g, torch.float32)
    got = _segmented_dspan(obj, am, g, segs)
    scale = max(1.0, want.abs().max().item())
    assert (got - want).abs().max().item() <= 1e-4 * scale


def _bf16_terms(g: torch.Tensor, terms: int):
    """g split as K4's bf16 route splits it: each term the bf16 rounding
    of what the earlier terms left."""
    out, rest = [], g.float()
    for _ in range(terms):
        t = rest.to(torch.bfloat16).float()
        out.append(t)
        rest = rest - t
    return out


def _onehot_gemm_dobj(span, am, g, R, terms=2):
    """The arithmetic of K4's bf16 route, emulated: dobj (C*R, D) = W .
    span over the A*M span rows, W[c R + r, a M + m] = g[a, c, m]
    [am[a, c, m] = r], with W split into bf16 terms; each term times a
    bf16 span value is exact in f32, and the sums are f32."""
    A, M, D = span.shape
    C = g.shape[1]
    s = span.float().reshape(A * M, D)
    idx = am.permute(1, 0, 2).reshape(C, 1, A * M).long()
    out = torch.zeros(C * R, D)
    for term in _bf16_terms(g.permute(1, 0, 2).reshape(C, 1, A * M), terms):
        w = torch.zeros(C, R, A * M).scatter_(1, idx, term)
        out += w.reshape(C * R, A * M) @ s
    return out.reshape(C, R, D)


def _dobj_inputs(a, m, c, r, d, g_kind, seed=7):
    rs = np.random.RandomState(seed)
    span = torch.from_numpy(rs.randn(a, m, d).astype(np.float32))
    am = torch.from_numpy(rs.randint(0, r, (a, c, m)).astype(np.int32))
    if g_kind == "normal":
        g = rs.randn(a, c, m)
    else:   # magnitudes spread over 1e-6 ... 1e3, either sign
        g = (np.sign(rs.randn(a, c, m))
             * 10.0 ** rs.uniform(-6, 3, (a, c, m)))
    return span.to(torch.bfloat16), am, torch.from_numpy(g.astype(np.float32))


@pytest.mark.parametrize("g_kind", ["normal", "spread"])
@pytest.mark.parametrize("a,m,c,r,d", [(A, M, C, R, D), (37, 13, 37, 36, 400)])
def test_onehot_gemm_split_matches_plain(a, m, c, r, d, g_kind):
    """K4's bf16 arithmetic (two bf16 terms of g, f32 sums) within 1e-4 of
    the plain version's largest magnitude, the limit K4 is held to on the
    card; the same rows all on region 0 (init) give the same bound."""
    span, am, g = _dobj_inputs(a, m, c, r, d, g_kind)
    for amx in (am, torch.zeros_like(am)):
        want = sr.span_region_dobj_plain(span, amx, g, r, torch.float32)
        got = _onehot_gemm_dobj(span, amx, g, r)
        scale = max(1.0, want.abs().max().item())
        assert (got - want).abs().max().item() <= 1e-4 * scale


def test_bf16_split_leaves_under_2_pow_minus_16():
    """What two bf16 terms leave out of g is at most 2^-16 of it, over
    magnitudes 1e-6 ... 1e3: bf16 rounds to 8 significant bits (relative
    error at most 2^-8), and the second term rounds the first's residual."""
    _, _, g = _dobj_inputs(4, 50, 9, 36, 8, "spread")
    hi, lo = _bf16_terms(g, 2)
    assert torch.all((g - hi).abs() <= 2.0 ** -8 * g.abs())
    assert torch.all((g - hi - lo).abs() <= 2.0 ** -16 * g.abs())


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("a,m,c,r,d", [
    (3, 17, 5, 7, 24), (37, 13, 37, 36, 400), (2, 1, 1, 36, 64),
    (9, 5, 130, 3, 16),
    # edges of the Hopper tiles: R = 144 (one image a K2 column tile, K4
    # rows past a 128-row tile), D = 16 (one K2 k tile, K4 boxes outside
    # D), a D tail inside a 64-deep k tile, C*R not a multiple of 128 with
    # many K4 row segments
    (5, 7, 3, 144, 400), (4, 9, 6, 36, 16), (3, 50, 5, 36, 72),
    (64, 100, 16, 36, 400),
    # the widest D supports() takes: 32 K3 slices, K2/K4 many k tiles
    (6, 30, 9, 36, 1024),
    # the VG call of the train step: K3 and K4 f32 in segments
    (128, 20, 128, 36, 400)])
def test_cuda_kernels_match_plain(cuda, a, m, c, r, d):
    """K2: f32 max within 1e-4 of the plain version (scaled to the
    scores' magnitude), argmax equal wherever the top-2 gap exceeds that;
    bf16 argmax agreement >= 0.99.  K3/K4 at 1e-4 (f32) of the plain
    versions (K3 bf16 at 1e-2) and bitwise-equal over two calls.  obj all
    zero: argmax 0, and K3 and K4 on that all-ties argmax with nonzero g
    hold the same limits; g all zero: dobj zero."""
    gen = torch.Generator(device=cuda).manual_seed(a * m + c)
    span = torch.randn(a, m, d, generator=gen, device=cuda)
    obj = torch.randn(c, r, d, generator=gen, device=cuda)
    g = torch.randn(a, c, m, generator=gen, device=cuda)
    for dt in (torch.float32, torch.bfloat16):
        s = span.to(dt)
        before = _calls()
        mx, am = sr.span_region_fwd(s, obj)
        torch.cuda.synchronize()
        assert _calls()["span_region_fwd"] == before["span_region_fwd"] + 1
        pmx, pam = sr.span_region_fwd_plain(s, obj)
        scale = max(1.0, pmx.abs().max().item())
        if dt == torch.float32:
            torch.testing.assert_close(mx, pmx, atol=1e-4 * scale, rtol=0)
            # f32 operands 4 bytes past a 16-byte boundary: TMA and float4
            # loads cannot read them, so the wrappers refuse them
            odd_span = torch.empty(a * m * d + 1, device=cuda)[1:]
            odd_obj = torch.empty(c * r * d + 1, device=cuda)[1:]
            with pytest.raises(ValueError, match="16-byte"):
                sr.span_region_fwd(odd_span.view(a, m, d), obj)
            with pytest.raises(ValueError, match="16-byte"):
                sr.span_region_fwd(s, odd_obj.view(c, r, d))
            with pytest.raises(ValueError, match="16-byte"):
                sr.span_region_dobj(odd_span.view(a, m, d), am, g, r,
                                    torch.float32)
            scores = torch.einsum("amd,crd->acmr", s, obj)
            top2 = torch.topk(scores, min(2, r), dim=-1).values
            gap = (top2[..., 0] - top2[..., -1]) > 1e-4 * scale
            assert torch.equal(am[gap], pam[gap])
        else:
            assert (am == pam).float().mean().item() >= 0.99
            assert (mx - pmx).abs().max().item() <= 1e-3 * scale
        dspan = sr.span_region_dspan(obj, am, g, dt)
        dobj = sr.span_region_dobj(s, am, g, r, torch.float32)
        pdspan = sr.span_region_dspan_plain(obj, am, g, dt)
        pdobj = sr.span_region_dobj_plain(s, am, g, r, torch.float32)
        dscale = max(1.0, pdspan.abs().max().item())
        tol = 1e-4 if dt == torch.float32 else 1e-2
        assert (dspan.float() - pdspan.float()).abs().max().item() \
            <= tol * dscale
        assert (dobj - pdobj).abs().max().item() \
            <= 1e-4 * max(1.0, pdobj.abs().max().item())
        assert torch.equal(dspan, sr.span_region_dspan(obj, am, g, dt))
        assert torch.equal(dobj, sr.span_region_dobj(s, am, g, r,
                                                     torch.float32))
        zmx, zam = sr.span_region_fwd(s, torch.zeros_like(obj))
        assert torch.equal(zam, torch.zeros_like(zam))
        assert torch.equal(zmx, torch.zeros_like(zmx))
        zdobj = sr.span_region_dobj(s, zam, torch.zeros_like(g), r,
                                    torch.float32)
        assert torch.equal(zdobj, torch.zeros_like(zdobj))
        zdspan = sr.span_region_dspan(obj, zam, g, dt)
        pzdspan = sr.span_region_dspan_plain(obj, zam, g, dt)
        assert (zdspan.float() - pzdspan.float()).abs().max().item() \
            <= tol * max(1.0, pzdspan.float().abs().max().item())
        assert torch.equal(zdspan, sr.span_region_dspan(obj, zam, g, dt))
        zgdobj = sr.span_region_dobj(s, zam, g, r, torch.float32)
        pzgdobj = sr.span_region_dobj_plain(s, zam, g, r, torch.float32)
        assert (zgdobj - pzgdobj).abs().max().item() \
            <= 1e-4 * max(1.0, pzgdobj.abs().max().item())
        assert torch.equal(zgdobj, sr.span_region_dobj(s, zam, g, r,
                                                       torch.float32))
