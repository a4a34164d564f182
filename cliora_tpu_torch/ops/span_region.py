"""Fused span x region best-match scores: ``max_r span . obj``.

Counterpart of cliora_tpu/ops/span_region.py.  The CLIORA losses only
consume ``max`` over regions of the span x region score tensor
(reference: cliora/net/trainer.py:103 ``all_atten_score.max(-1)`` and
:145 ``vg_atten_score.max(-1)``), so ``span_region_max`` computes

    out[a, c, m] = max_r sum_d span[a, m, d] * obj[c, r, d]

without the ``(A, C, M, R)`` tensor in the backward, and -- under
``impl='cuda'`` -- in the forward too.  Three interchangeable forwards:

  * ``einsum``  -- materializing reference semantics (the oracle);
  * ``chunked`` -- one image chunk at a time, O(A * chunk * M * R) live;
  * ``cuda``    -- kernel K2 of ``csrc/span_region.cu``: a GEMM whose
    epilogue reduces each image's regions, so the scores never reach
    device memory.

The gradient is a custom one (an autograd Function): only the int32
argmax region is saved, and max is locally linear in it, so

    dspan[a, m, :] = sum_c g[a, c, m] * obj[c, am[a, c, m], :]
    dobj[c, r, :]  = sum_{(a, m): am[a, c, m] = r} g[a, c, m] * span[a, m, :]

It goes to the first-max region, not split across ties.  Under
``impl='cuda'`` these are kernels K3 and K4; the other impls run their
plain versions.  K3 serves its gather from shared memory: a block stages
each image's 32-column slice of ``obj`` and its 256-row tile's argmax and
``g``, and sums the images in increasing order, one ``fmaf`` each, as the
plain gather does; where that leaves too few blocks (the VG call) the
images are cut into ``dspan_segments`` segments whose f32 partial sums a
second pass adds in order.  It is bound by shared-memory reads (16 bytes
of ``obj`` per 4 FMAs) and its staging, not by its FLOP.  K4 on f32 spans
with the model's 36 regions keeps its accumulators in registers: a warp
owns 9 regions of one image and a lane 8 columns of each, and applies a
stage's rows region by region in increasing row order (ballots find each
region's rows), one ``fmaf`` a row per entry, in ``dobj_segments``
segments added in order.

K2 on f32 spans sums each score over D in order from 0 with ``fmaf`` on
the CUDA cores, the order of torch's f32 GEMM, so its scores carry that
GEMM's bits.  The contrastive loss is a hinge on them: a sum in another
order (a 3xTF32 route on the tensor cores was tried) moves scores across
the margin and, with them, the f32 step's gradient of the region
encoder's bias, a residue of cancelling terms.

Numerics: the forward contracts in the span dtype (obj is cast to it)
and accumulates in f32; the backward keeps ``g`` in f32, reads ``obj``
in its own dtype and ``span`` in the span dtype, and accumulates in f32
-- the arithmetic of the JAX package's einsum and chunked backward.  (Its Pallas backward rounds the g-weighted one-hot
and ``obj`` to the span dtype before its matmuls; the port does not.)

Each kernel's wrapper takes its plain version only for a CPU tensor; on
a CUDA tensor it launches the kernel or raises.  ``launches`` counts the
kernel launches of each wrapper in this process.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from cliora_tpu_torch import kernels

# Kernel launches per wrapper in this process; the plain versions never
# count.
launches: Dict[str, int] = {
    "span_region_fwd": 0, "span_region_dspan": 0, "span_region_dobj": 0}

CHUNK = 8        # images per chunk of the 'chunked' forward
BWD_CHUNK = 16   # images per chunk of the plain backward
IMPLS = ("einsum", "chunked", "cuda")

# K2's column tile (csrc/span_region.cu BN) holds whole images
MAX_REGIONS = 144
_SMEM_LIMIT = 232448     # shared memory a block can use


# -- plain versions ---------------------------------------------------------

def _max_argmax(span: torch.Tensor, obj_c: torch.Tensor):
    """Max and first-max argmax over regions of one image chunk.  Widened
    f32 operands: exact products of span-dtype values, f32 sums."""
    s = torch.einsum("amd,crd->acmr", span.float(), obj_c.float())
    mx, am = torch.max(s, dim=-1)     # the first maximal index on ties
    return mx, am.to(torch.int32)


def span_region_fwd_plain(span: torch.Tensor, obj: torch.Tensor):
    """(A, M, D) x (C, R, D) -> (max (A, C, M) f32, argmax (A, C, M)
    int32), materializing the scores: K2's plain version."""
    return _max_argmax(span, obj.to(span.dtype))


def _fwd_chunked(span: torch.Tensor, obj: torch.Tensor, chunk: int = CHUNK):
    obj = obj.to(span.dtype)          # cast once, outside the chunk loop
    parts = [_max_argmax(span, obj[c0:c0 + chunk])
             for c0 in range(0, obj.shape[0], chunk)]
    return (torch.cat([p[0] for p in parts], 1),
            torch.cat([p[1] for p in parts], 1))


def _weighted_onehot(am_c: torch.Tensor, g_c: torch.Tensor, R: int):
    """``w[a, c, m, r] = g[a, c, m] * (am[a, c, m] == r)``, f32."""
    onehot = torch.nn.functional.one_hot(am_c.long(), R).float()
    return onehot * g_c.float()[..., None]


def span_region_dspan_plain(obj: torch.Tensor, am: torch.Tensor,
                            g: torch.Tensor, span_dtype: torch.dtype):
    """K3's plain version: ``dspan (A, M, D)`` in ``span_dtype``,
    accumulated in f32 over image chunks."""
    A, C, M = g.shape
    R, D = obj.shape[1], obj.shape[2]
    dspan = torch.zeros((A, M, D), dtype=torch.float32, device=g.device)
    for c0 in range(0, C, BWD_CHUNK):
        w = _weighted_onehot(am[:, c0:c0 + BWD_CHUNK],
                             g[:, c0:c0 + BWD_CHUNK], R)
        dspan += torch.einsum("acmr,crd->amd", w,
                              obj[c0:c0 + BWD_CHUNK].float())
    return dspan.to(span_dtype)


def span_region_dobj_plain(span: torch.Tensor, am: torch.Tensor,
                           g: torch.Tensor, R: int,
                           obj_dtype: torch.dtype):
    """K4's plain version: ``dobj (C, R, D)`` in ``obj_dtype``,
    accumulated in f32."""
    C = g.shape[1]
    parts = [torch.einsum("acmr,amd->crd",
                          _weighted_onehot(am[:, c0:c0 + BWD_CHUNK],
                                           g[:, c0:c0 + BWD_CHUNK], R),
                          span.float())
             for c0 in range(0, C, BWD_CHUNK)]
    return torch.cat(parts, 0).to(obj_dtype)


# -- CUDA kernels -----------------------------------------------------------

_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = kernels.load("span_region")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.span_region_fwd.argtypes = [ptr] * 4 + [i32] * 6 + [ptr]
        lib.span_region_fwd.restype = i32
        lib.span_region_dspan.argtypes = [ptr] * 5 + [i32] * 7 + [ptr]
        lib.span_region_dspan.restype = i32
        lib.span_region_dobj.argtypes = [ptr] * 5 + [i32] * 7 + [ptr]
        lib.span_region_dobj.restype = i32
        lib.span_region_error_string.argtypes = [i32]
        lib.span_region_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check(name, t: torch.Tensor, dtypes, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}, expected one of "
                        f"{dtypes}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _raise_on(err: int, what: str):
    if err != 0:
        msg = _lib().span_region_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} ({err})")


def _cuda_device(t: torch.Tensor) -> torch.device:
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    return t.device


_SPAN_DTYPES = (torch.float32, torch.bfloat16)
_F32 = (torch.float32,)
_I32 = (torch.int32,)


def supports(D: int, R: int) -> bool:
    """Whether the kernels take this width and region count: D a multiple
    of 8 (16-byte rows of bf16 for TMA and the loaders) and at most 1024
    (the widest the card tests hold), and 1 <= R <= MAX_REGIONS."""
    return 8 <= D <= 1024 and D % 8 == 0 and 1 <= R <= MAX_REGIONS


def _check_aligned(name, t: torch.Tensor):
    """TMA, 16-byte ``cp.async`` copies and float4 loads read only from a
    16-byte-aligned base."""
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary")


def span_region_fwd(span: torch.Tensor, obj: torch.Tensor):
    """K2: ``(max (A, C, M) f32, argmax (A, C, M) int32)``.  A CPU tensor
    takes :func:`span_region_fwd_plain`; a CUDA tensor launches the
    kernel or raises."""
    if span.device.type == "cpu":
        return span_region_fwd_plain(span, obj)
    dev = _cuda_device(span)
    A, M, D = span.shape
    C, R, _ = obj.shape
    if not supports(D, R):
        raise ValueError(f"span_region kernels do not take D={D}, R={R}")
    obj = obj.to(span.dtype).contiguous()   # one operand dtype in the GEMM
    _check("span", span, _SPAN_DTYPES, (A, M, D), dev)
    _check("obj", obj, _SPAN_DTYPES, (C, R, D), dev)
    _check_aligned("span", span)
    _check_aligned("obj", obj)
    mx = torch.empty((A, C, M), dtype=torch.float32, device=dev)
    am = torch.empty((A, C, M), dtype=torch.int32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.span_region_fwd(
            span.data_ptr(), obj.data_ptr(), mx.data_ptr(), am.data_ptr(),
            A, M, C, R, D, int(span.dtype == torch.bfloat16), stream)
    _raise_on(err, "span_region_fwd")
    launches["span_region_fwd"] += 1
    return mx, am


# K3 image segments.  A block owns a row tile of _DSPAN_ROWS span rows and
# a _DSPAN_DSLICE-column slice of D (csrc/span_region.cu K3_ROWS, K3_DS).
# Where those blocks fall short of _DSPAN_TARGET_BLOCKS (four on each of
# the H100's 132 SMs), the C images are cut into segments of at least
# _DSPAN_MIN_IMAGES, and a second pass adds the segments' partial sums in
# order.  The count depends on the shapes only.
_DSPAN_ROWS = 256
_DSPAN_DSLICE = 32
_DSPAN_TARGET_BLOCKS = 528
_DSPAN_MIN_IMAGES = 8


def dspan_segments(rows: int, C: int, D: int) -> int:
    """Image segments of K3 for ``rows = A * M`` span rows."""
    base = -(-rows // _DSPAN_ROWS) * -(-D // _DSPAN_DSLICE)
    if base >= _DSPAN_TARGET_BLOCKS:
        return 1
    return max(1, min(round(_DSPAN_TARGET_BLOCKS / base),
                      C // _DSPAN_MIN_IMAGES))


def span_region_dspan(obj: torch.Tensor, am: torch.Tensor, g: torch.Tensor,
                      span_dtype: torch.dtype):
    """K3: ``dspan (A, M, D)`` in ``span_dtype``, with no float atomics:
    two calls on the same inputs give the same bits.  A CPU tensor takes
    :func:`span_region_dspan_plain`; a CUDA tensor launches the kernel or
    raises."""
    if g.device.type == "cpu":
        return span_region_dspan_plain(obj, am, g, span_dtype)
    dev = _cuda_device(g)
    A, C, M = g.shape
    R, D = obj.shape[1], obj.shape[2]
    if not supports(D, R):
        raise ValueError(f"span_region kernels do not take D={D}, R={R}")
    obj = obj.float().contiguous()
    g = g.contiguous()
    _check("obj", obj, _F32, (C, R, D), dev)
    _check("am", am, _I32, (A, C, M), dev)
    _check("g", g, _F32, (A, C, M), dev)
    _check_aligned("obj", obj)
    if span_dtype not in _SPAN_DTYPES:
        raise TypeError(f"span dtype {span_dtype}")
    segs = dspan_segments(A * M, C, D)
    dspan = torch.empty((A, M, D), dtype=span_dtype, device=dev)
    partial = (torch.empty((segs, A, M, D), dtype=torch.float32, device=dev)
               if segs > 1 else None)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.span_region_dspan(
            obj.data_ptr(), am.data_ptr(), g.data_ptr(),
            None if partial is None else partial.data_ptr(),
            dspan.data_ptr(), A, M, C, R, D, segs,
            int(span_dtype == torch.bfloat16), stream)
    _raise_on(err, "span_region_dspan")
    launches["span_region_dspan"] += 1
    return dspan


# K4 row segments.  The A*M span rows are cut into fixed segments; each
# block sums one segment for its tile of dobj, and a second pass adds the
# segments' partial sums in segment order.  The count depends on the
# shapes only, so a result is the same bits on every call.
# bf16 spans (the one-hot GEMM, csrc/span_region.cu k4_dobj_gemm): tiles of
# _GEMM_ROWS region rows x _GEMM_COLS columns, segments of whole 64-row k
# tiles, enough segments for _GEMM_TARGET_BLOCKS blocks (six waves of one
# block on each of the H100's 132 SMs), at least _GEMM_MIN_TILES k tiles
# each.
_GEMM_ROWS = 128         # K4W_ROWS
_GEMM_COLS = 200         # K4W_BN
_GEMM_BK = 64            # K4W_BK
_GEMM_TARGET_BLOCKS = 792
_GEMM_MIN_TILES = 4
# f32 spans, R = 36 (k4_dobj_regs): blocks of _REGS_GROUP images x
# _REGS_DSLICE columns, accumulators in registers, one block an SM; enough
# segments for one wave of _REGS_TARGET_BLOCKS blocks, at least
# _DOBJ_MIN_ROWS rows each.
_REGS_R = 36             # K4R_R, the R the kernel is compiled for
_REGS_GROUP = 4          # K4R_G
_REGS_DSLICE = 256       # K4R_DS
_REGS_TARGET_BLOCKS = 132    # the H100's SMs
# other R (k4_dobj_f32): blocks of _DOBJ_GROUP images (2 where 4 images'
# accumulators exceed shared memory) x _DOBJ_DSLICE columns, walked in
# enough segments for _DOBJ_TARGET_BLOCKS blocks, at least _DOBJ_MIN_ROWS
# rows each.
_DOBJ_DSLICE = 128       # K4_DS
_DOBJ_TARGET_BLOCKS = 1056   # 8 blocks for each of the H100's 132 SMs
_DOBJ_MIN_ROWS = 256


def _dobj_group(R: int) -> int:
    return 4 if 4 * R * _DOBJ_DSLICE * 4 <= _SMEM_LIMIT else 2


def dobj_segments(rows: int, C: int, R: int, D: int, bf16: bool) -> int:
    """Row segments of K4 for ``rows = A * M`` span rows."""
    if bf16:
        base = -(-C * R // _GEMM_ROWS) * -(-D // _GEMM_COLS)
        want = max(1, round(_GEMM_TARGET_BLOCKS / base))
        return max(1, min(want, -(-rows // _GEMM_BK) // _GEMM_MIN_TILES))
    if R == _REGS_R:
        base = -(-C // _REGS_GROUP) * -(-D // _REGS_DSLICE)
        want = max(1, round(_REGS_TARGET_BLOCKS / base))
    else:
        base = -(-C // _dobj_group(R)) * -(-D // _DOBJ_DSLICE)
        want = -(-_DOBJ_TARGET_BLOCKS // base)
    return max(1, min(want, rows // _DOBJ_MIN_ROWS))


def span_region_dobj(span: torch.Tensor, am: torch.Tensor, g: torch.Tensor,
                     R: int, obj_dtype: torch.dtype):
    """K4: ``dobj (C, R, D)`` in ``obj_dtype``, with no float atomics: two
    calls on the same inputs give the same bits.  A CPU tensor takes
    :func:`span_region_dobj_plain`; a CUDA tensor launches the kernel or
    raises."""
    if span.device.type == "cpu":
        return span_region_dobj_plain(span, am, g, R, obj_dtype)
    dev = _cuda_device(span)
    A, M, D = span.shape
    C = g.shape[1]
    if not supports(D, R):
        raise ValueError(f"span_region kernels do not take D={D}, R={R}")
    g = g.contiguous()
    _check("span", span, _SPAN_DTYPES, (A, M, D), dev)
    _check("am", am, _I32, (A, C, M), dev)
    _check("g", g, _F32, (A, C, M), dev)
    _check_aligned("span", span)
    bf16 = span.dtype == torch.bfloat16
    segs = dobj_segments(A * M, C, R, D, bf16)
    dobj = torch.empty((C, R, D), dtype=torch.float32, device=dev)
    partial = (torch.empty((segs, C, R, D), dtype=torch.float32, device=dev)
               if segs > 1 else dobj)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.span_region_dobj(
            span.data_ptr(), am.data_ptr(), g.data_ptr(), partial.data_ptr(),
            dobj.data_ptr(), A, M, C, R, D, segs, int(bf16), stream)
    _raise_on(err, "span_region_dobj")
    launches["span_region_dobj"] += 1
    return dobj.to(obj_dtype)


# -- the autograd Function ----------------------------------------------------

_FORWARDS = {
    "einsum": span_region_fwd_plain,
    "chunked": _fwd_chunked,
    "cuda": span_region_fwd,
}


class _SpanRegionMax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, span, obj, impl):
        mx, am = _FORWARDS[impl](span, obj)
        ctx.impl = impl
        ctx.save_for_backward(span, obj, am)
        ctx.mark_non_differentiable(am)
        return mx

    @staticmethod
    def backward(ctx, g):
        span, obj, am = ctx.saved_tensors
        g = g.float().contiguous()
        R = obj.shape[1]
        dspan = dobj = None
        if ctx.impl == "cuda":
            if ctx.needs_input_grad[0]:
                dspan = span_region_dspan(obj, am, g, span.dtype)
            if ctx.needs_input_grad[1]:
                dobj = span_region_dobj(span, am, g, R, obj.dtype)
        else:
            if ctx.needs_input_grad[0]:
                dspan = span_region_dspan_plain(obj, am, g, span.dtype)
            if ctx.needs_input_grad[1]:
                dobj = span_region_dobj_plain(span, am, g, R, obj.dtype)
        return dspan, dobj, None


def span_region_max(span: torch.Tensor, obj: torch.Tensor,
                    impl: str = "einsum") -> torch.Tensor:
    """(A, M, D) x (C, R, D) -> (A, C, M) f32 best-region scores, with the
    argmax-routed gradient."""
    if impl not in IMPLS:
        raise ValueError(f"impl={impl!r}, expected one of {IMPLS}")
    return _SpanRegionMax.apply(span, obj, impl)
