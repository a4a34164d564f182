"""Fused inside pass + CKY decode: the CUDA kernel and its plain version.

Counterpart of cliora_tpu/ops/pallas_chart.py.  ``fused_inside_cky``
runs the whole bottom-up recursion of a text-only DIORA chart (mlp
compose, soft split aggregation) and returns only what the decode needs
-- the h chart never leaves the function.  On a CUDA tensor it launches
the kernel of ``csrc/inside_cky.cu`` (design notes there); on a CPU
tensor it runs ``fused_inside_cky_plain``, the same arithmetic in plain
PyTorch, which is also the kernel's oracle on the card.

Numerics follow the TPU kernel (``_kernel`` in pallas_chart.py):
weights and the h chart in the compute dtype, matmul accumulation,
scores, softmax and CKY in f32; ``h1 = relu(W0[:, :D] l + W0[:, D:] r +
b0)`` with the two products summed after they are taken; ``l M`` is kept
in f32 before the dot with ``r``; the CKY value is
``max_k(v_l + v_r + s_k) - max_k s_k`` with the first-max backpointer.
Both versions take the three child products once per chart cell (the
cell's projection) rather than once per (cell, split) row.
"""

from __future__ import annotations

import ctypes

import torch

from cliora_tpu_torch import kernels
from cliora_tpu_torch.chart.indices import INDEX
from cliora_tpu_torch.chart.offsets import level_offsets, ncells

# Wrapper launches of the CUDA kernel in this process (one per call that
# ran on the card); the plain version never counts.
launches = 0

_SMEM_SPARE_FLOATS = 128        # room for combine's static shared memory
_INT32_MAX = 2 ** 31 - 1
_SMEM_STATIC_LIMIT = 48 * 1024  # combine's dynamic shared memory, no opt-in


def supports(n: int, D: int, batch: int,
             compute_dtype: str = "float32") -> bool:
    """Whether the CUDA kernel takes this batch shape.

    Needs at least one level (n >= 2); D a multiple of 4 (the f32 GEMM
    tiles copy 4 values at a time), or of 8 for bf16 (its weight tiles
    arrive by TMA, whose rows are multiples of 16 bytes); the combine
    block's shared memory (D + 2(n-1) floats, with 128 to spare) must
    fit the default 48 KB; row counts must fit the kernel's 32-bit grid
    arithmetic.
    """
    if compute_dtype not in ("float32", "bfloat16"):
        return False
    align = 8 if compute_dtype == "bfloat16" else 4
    if n < 2 or D < align or D % align or batch < 1:
        return False
    if (2 * (n - 1) + D + _SMEM_SPARE_FLOATS) * 4 > _SMEM_STATIC_LIMIT:
        return False
    return batch * _max_rows_per_sentence(n) < _INT32_MAX


def _max_rows_per_sentence(n: int) -> int:
    """Largest level's (cell, split) rows: max_l (n - l) * l."""
    return max((n - lvl) * lvl for lvl in range(1, n))


def _weights(dp):
    cp = dp["inside_compose"]
    return (cp["fc0"]["w"], cp["fc0"]["b"], cp["fc1"]["w"], cp["fc1"]["b"],
            dp["inside_score"]["mat"])


def fused_inside_cky_plain(dp, h0: torch.Tensor, norm: str = "unit",
                           compute_dtype: str = "float32"):
    """Plain PyTorch version of the kernel, on any device.

    Returns ``(inside_s (B, ncells, 1) f32, bp (B, ncells) int32,
    val (B, ncells) f32)`` in the flat chart layout.
    """
    B, n, D = h0.shape
    dev = h0.device
    cdt = torch.bfloat16 if compute_dtype == "bfloat16" else torch.float32
    NC = ncells(n)
    offs = level_offsets(n)
    w0, b0, w1, b1, mat = _weights(dp)
    # weights rounded to the compute dtype, multiplied in f32: exact
    # products of compute-dtype values with f32 accumulation
    w0 = w0.to(cdt).float()
    w0l, w0r = w0[:, :D], w0[:, D:]
    w1 = w1.to(cdt).float()
    mat = mat.to(cdt).float()

    chart = torch.zeros((B, NC, D), dtype=cdt, device=dev)
    chart[:, :n] = h0.to(cdt)
    s = torch.zeros((B, NC), dtype=torch.float32, device=dev)
    val = torch.ones((B, NC), dtype=torch.float32, device=dev)
    bp = torch.zeros((B, NC), dtype=torch.int32, device=dev)
    # per-cell projections W0[:, :D] h, W0[:, D:] h, h M (f32)
    proj_l, proj_r, proj_m = (
        torch.zeros((B, NC, D), dtype=torch.float32, device=dev)
        for _ in range(3))

    def project(lo, hi):
        h = chart[:, lo:hi].float()
        proj_l[:, lo:hi] = h @ w0l.T
        proj_r[:, lo:hi] = h @ w0r.T
        proj_m[:, lo:hi] = h @ mat

    project(0, n)
    for level in range(1, n):
        L, N = n - level, level
        idx_l, idx_r = INDEX.inside(n, level, dev)
        h1 = torch.relu(proj_l[:, idx_l] + proj_r[:, idx_r] + b0)
        h1 = h1.to(cdt).float()
        hk = torch.relu(h1 @ w1.T + b1).to(cdt).float()   # (B, L*N, D)
        bil = torch.sum(proj_m[:, idx_l] * chart[:, idx_r].float(), dim=-1)

        sk = (bil + s[:, idx_l] + s[:, idx_r]).reshape(B, L, N)
        pk = sk + (val[:, idx_l] + val[:, idx_r]).reshape(B, L, N)
        m = torch.amax(sk, dim=-1, keepdim=True)
        e = torch.exp(sk - m)
        z = torch.sum(e, dim=-1)
        h = torch.einsum("blnd,bln->bld", hk.reshape(B, L, N, D), e)
        h = h / z[..., None]
        if norm == "unit":
            h = h * torch.rsqrt(torch.clamp(
                torch.sum(h * h, dim=-1, keepdim=True), min=1e-16))

        off = int(offs[level])
        chart[:, off:off + L] = h.to(cdt)
        s[:, off:off + L] = torch.sum(sk * e, dim=-1) / z
        val[:, off:off + L] = torch.amax(pk, dim=-1) - m[..., 0]
        # first maximal index: the kernel's strict '>' scan
        bp[:, off:off + L] = torch.argmax(pk, dim=-1).to(torch.int32)
        if level < n - 1:           # the root is nobody's child
            project(off, off + L)

    return s[..., None], bp, val


_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = kernels.load("inside_cky")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.inside_cky_forward.argtypes = [ptr] * 15 + [i32] * 5 + [ptr]
        lib.inside_cky_forward.restype = i32
        lib.inside_cky_error_string.argtypes = [i32]
        lib.inside_cky_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check(name: str, t: torch.Tensor, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def fused_inside_cky(dp, h0: torch.Tensor, norm: str = "unit",
                     compute_dtype: str = "float32"):
    """Inside pass + CKY for (B, n, D) f32 leaves.

    Returns ``(inside_s (B, ncells, 1) f32, bp (B, ncells) int32,
    val (B, ncells) f32)``.  A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel or raises.
    """
    global launches
    if h0.device.type == "cpu":
        return fused_inside_cky_plain(dp, h0, norm, compute_dtype)
    if h0.device.type != "cuda":
        raise ValueError(f"unsupported device {h0.device}")
    if norm not in ("unit", "none"):
        raise ValueError(f"norm={norm!r}")
    B, n, D = h0.shape
    if not supports(n, D, B, compute_dtype):
        raise ValueError(f"the CUDA inside+CKY kernel does not take "
                         f"B={B}, n={n}, D={D}, {compute_dtype}")
    dev = h0.device
    w0, b0, w1, b1, mat = _weights(dp)
    for name, t, shape in (("h0", h0, (B, n, D)), ("fc0.w", w0, (D, 2 * D)),
                           ("fc0.b", b0, (D,)), ("fc1.w", w1, (D, D)),
                           ("fc1.b", b1, (D,)), ("mat", mat, (D, D))):
        _check(name, t, shape, dev)

    lib = _lib()
    cdt = torch.bfloat16 if compute_dtype == "bfloat16" else torch.float32
    NC = ncells(n)
    chart = torch.empty((B, NC, D), dtype=cdt, device=dev)
    s = torch.empty((B, NC), dtype=torch.float32, device=dev)
    val = torch.empty((B, NC), dtype=torch.float32, device=dev)
    bp = torch.empty((B, NC), dtype=torch.int32, device=dev)
    proj = torch.empty((B, NC, 3 * D), dtype=torch.float32, device=dev)
    rows = B * _max_rows_per_sentence(n)
    hk = torch.empty((rows, D), dtype=cdt, device=dev)
    # the k-major weights in the compute dtype; bf16 builds h1 in registers
    wp = torch.empty((D, 3 * D), dtype=cdt, device=dev)
    w1t = torch.empty((D, D), dtype=cdt, device=dev)
    h1 = (None if cdt == torch.bfloat16
          else torch.empty((rows, D), dtype=cdt, device=dev))
    # bases of TMA boxes, 16-byte cp.async copies and vector stores
    for name, t in (("chart", chart), ("proj", proj), ("hk", hk), ("h1", h1),
                    ("wp", wp), ("w1t", w1t)):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.inside_cky_forward(
            h0.data_ptr(), w0.data_ptr(), b0.data_ptr(), w1.data_ptr(),
            b1.data_ptr(), mat.data_ptr(), chart.data_ptr(), s.data_ptr(),
            val.data_ptr(), bp.data_ptr(), proj.data_ptr(),
            None if h1 is None else h1.data_ptr(), hk.data_ptr(),
            wp.data_ptr(), w1t.data_ptr(), B, n, D,
            int(cdt == torch.bfloat16), int(norm == "unit"), stream)
    if err != 0:
        msg = lib.inside_cky_error_string(err).decode()
        raise RuntimeError(f"inside_cky kernel launch failed: {msg} ({err})")
    launches += 1
    return s[..., None], bp, val
