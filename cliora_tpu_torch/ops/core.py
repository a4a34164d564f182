"""Primitive ops of the chart passes (counterpart of cliora_tpu/ops/core.py).

Plain functions on tensors.  Parameters are nested dicts whose linear
weights use the torch ``(out_features, in_features)`` layout, the same
as the JAX package, so weights carry across without transposes.
"""

from __future__ import annotations

from typing import Optional

import torch

TINY = 1e-8


def unit_norm(x: torch.Tensor, eps: float = TINY) -> torch.Tensor:
    """L2-normalize the last dim, clamping the norm at ``eps``.

    For low-precision inputs the squared sum accumulates in f32 and the
    reciprocal norm is rounded once, so the result stays in ``x.dtype``.
    (reference: cliora/net/utils.py:11-14 ``UnitNorm``)
    """
    if x.dtype == torch.float32:
        norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
        return x / torch.clamp(norm, min=eps)
    ss = torch.sum(torch.square(x.float()), dim=-1, keepdim=True)
    scale = 1.0 / torch.clamp(torch.sqrt(ss), min=eps)
    return x * scale.to(x.dtype)


def normalize(mode: str, x: torch.Tensor) -> torch.Tensor:
    """(reference: cliora/net/utils.py:17-27 ``NormalizeFunc``)"""
    if mode == "unit":
        return unit_norm(x)
    return x


def linear(p, x: torch.Tensor) -> torch.Tensor:
    """``x @ w.T + b`` with torch-layout weight ``w: (out, in)``."""
    return x @ p["w"].T + p["b"]


def leaf_mlp(cp, x: torch.Tensor) -> torch.Tensor:
    """Leaf transform ``tanh(leaf_fc(x))``.

    (reference: cliora/net/diora.py:58-63)
    """
    return torch.tanh(linear(cp["leaf_fc"], x))


def _cast(p, dtype):
    return {k: v.to(dtype) for k, v in p.items()}


def compose_mlp(cp, left_h, right_h, compute_dtype=torch.float32,
                out_dtype=torch.float32) -> torch.Tensor:
    """Two-layer ReLU MLP over the concatenated children.

    ``h = relu(W2 relu(W1 [l; r] + b1) + b2)``
    (reference: cliora/net/diora.py:35-40,65-72).  Both layers run in
    ``compute_dtype``; callers that keep their charts in the compute
    dtype pass it as ``out_dtype`` too.
    """
    x = torch.cat([left_h, right_h], dim=-1).to(compute_dtype)
    h = torch.relu(linear(_cast(cp["fc0"], compute_dtype), x))
    h = torch.relu(linear(_cast(cp["fc1"], compute_dtype), h))
    return h.to(out_dtype)


def einsum_acc(pattern: str, x: torch.Tensor, y: torch.Tensor,
               out_dtype: torch.dtype) -> torch.Tensor:
    """``einsum(pattern, x, y)`` accumulated in f32, returned in
    ``out_dtype``: the port's stand-in for JAX's
    ``preferred_element_type``, which PyTorch's einsum lacks.

    Where the output dtype is the operands' own (bf16 x bf16 -> bf16, or
    f32) the native product already accumulates in f32 (cuBLAS and
    oneDNN bf16 GEMMs do) and rounds once.  Otherwise (bf16 operands, f32
    out) both operands are widened to f32 first: a bf16 value is exact in
    f32, so the f32 product of the widened operands equals the
    bf16-operand, f32-accumulated product, with no rounding of the
    result to bf16.
    """
    if x.dtype == y.dtype == out_dtype:
        return torch.einsum(pattern, x, y)
    return torch.einsum(pattern, x.float(), y.float()).to(out_dtype)


def _einsum_bwd_patterns(pattern: str):
    ins, out = pattern.split("->")
    a, b = ins.split(",")
    return f"{out},{b}->{a}", f"{a},{out}->{b}"


def _bwd_einsum(pattern: str, u: torch.Tensor, v: torch.Tensor,
                want: torch.dtype) -> torch.Tensor:
    """One cotangent of ``lowp_einsum``: a contraction is accumulated in
    f32 (:func:`einsum_acc`); a contraction-free pattern is the
    elementwise product in the operands' dtype, then cast, as JAX's
    ``_einsum_or_bcast`` computes it (cliora_tpu/ops/core.py:119-137)."""
    ins, out = pattern.split("->")
    if set(ins.replace(",", "")) - set(out) - {"."}:
        return einsum_acc(pattern, u, v, want)
    return torch.einsum(pattern, u, v).to(want)


class _LowpEinsum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pattern, x, y, compute_dtype, out_dtype):
        ctx.pattern, ctx.compute_dtype = pattern, compute_dtype
        ctx.save_for_backward(x, y)
        return einsum_acc(pattern, x.to(compute_dtype), y.to(compute_dtype),
                          out_dtype)

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        cdt = ctx.compute_dtype
        dx_pat, dy_pat = _einsum_bwd_patterns(ctx.pattern)
        g16 = g.to(cdt)
        dx = dy = None
        if ctx.needs_input_grad[1]:
            dx = _bwd_einsum(dx_pat, g16, y.to(cdt), x.dtype)
        if ctx.needs_input_grad[2]:
            dy = _bwd_einsum(dy_pat, x.to(cdt), g16, y.dtype)
        return None, dx, dy, None, None


def lowp_einsum(pattern: str, x: torch.Tensor, y: torch.Tensor,
                compute_dtype=torch.float32,
                out_dtype=torch.float32) -> torch.Tensor:
    """Two-operand einsum on ``compute_dtype`` operands, accumulated in
    f32 and returned in ``out_dtype``, whose backward also runs in
    ``compute_dtype``: the incoming cotangent is cast down once and each
    operand's cotangent comes back in that operand's own dtype (f32
    operands, such as softmax probabilities, get f32-accumulated
    gradients).  For f32 inputs it is the plain einsum and its autodiff.
    (counterpart of cliora_tpu/ops/core.py:86-149 ``lowp_einsum``)
    """
    return _LowpEinsum.apply(pattern, x, y, compute_dtype, out_dtype)


def bilinear(mat, a, b, compute_dtype=torch.float32) -> torch.Tensor:
    """Split-compatibility score ``s = a^T M b`` per row, f32 out.

    The intermediate ``a @ M`` projection is *stored* in the compute
    dtype before the second contraction, which takes compute-dtype
    operands and accumulates in f32; the backward stays in the compute
    dtype (``lowp_einsum``).  (reference: cliora/net/diora.py:77-97
    ``Bilinear``)
    """
    am = lowp_einsum("...me,ed->...md", a, mat, compute_dtype, compute_dtype)
    return lowp_einsum("...md,...md->...m", am, b, compute_dtype)


def dropout_keep(generator: Optional[torch.Generator], shape,
                 dropout: float, device) -> torch.Tensor:
    """The keep mask of attention dropout, drawn from ``generator``
    (which must live on ``device``): True with probability
    ``1 - dropout``."""
    if generator is None:
        raise ValueError("attention dropout needs a torch.Generator")
    return torch.rand(shape, generator=generator, device=device) \
        < 1.0 - dropout


def region_attention(h: torch.Tensor, obj: torch.Tensor, *,
                     temp: float = 1.0, dropout: float = 0.0,
                     generator: Optional[torch.Generator] = None,
                     train: bool = False, compute_dtype=torch.float32,
                     keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Single-head cross-attention from span vectors to object regions.

    Per-example only: the reference computes a B x B einsum and takes its
    diagonal (cliora/net/cliora.py:35-42); this computes just the
    diagonal.  No learned projections: q/k/v are used raw.  Dropout on
    the attention probabilities applies ``keep``, the (B, L, R) mask of
    :func:`dropout_keep`, or draws one from ``generator``.  (A chart
    level that may be recomputed in the backward draws its mask before
    the level, so that forward and recompute drop the same
    probabilities.)  (counterpart of cliora_tpu/ops/core.py:169-191)

    Args:
      h:   (B, L, D) query span vectors.
      obj: (B, R, D) region embeddings (keys == values).
    Returns:
      cxt: (B, L, D) attended visual context, in ``h``'s dtype.
    """
    score = lowp_einsum("bld,brd->blr", h, obj, compute_dtype) / temp
    prob = torch.softmax(score, dim=-1)
    if train and dropout > 0.0:
        if keep is None:
            keep = dropout_keep(generator, prob.shape, dropout, prob.device)
        prob = torch.where(keep, prob / (1.0 - dropout),
                           torch.zeros((), dtype=prob.dtype,
                                       device=prob.device))
    # context comes back in the caller's h dtype: the residual add and
    # re-norm then stay in the chart dtype
    return lowp_einsum("blr,brd->bld", prob, obj, compute_dtype, h.dtype)


def compose_treelstm(cp, left, right, compute_dtype=torch.float32):
    """Binary TreeLSTM composition (the DIORA lineage's TreeLSTM cell).

    ``gates = [l_h; r_h] W^T + b`` in ``compute_dtype``, split into
    i, f_l, f_r, o, g; ``c = sig(i) tanh(g) + sig(f_l) c_l + sig(f_r) c_r``
    and ``h = sig(o) tanh(c)``, both returned as f32.
    (counterpart of cliora_tpu/ops/core.py:194-217)

    Args:
      cp: params with ``W`` (5D, 2D) and ``b`` (5D,), torch layout.
      left / right: ``(h, c)`` tuples, each (..., D).
    Returns: ``(h, c)``.
    """
    lh, lc = left
    rh, rc = right
    x = torch.cat([lh, rh], dim=-1).to(compute_dtype)
    gates = x @ cp["W"].T.to(compute_dtype) + cp["b"].to(compute_dtype)
    i, fl, fr, o, g = torch.chunk(gates, 5, dim=-1)
    c = (torch.sigmoid(i) * torch.tanh(g)
         + torch.sigmoid(fl) * lc.to(compute_dtype)
         + torch.sigmoid(fr) * rc.to(compute_dtype))
    h = torch.sigmoid(o) * torch.tanh(c)
    return h.float(), c.float()
