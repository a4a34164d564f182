"""Primitive ops of the chart passes (counterpart of cliora_tpu/ops/core.py).

Plain functions on tensors.  Parameters are nested dicts whose linear
weights use the torch ``(out_features, in_features)`` layout, the same
as the JAX package, so weights carry across without transposes.
"""

from __future__ import annotations

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


def bilinear(mat, a, b, compute_dtype=torch.float32) -> torch.Tensor:
    """Split-compatibility score ``s = a^T M b`` per row, f32 out.

    The intermediate ``a @ M`` projection is *stored* in the compute
    dtype before the second contraction, which takes compute-dtype
    operands and accumulates in f32 (the JAX package's ``lowp_einsum``
    contract).  (reference: cliora/net/diora.py:77-97 ``Bilinear``)
    """
    am = a.to(compute_dtype) @ mat.to(compute_dtype)
    return torch.sum(am.float() * b.to(compute_dtype).float(), dim=-1)
