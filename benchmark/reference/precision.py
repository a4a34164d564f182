"""Arithmetic precision of the reference's matrix products.

``float32`` is the reference itself: f32 operands and sums (the caller
turns TF32 off).  The lower precisions are the controls of the check
that decides ``correct``: every operand of every product, and every
chart value stored, is rounded to the lower format, and the products
still sum in f32 -- what a later change to that format would compute.

* ``tf32``: 10 mantissa bits, round to nearest even (the tensor cores'
  f32 input format).
* ``bfloat16``: 8 significant bits.
* ``fp8``: float8 e4m3 with one scale a tensor (its largest magnitude
  onto e4m3's 448), as fp8 training scales.

Gradients pass through a rounding as through the identity.
"""

from __future__ import annotations

import torch

NAMES = ("float32", "tf32", "bfloat16", "fp8")
_E4M3_MAX = 448.0


def _tf32(x: torch.Tensor) -> torch.Tensor:
    bits = x.contiguous().view(torch.int32)
    # round to nearest even at bit 13, then clear the 13 low bits
    lsb = (bits >> 13) & 1
    bits = (bits + 0xFFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


def _fp8(x: torch.Tensor) -> torch.Tensor:
    scale = torch.clamp(x.abs().amax(), min=1e-30) / _E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class Precision:
    """Rounds product operands and stored chart values to one format."""

    def __init__(self, name: str = "float32"):
        if name not in NAMES:
            raise ValueError(f"precision {name!r}, expected one of {NAMES}")
        self.name = name

    def q(self, x: torch.Tensor) -> torch.Tensor:
        if self.name == "float32" or not x.is_floating_point():
            return x
        x32 = x.float()
        if self.name == "tf32":
            r = _tf32(x32.detach())
        elif self.name == "bfloat16":
            r = x32.detach().to(torch.bfloat16).float()
        else:
            r = _fp8(x32.detach())
        return x32 + (r - x32.detach())

    def einsum(self, pattern: str, a: torch.Tensor, b: torch.Tensor):
        return torch.einsum(pattern, self.q(a), self.q(b))

    def linear(self, p, x: torch.Tensor) -> torch.Tensor:
        return self.q(x) @ self.q(p["w"]).T + p["b"]
