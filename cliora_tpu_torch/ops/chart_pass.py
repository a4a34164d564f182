"""Plain PyTorch inside chart pass with the fused CKY decode.

Counterpart of ``inside_pass`` in cliora_tpu/ops/chart_pass.py for the
mlp compose: one gather / compose / score / softmax / aggregate /
scatter block per level over the flat ``(B, ncells, D)`` chart.  It is
the parse route for batches the fused kernel does not take (padded
``lengths``, hard aggregation, ``parse_impl='plain'``, a CPU device) and
the oracle of the whole chart.  (reference: the inside half of
cliora/net/diora.py:100-200,295-335; the CKY of
cliora/analysis/cky.py:31-99 and the max-normalizing hook of
cliora/analysis/utils.py:78-95, fused on device.)

The outside pass arrives with the training slice of the port.
"""

from __future__ import annotations

import torch

from cliora_tpu_torch.chart.indices import INDEX
from cliora_tpu_torch.chart.offsets import level_offsets, ncells
from cliora_tpu_torch.models.config import ModelConfig
from cliora_tpu_torch.ops.core import bilinear, compose_mlp, normalize


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


def inside_pass(cfg: ModelConfig, dp, h0: torch.Tensor,
                with_cky: bool = False):
    """Bottom-up pass.  ``h0``: (B, n, D) normalized leaf vectors.

    Returns ``(inside_h, inside_s, cky_bp, cky_val)``: the h chart
    (B, ncells, D) in the compute dtype, scores (B, ncells, 1) f32, and
    with ``with_cky`` the first-max backpointers (B, ncells) int32 and
    CKY values (B, ncells) f32 (``None`` otherwise).
    """
    B, n, D = h0.shape
    NC = ncells(n)
    offs = level_offsets(n)
    cdt = compute_dtype(cfg)
    dev = h0.device

    # h chart in the compute dtype; scores and softmaxes stay f32
    inside_h = torch.zeros((B, NC, D), dtype=cdt, device=dev)
    inside_h[:, :n] = h0.to(cdt)
    inside_s = torch.zeros((B, NC, 1), dtype=torch.float32, device=dev)
    cky_val = (torch.ones((B, NC), dtype=torch.float32, device=dev)
               if with_cky else None)
    cky_bp = (torch.zeros((B, NC), dtype=torch.int32, device=dev)
              if with_cky else None)

    cp = dp["inside_compose"]
    mat = dp["inside_score"]["mat"]

    for level in range(1, n):
        L, N = n - level, level
        idx_l, idx_r = INDEX.inside(n, level, dev)
        lh = inside_h[:, idx_l]                       # (B, L*N, D)
        rh = inside_h[:, idx_r]
        h = compose_mlp(cp, lh, rh, compute_dtype=cdt, out_dtype=cdt)

        s_bil = bilinear(mat, lh, rh, compute_dtype=cdt)   # (B, L*N)
        ls = inside_s[:, idx_l, 0]
        rs = inside_s[:, idx_r, 0]
        s = (s_bil + ls + rs).reshape(B, L, N)
        if cfg.aggregate == "hard":
            # greedy (S-DIORA-style): best split only
            p = torch.nn.functional.one_hot(
                torch.argmax(s, dim=-1), N).to(s.dtype)
        else:
            p = torch.softmax(s, dim=-1)               # over splits

        h_agg = torch.einsum("blnd,bln->bld", h.reshape(B, L, N, D),
                             p.to(cdt))
        s_agg = torch.sum(s * p, dim=-1)               # (B, L)
        h_agg = normalize(cfg.normalize, h_agg)

        off = int(offs[level])
        inside_h[:, off:off + L] = h_agg.to(cdt)
        inside_s[:, off:off + L, 0] = s_agg

        if with_cky:
            s_norm = s - torch.amax(s, dim=-1, keepdim=True)
            lv = cky_val[:, idx_l].reshape(B, L, N)
            rv = cky_val[:, idx_r].reshape(B, L, N)
            ps = lv + rv + s_norm
            cky_val[:, off:off + L] = torch.amax(ps, dim=-1)
            # torch.argmax returns the first maximal index: the
            # first-max tie rule of the JAX package
            cky_bp[:, off:off + L] = torch.argmax(ps, dim=-1).to(torch.int32)

    return inside_h, inside_s, cky_bp, cky_val
