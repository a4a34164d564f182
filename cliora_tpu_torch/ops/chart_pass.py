"""Plain PyTorch inside / outside chart passes (counterpart of
cliora_tpu/ops/chart_pass.py for the mlp compose).

One gather / compose / score / softmax / aggregate block per level over
the flat level-major ``(B, ncells, D)`` chart.  (reference:
cliora/net/diora.py:100-200,295-401 and cliora/net/cliora.py:103-208,
304-414; the CKY of cliora/analysis/cky.py:31-99 and the max-normalizing
hook of cliora/analysis/utils.py:78-95, fused on device.)

Both passes are differentiable: each level's outputs are new tensors,
and the chart a level reads is the concatenation of the levels below it
(a prefix of the flat chart, since the layout is level-major), so no
tensor autograd saved is ever written in place.  The inside pass is the
parse route for batches the fused kernel does not take (padded
``lengths``, hard aggregation, ``parse_impl='plain'``, a CPU device)
and the oracle of the whole chart; with the outside pass it is the
train step's chart.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from cliora_tpu_torch.chart.indices import INDEX
from cliora_tpu_torch.chart.offsets import level_offsets, ncells
from cliora_tpu_torch.models.config import ModelConfig
from cliora_tpu_torch.ops.core import (
    bilinear,
    compose_mlp,
    lowp_einsum,
    normalize,
    region_attention,
)

MASK_NEG = -1e9  # finite -inf stand-in: keeps masked-softmax grads NaN-free


class InsideOut(NamedTuple):
    inside_h: torch.Tensor              # (B, ncells, D) compute dtype
    inside_s: torch.Tensor              # (B, ncells, 1) f32
    outside_h: Optional[torch.Tensor]   # (B, ncells, D) compute dtype
    outside_s: Optional[torch.Tensor]   # (B, ncells, 1) f32
    cky_bp: Optional[torch.Tensor]      # (B, ncells) int32 argmax split
    cky_val: Optional[torch.Tensor]     # (B, ncells) f32 CKY values


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


def _weighted_agg(pattern: str, h, p):
    """Softmax-weighted aggregation in the chart dtype: with bf16 charts
    ``dh`` comes back in bf16 and only ``dp`` accumulates f32
    (cliora_tpu/ops/chart_pass.py:156-168)."""
    return lowp_einsum(pattern, h, p, h.dtype, h.dtype)


def _aggregate_weights(cfg: ModelConfig, s, dim: int):
    if cfg.aggregate == "hard":
        # greedy (S-DIORA-style): best split only
        idx = torch.argmax(s, dim=dim, keepdim=True)
        return torch.zeros_like(s).scatter_(dim, idx, 1.0)
    return torch.softmax(s, dim=dim)


def inside_pass(cfg: ModelConfig, dp, h0: torch.Tensor, obj=None,
                generator: Optional[torch.Generator] = None,
                train: bool = False, with_cky: bool = False):
    """Bottom-up pass.  ``h0``: (B, n, D) normalized leaf vectors;
    ``obj``: (B, R, D) region embeddings of a CLIORA model.

    Returns ``(inside_h, inside_s, cky_bp, cky_val)``: the h chart
    (B, ncells, D) in the compute dtype, scores (B, ncells, 1) f32, and
    with ``with_cky`` the first-max backpointers (B, ncells) int32 and
    CKY values (B, ncells) f32 (``None`` otherwise).
    """
    B, n, D = h0.shape
    cdt = compute_dtype(cfg)
    dev = h0.device
    if obj is not None:
        obj = obj.to(cdt)           # cast once, not per level

    # h chart in the compute dtype; scores and softmaxes stay f32
    hs = [h0.to(cdt)]
    ss = [torch.zeros((B, n), dtype=torch.float32, device=dev)]
    vals = [torch.ones((B, n), dtype=torch.float32, device=dev)]
    bps = [torch.zeros((B, n), dtype=torch.int32, device=dev)]

    cp = dp["inside_compose"]
    mat = dp["inside_score"]["mat"]

    for level in range(1, n):
        L, N = n - level, level
        idx_l, idx_r = INDEX.inside(n, level, dev)
        chart_h, chart_s = torch.cat(hs, 1), torch.cat(ss, 1)
        lh = chart_h[:, idx_l]                          # (B, L*N, D)
        rh = chart_h[:, idx_r]
        h = compose_mlp(cp, lh, rh, compute_dtype=cdt, out_dtype=cdt)

        s_bil = bilinear(mat, lh, rh, compute_dtype=cdt)   # (B, L*N)
        s = (s_bil + chart_s[:, idx_l] + chart_s[:, idx_r]).reshape(B, L, N)
        p = _aggregate_weights(cfg, s, -1)              # over splits

        h_agg = _weighted_agg("blnd,bln->bld", h.reshape(B, L, N, D), p)
        s_agg = torch.sum(s * p, dim=-1)                # (B, L)
        h_agg = normalize(cfg.normalize, h_agg)
        if cfg.use_obj:
            # visual residual per level (reference: cliora.py:140-157)
            cxt = region_attention(
                h_agg, obj, temp=cfg.attn_temp, dropout=cfg.attn_dropout,
                generator=generator, train=train, compute_dtype=cdt)
            h_agg = normalize(cfg.normalize, h_agg + cxt)
        hs.append(h_agg.to(cdt))
        ss.append(s_agg)

        if with_cky:
            s_d = s.detach()
            chart_v = torch.cat(vals, 1)
            ps = (chart_v[:, idx_l] + chart_v[:, idx_r]).reshape(B, L, N) \
                + (s_d - torch.amax(s_d, dim=-1, keepdim=True))
            vals.append(torch.amax(ps, dim=-1))
            # torch.argmax returns the first maximal index: the
            # first-max tie rule of the JAX package
            bps.append(torch.argmax(ps, dim=-1).to(torch.int32))

    inside_h = torch.cat(hs, 1)
    inside_s = torch.cat(ss, 1)[..., None]
    if not with_cky:
        return inside_h, inside_s, None, None
    return inside_h, inside_s, torch.cat(bps, 1), torch.cat(vals, 1)


def _outside_masks(level: int, n: int, lengths: torch.Tensor):
    """Per-example validity masks at ``level`` for padded length buckets.

    ``combo_ok (B, N, L)``: the (parent, sibling) derivation's parent span
    lies inside ``[0, m)``.  ``target_ok (B, L)``: the target is a valid
    *non-root* cell -- the true root (level ``m-1``, pos 0) keeps its
    init value.  (cliora_tpu/ops/chart_pass.py:298-316)
    """
    L = n - level
    N = L - 1
    dev = lengths.device
    m = lengths[:, None]                                   # (B, 1)
    p = torch.arange(L, dtype=torch.int64, device=dev)[None, :]   # (1, L)
    c = torch.arange(N, dtype=torch.int64, device=dev)[:, None]   # (N, 1)
    j = p + level + 1                                      # exclusive end
    par_end = torch.where(c < p, j.expand(N, L), j + c - p + 1)
    combo_ok = par_end[None] <= m[..., None]               # (B, N, L)
    target_ok = (j <= m) & (level < m - 1)                 # (B, L)
    return combo_ok, target_ok


def outside_pass(cfg: ModelConfig, dp, inside_h: torch.Tensor,
                 inside_s: torch.Tensor,
                 lengths: Optional[torch.Tensor] = None):
    """Top-down pass mirroring :func:`inside_pass`.

    Parent states come from the *outside* chart, sibling states from the
    *inside* chart; compose input order is [sibling; parent] and the
    derivation softmax runs over the N parent/sibling combinations
    (reference: cliora/net/diora.py:152-200,337-376).

    ``lengths`` (B,) int enables padded length buckets: a sentence of
    true length ``m <= n`` has its root vector planted at the true root
    cell ``(m-1, 0)``, derivations whose parent leaves ``[0, m)`` are
    masked out of the combo softmax, and invalid and root cells keep
    their prior values.  Returns ``(outside_h, outside_s)``.
    """
    B, NC, D = inside_h.shape
    n = int(round(((8 * NC + 1) ** 0.5 - 1) / 2))      # invert ncells
    assert ncells(n) == NC
    offs = level_offsets(n)
    cdt = compute_dtype(cfg)
    dev = inside_h.device

    cp = dp.get("outside_compose", dp["inside_compose"])
    mat = dp.get("outside_score", dp["inside_score"])["mat"]

    # root initialization (reference: cliora/net/diora.py:337-356), at
    # the true per-example root cell when padded
    if lengths is None:
        root_in = inside_h[:, -1]                       # (B, D)
    else:
        lengths = lengths.to(device=dev, dtype=torch.int64)
        root_cell = INDEX.offsets(n, dev)[lengths - 1]      # (B,)
        root_in = inside_h[torch.arange(B, device=dev), root_cell]
    if cfg.compress:
        # a bf16 chart row times the f32 matrix: f32, as JAX promotes
        root_h = root_in.float() @ dp["root_mat_out"]
    else:
        root_h = dp["root_vector_out_h"].reshape(1, D).expand(B, D)
    root_h = normalize(cfg.normalize, root_h).to(cdt)

    # levels[level] = (h (B, L, D), s (B, L)) of the outside chart; the
    # chart a level reads is the concatenation of the levels above it
    levels = [None] * n
    if lengths is None:
        levels[n - 1] = (root_h[:, None],
                         torch.zeros((B, 1), dtype=torch.float32, device=dev))
    else:
        # the top cell of a padded sentence is a pad cell: it holds the
        # root vector only where m == n; everyone's true root is planted
        # into its own level below, as that level's prior value
        is_top = (lengths == n)[:, None]
        levels[n - 1] = (torch.where(is_top[..., None], root_h[:, None],
                                     torch.zeros((), dtype=cdt, device=dev)),
                         torch.zeros((B, 1), dtype=torch.float32, device=dev))
        root_level = lengths - 1                        # (B,)

    for level in range(n - 2, -1, -1):
        L = n - level
        N = L - 1
        par_idx, sis_idx = INDEX.outside(n, level, dev)
        # outside chart from this level's parents up: cells >= offs[level+1]
        above_h = torch.cat([levels[lv][0] for lv in range(level + 1, n)], 1)
        above_s = torch.cat([levels[lv][1] for lv in range(level + 1, n)], 1)
        base = int(offs[level + 1])
        ph = above_h[:, par_idx - base]                  # (B, N*L, D)
        sh = inside_h[:, sis_idx]
        h = compose_mlp(cp, sh, ph, compute_dtype=cdt, out_dtype=cdt)

        s_bil = bilinear(mat, sh, ph, compute_dtype=cdt)    # (B, N*L)
        s = (s_bil + inside_s[:, sis_idx, 0]
             + above_s[:, par_idx - base]).reshape(B, N, L)
        if lengths is not None:
            combo_ok, target_ok = _outside_masks(level, n, lengths)
            s = torch.where(combo_ok, s, torch.full((), MASK_NEG, device=dev))
        p = _aggregate_weights(cfg, s, 1)               # over combos

        h_agg = _weighted_agg("bnld,bnl->bld", h.reshape(B, N, L, D), p)
        s_agg = torch.sum(s * p, dim=1)                 # (B, L)
        h_agg = normalize(cfg.normalize, h_agg).to(cdt)

        if lengths is not None:
            # invalid targets and the true root keep their prior values:
            # zero, or the root vector at the root cell (its gradient
            # must reach the root vector / compress matrix)
            prior_h = torch.where(
                (root_level == level)[:, None, None]
                & (torch.arange(L, device=dev) == 0)[None, :, None],
                root_h[:, None], torch.zeros((), dtype=cdt, device=dev))
            h_agg = torch.where(target_ok[..., None], h_agg, prior_h)
            s_agg = torch.where(target_ok, s_agg,
                                torch.zeros((), device=dev))
        levels[level] = (h_agg, s_agg)

    outside_h = torch.cat([levels[lv][0] for lv in range(n)], 1)
    outside_s = torch.cat([levels[lv][1] for lv in range(n)], 1)[..., None]
    return outside_h, outside_s


def run_chart(cfg: ModelConfig, dp, h0: torch.Tensor, obj=None,
              generator: Optional[torch.Generator] = None,
              train: bool = False, with_cky: bool = False,
              outside: bool = True,
              lengths: Optional[torch.Tensor] = None) -> InsideOut:
    """Inside pass (+ CKY) and, with ``outside``, the outside pass.

    Padded length buckets need no inside mask: inside values of valid
    cells depend only on valid cells.
    """
    inside_h, inside_s, bp, val = inside_pass(
        cfg, dp, h0, obj=obj, generator=generator, train=train,
        with_cky=with_cky)
    outside_h = outside_s = None
    if outside:
        outside_h, outside_s = outside_pass(cfg, dp, inside_h, inside_s,
                                            lengths=lengths)
    return InsideOut(inside_h, inside_s, outside_h, outside_s, bp, val)
