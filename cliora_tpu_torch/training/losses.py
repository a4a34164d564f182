"""Training losses: reconstruction, word-level visual grounding (InfoNCE),
and span-level contrastive grounding (counterpart of
cliora_tpu/training/losses.py).

Functions of the forward outputs; the loss parameters live in the main
parameter tree (``params['reconstruct']``).
(reference: cliora/net/trainer.py:25-201)
"""

from __future__ import annotations

import torch

from cliora_tpu_torch.chart.indices import INDEX
from cliora_tpu_torch.models.diora import table_rows

MIN_VAL = 1e-8


def word_mask(lengths: torch.Tensor, L: int) -> torch.Tensor:
    """(B, L) bool: position < true sentence length."""
    return (torch.arange(L, device=lengths.device)[None]
            < lengths[:, None])


def valid_cell_mask(n: int, lengths: torch.Tensor) -> torch.Tensor:
    """(B, ncells(n)) bool: the cell's span lies inside ``[0, m)``, i.e.
    the chart value at this cell is meaningful for an example of true
    length ``m`` (pad cells hold garbage in padded length buckets)."""
    lev, pos = INDEX.coords(n, lengths.device)
    return pos + lev + 1 <= lengths[:, None]


def contrastive_cell_mask(n: int, lengths: torch.Tensor) -> torch.Tensor:
    """(B, ncells(n)) bool: cells of the padded chart that the reference's
    half-chart contrastive slice would cover at each true length ``m``.

    The reference sums over the first ``ncells(m)//2`` cells of the exact
    length-``m`` chart (cliora/net/trainer.py:125 ``[:span_length//2]``);
    in the padded layout that is: cell valid (``pos+level+1 <= m``) and
    its *true-chart* level-major rank ``level*m - level(level-1)/2 + pos``
    below ``(m(m+1)/2)//2``.
    """
    lev, pos = INDEX.coords(n, lengths.device)
    m = lengths[:, None].to(torch.int64)                  # (B, 1)
    valid = pos + lev + 1 <= m
    rank = lev * m - lev * (lev - 1) // 2 + pos
    half = (m * (m + 1) // 2) // 2
    return valid & (rank < half)


def root_cell_index(n: int, lengths: torch.Tensor) -> torch.Tensor:
    """(B,) flat index of the true root cell (level ``m-1``, pos 0)."""
    return INDEX.offsets(n, lengths.device)[lengths.to(torch.int64) - 1]


def reconstruction_loss(recon_params, embed_table: torch.Tensor,
                        tokens: torch.Tensor, neg_samples: torch.Tensor,
                        outside_h: torch.Tensor, lengths=None):
    """Masked-word reconstruction with sampled-softmax CE.

    Each leaf's *outside* vector must prefer the true word over ``k``
    corpus-sampled negatives (negatives shared batch-wide).
    (reference: cliora/net/trainer.py:46-78)

    Args:
      recon_params: {'mat': (D, E)} projection.
      embed_table: (V, E) word embedding matrix.
      tokens: (B, L) int ids.
      neg_samples: (k,) int ids, distinct, one draw per batch.
      outside_h: (B, ncells, D) outside chart; leaves are cells [0, L).
      lengths: (B,) true lengths for padded buckets; pad positions are
        excluded from the mean.
    """
    B, L = tokens.shape
    mat = recon_params["mat"]
    # a bf16 chart against f32 projections: f32, as JAX promotes
    cell = outside_h[:, :L].float()                       # (B, L, D)
    proj_pos = table_rows(embed_table, tokens) @ mat.T    # (B, L, D)
    proj_neg = table_rows(embed_table, neg_samples) @ mat.T   # (k, D)

    xp = torch.einsum("bld,bld->bl", proj_pos, cell)[..., None]  # (B, L, 1)
    xn = torch.einsum("kd,bld->blk", proj_neg, cell)             # (B, L, k)
    score = torch.cat([xp, xn], dim=-1)                   # (B, L, 1+k)
    # cross-entropy with target index 0
    per_word = torch.logsumexp(score, dim=-1) - score[..., 0]    # (B, L)
    if lengths is None:
        return torch.mean(per_word)
    mask = word_mask(lengths, L)
    return torch.sum(per_word * mask) / torch.sum(mask)


def _vg_logits(phrase_region_max: torch.Tensor, lengths):
    """(B, B) mean-over-words logits; word axis masked by the *text*
    example's true length when padded."""
    L = phrase_region_max.shape[2]
    if lengths is None:
        return torch.sum(phrase_region_max, dim=-1) / L
    mask = word_mask(lengths, L)[:, None, :]              # (B_text, 1, L)
    return (torch.sum(phrase_region_max * mask, dim=-1)
            / lengths[:, None].float())


def vg_loss_from_scores(phrase_region_max: torch.Tensor,
                        alpha_vg: float = 1.0, lengths=None):
    """As :func:`vg_loss` but from pre-reduced (B, B, L) best-region
    scores (see ops/span_region.py for the fused reduction)."""
    logits = _vg_logits(phrase_region_max, lengths)
    logZ = torch.logsumexp(logits, dim=1)
    return alpha_vg * torch.mean(logZ - torch.diagonal(logits))


def vg_loss(vg_atten_score: torch.Tensor, alpha_vg: float = 1.0,
            lengths=None):
    """Word-level visual-grounding InfoNCE across the batch.

    (reference: cliora/net/trainer.py:131-171; its "V1" variant)

    Args:
      vg_atten_score: (B, B, L, R) word x region scores for every
        (sentence, image) pair in the batch.
      lengths: (B,) true lengths; pad words excluded from each text's
        mean-over-words logit.
    """
    return vg_loss_from_scores(torch.amax(vg_atten_score, dim=-1),
                               alpha_vg, lengths)


def _contrastive_from_cell_scores(ins, outs, scores, margin, alpha_contr,
                                  lengths):
    """Shared tail of the contrastive variants.

    ``scores``: (B_t, B_i, NC) best-region score per (text, image, cell).
    """
    B, NC = ins.shape
    scores = scores.permute(2, 0, 1)                      # (NC, B_t, B_i)
    diag = torch.diagonal(scores, dim1=-2, dim2=-1)       # (NC, B)
    d1 = diag[:, :, None]                 # own-image score per text
    d2 = diag[:, None, :]                 # own-text score per image

    eye = torch.eye(B, dtype=torch.bool, device=ins.device)[None]
    drop_txt = drop_img = eye
    mask = None
    n = int(round(((8 * NC + 1) ** 0.5 - 1) / 2))
    if lengths is not None:
        # a (cell, text) pair whose cell is a pad cell for *that text*
        # holds a garbage span score: exclude it from BOTH hinge
        # directions (cliora_tpu/training/losses.py:153-166)
        mask = contrastive_cell_mask(n, lengths)          # (B, NC)
        invalid_t = ~valid_cell_mask(n, lengths).T[:, :, None]   # (NC, B_t, 1)
        drop_txt = eye | invalid_t
        drop_img = eye | invalid_t
    # the "hinge" clamps at MIN_VAL, and the diagonal is zeroed after
    zero = torch.zeros((), dtype=scores.dtype, device=scores.device)
    loss_txt = torch.clamp(margin + scores - d1, min=MIN_VAL)
    loss_img = torch.clamp(margin + scores - d2, min=MIN_VAL)
    loss_txt = torch.where(drop_txt, zero, loss_txt).mean(dim=2)  # (NC, B_t)
    loss_img = torch.where(drop_img, zero, loss_img).mean(dim=1)  # (NC, B_i)
    vl_loss = (loss_txt + loss_img).T                     # (B, NC)

    if lengths is None:
        span_margs = torch.exp(ins + outs - ins[:, -1:])  # (B, NC)
        loss_mat = span_margs * vl_loss
        return alpha_contr * torch.mean(
            torch.sum(loss_mat[:, : NC // 2], dim=-1))

    # padded buckets: marginals renormalize against the true root, and
    # the half-chart slice becomes a per-example cell mask.  The exponent
    # is masked BEFORE exp so garbage pad-cell scores can't overflow.
    root_s = torch.gather(ins, 1, root_cell_index(n, lengths)[:, None])
    span_margs = torch.exp(torch.where(mask, ins + outs - root_s,
                                       zero)) * mask
    return alpha_contr * torch.mean(torch.sum(span_margs * vl_loss, dim=-1))


def contrastive_loss_from_scores(inside_s, outside_s, scores,
                                 margin: float = 0.2,
                                 alpha_contr: float = 1.0, lengths=None):
    """As :func:`contrastive_loss` but from pre-reduced (B, B, ncells)
    best-region scores (see ops/span_region.py)."""
    return _contrastive_from_cell_scores(
        inside_s[..., 0], outside_s[..., 0], scores, margin, alpha_contr,
        lengths)


def contrastive_loss(inside_s, outside_s, all_atten_score,
                     margin: float = 0.2, alpha_contr: float = 1.0,
                     lengths=None):
    """Span-level contrastive grounding, weighted by span marginals.

    Hinge on best-region scores vs. the matched (diagonal) pair in both
    text->image and image->text directions; each span's hinge is weighted
    by exp(inside_s + outside_s - root_s) and only the first half of the
    chart cells (the shorter spans) contribute.
    (reference: cliora/net/trainer.py:81-128.  Parity notes: the "hinge"
    clamps at MIN_VAL=1e-8, not 0, and the diagonal is zeroed *after*
    clamping.)

    Args:
      inside_s / outside_s: (B, ncells, 1) chart score channels.
      all_atten_score: (B_text, B_img, ncells, R).
      lengths: (B,) true lengths for padded buckets (see
        :func:`contrastive_cell_mask`).
    """
    return contrastive_loss_from_scores(
        inside_s, outside_s, torch.amax(all_atten_score, dim=-1), margin,
        alpha_contr, lengths)
