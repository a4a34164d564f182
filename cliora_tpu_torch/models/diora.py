"""DIORA / CLIORA forward passes (counterpart of cliora_tpu/models/diora.py).

One code path serves both: ``cfg.use_obj`` selects the CLIORA variant
(visual residuals at the leaves and every inside level, plus the
span x region and word x region attention scores).
(reference: cliora/net/diora.py:205-471, cliora/net/cliora.py:213-488)
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from cliora_tpu_torch.models.config import ModelConfig
from cliora_tpu_torch.ops.chart_pass import InsideOut, run_chart
from cliora_tpu_torch.ops.core import (
    leaf_mlp,
    linear,
    normalize,
    region_attention,
)
from cliora_tpu_torch.parallel.sharding import mp_slice, reduce_from_mp


class DioraOutput(NamedTuple):
    chart: InsideOut
    # CLIORA attention scores (None for text-only DIORA):
    all_atten_score: Optional[torch.Tensor]   # (B, B, ncells, R)
    vg_atten_score: Optional[torch.Tensor]    # (B, B, L, R)
    atten_score: Optional[torch.Tensor]       # (B, L, R) per-example diagonal


def table_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` as ``F.embedding``: the same rows, and a backward
    that sums a repeated id's gradients in a fixed order.  (The backward
    of ``table[ids]`` on the CPU adds them in thread order, so two runs
    of one train step could differ in the last bit.)"""
    return torch.nn.functional.embedding(ids, table)


def embed_forward(ep, token_ids: torch.Tensor, trainable: bool = True,
                  mp=None):
    """Token ids -> (emb_span, emb_word), each (B, L, D).

    ``trainable=False`` stops the gradient at the embedding table.
    (reference: cliora/net/trainer.py:219-224 ``Embed.forward``)
    Tensor parallel (``mp``: the table and both projections cut on E):
    the rank's E slice of each row, projected, the partial projections
    all-reduced.
    """
    table = ep["embeddings"] if trainable else ep["embeddings"].detach()
    emb = table_rows(table, token_ids)                  # (B, L, E)
    return (reduce_from_mp(emb @ ep["mat"].T, mp),
            reduce_from_mp(emb @ ep["mat1"].T, mp))


def embed_span(ep, token_ids: torch.Tensor, mp=None) -> torch.Tensor:
    """``emb_span`` of ``embed_forward`` alone, (B, L, D): the text parse
    reads no word embeddings."""
    return reduce_from_mp(table_rows(ep["embeddings"], token_ids)
                          @ ep["mat"].T, mp)


def image_encoder_forward(ip, obj_feats: torch.Tensor, mp=None):
    """Region features (B, R, F) -> (span-branch, word-branch) embeddings,
    each (B, R, D) f32.  (reference: cliora/net/utils.py:52-55)
    Tensor parallel (``mp``: both maps cut on F): the rank's F slice of
    the features, projected, the partial projections all-reduced, then
    the biases."""
    obj_feats = obj_feats.float()
    if mp is None:
        return linear(ip["fc"], obj_feats), linear(ip["fc_vis"], obj_feats)
    x = mp_slice(obj_feats, mp)
    return tuple(reduce_from_mp(x @ ip[k]["w"].T, mp) + ip[k]["b"]
                 for k in ("fc", "fc_vis"))


def leaf_transform(cfg: ModelConfig, dp, x_span: torch.Tensor,
                   obj_span: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None,
                   train: bool = False):
    """Leaf vectors for the inside chart: ``(h, c)``, each (B, L, D) f32.

    DIORA:  h = norm(tanh(leaf_fc(x)))  (diora.py:58-63,283-292)
    CLIORA: h = norm(norm(tanh(leaf_fc(x))) + attend(., obj))
            (cliora.py:71-80,290-301); the leaf attention runs in f32, as
            in the JAX package.
    TreeLSTM: also the leaf cell c = norm(tanh(leaf_fc_c(x))); c is
    ``None`` for the mlp arch.  (cliora_tpu/models/diora.py:55-79)
    """
    cp = dp["inside_compose"]
    h = leaf_mlp(cp, x_span)
    if cfg.use_obj:
        h = normalize(cfg.normalize, h)
        cxt = region_attention(h, obj_span, temp=cfg.attn_temp,
                               dropout=cfg.attn_dropout,
                               generator=generator, train=train)
        h = h + cxt
    h = normalize(cfg.normalize, h)
    c = None
    if cfg.arch == "treelstm":
        c = normalize(cfg.normalize, torch.tanh(linear(cp["leaf_fc_c"],
                                                       x_span)))
    return h, c


def diora_forward(cfg: ModelConfig, params, x_span: torch.Tensor,
                  x_word: Optional[torch.Tensor] = None,
                  obj_span: Optional[torch.Tensor] = None,
                  obj_word: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None,
                  train: bool = True, with_cky: bool = False,
                  outside: Optional[bool] = None,
                  with_all_atten: bool = True,
                  materialize_atten: bool = True,
                  lengths: Optional[torch.Tensor] = None,
                  mp=None) -> DioraOutput:
    """Run the full inside-outside recursion (+ CLIORA attention scores).

    Args:
      x_span / x_word: (B, L, D) projected word embeddings (span / word
        branches of ``Embed``).
      obj_span / obj_word: (B, R, D) projected region features.
      generator: draws the attention dropout (``train`` only).
      outside: override ``cfg.outside`` (the reference toggles it at
        eval, scripts/train.py:130).
      with_all_atten: materialize the B^2 span x region score (needed
        for the contrastive loss and eval).
      materialize_atten: ``False`` in training skips the B^2 tensors:
        the fused span x region reductions (ops/span_region.py) compute
        the losses from the chart instead.
      lengths: (B,) true sentence lengths for padded length buckets.
      mp: the mesh whose mp group cuts the compose and score weights on
        D (parallel/sharding.py ``TensorParallel.hidden``), or None.
    """
    dp = params["diora"]
    run_outside = cfg.outside if outside is None else outside

    h0, c0 = leaf_transform(cfg, dp, x_span, obj_span=obj_span,
                            generator=generator, train=train)
    chart = run_chart(cfg, dp, h0, c0=c0, obj=obj_span, generator=generator,
                      train=train, with_cky=with_cky, outside=run_outside,
                      lengths=lengths, mp=mp)

    if not cfg.use_obj or (train and not materialize_atten):
        return DioraOutput(chart, None, None, None)
    B, L = x_span.shape[0], x_span.shape[1]
    ih = chart.inside_h
    span_vec = ih + chart.outside_h if run_outside else ih
    all_atten = None
    if with_all_atten:
        # (reference: cliora/net/cliora.py:457 -- every chart cell of every
        # sentence scored against every image's regions); a bf16 chart
        # times f32 regions is f32, as JAX promotes
        all_atten = torch.einsum("and,crd->acnr", span_vec.float(), obj_span)
    if train:
        # (cliora.py:459-461)
        vg_atten = torch.einsum("ald,crd->aclr", x_word, obj_word)
    else:
        # (cliora.py:462-464)
        vg_word = torch.einsum("ald,crd->aclr",
                               normalize(cfg.normalize, x_word), obj_word)
        if with_all_atten:
            vg_atten = all_atten[:, :, :L] + vg_word
        else:
            word_span = torch.einsum("ald,ard->alr", span_vec[:, :L].float(),
                                     obj_span)
            ar = torch.arange(B, device=x_span.device)
            vg_atten = vg_word.clone()
            vg_atten[ar, ar] += word_span
    # per-example diagonal (cliora.py:466)
    ar = torch.arange(B, device=x_span.device)
    return DioraOutput(chart, all_atten, vg_atten, vg_atten[ar, ar])
