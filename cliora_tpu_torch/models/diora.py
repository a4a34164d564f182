"""Text-only DIORA forward (counterpart of cliora_tpu/models/diora.py).

(reference: cliora/net/diora.py:205-471)  The CLIORA variant (region
attention at the leaves and every level, span x region scores) and the
outside pass come with later slices of the port.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from cliora_tpu_torch.models.config import ModelConfig
from cliora_tpu_torch.ops.chart_pass import inside_pass
from cliora_tpu_torch.ops.core import leaf_mlp, normalize


class InsideChart(NamedTuple):
    inside_h: torch.Tensor             # (B, ncells, D) compute dtype
    inside_s: torch.Tensor             # (B, ncells, 1) f32
    cky_bp: Optional[torch.Tensor]     # (B, ncells) int32
    cky_val: Optional[torch.Tensor]    # (B, ncells) f32


def embed_forward(ep, token_ids: torch.Tensor):
    """Token ids -> (emb_span, emb_word), each (B, L, D).

    (reference: cliora/net/trainer.py:219-224 ``Embed.forward``)
    """
    emb = ep["embeddings"][token_ids]                  # (B, L, E)
    return emb @ ep["mat"].T, emb @ ep["mat1"].T


def embed_span(ep, token_ids: torch.Tensor) -> torch.Tensor:
    """``emb_span`` of ``embed_forward`` alone, (B, L, D): the text parse
    reads no word embeddings."""
    return ep["embeddings"][token_ids] @ ep["mat"].T


def leaf_transform(cfg: ModelConfig, dp, x_span: torch.Tensor):
    """DIORA leaf vectors ``norm(tanh(leaf_fc(x)))``, (B, L, D) f32.

    (reference: cliora/net/diora.py:58-63,283-292)
    """
    return normalize(cfg.normalize, leaf_mlp(dp["inside_compose"], x_span))


def diora_forward(cfg: ModelConfig, params, x_span: torch.Tensor,
                  with_cky: bool = True,
                  outside: Optional[bool] = False) -> InsideChart:
    """Leaf transform + inside pass (+ fused CKY) for text-only DIORA.

    ``outside=None`` follows ``cfg.outside``; the outside pass is not
    ported yet and raises.
    """
    run_outside = cfg.outside if outside is None else outside
    if run_outside:
        raise NotImplementedError(
            "the outside pass comes with the training slice of the port")
    dp = params["diora"]
    h0 = leaf_transform(cfg, dp, x_span)
    return InsideChart(*inside_pass(cfg, dp, h0, with_cky=with_cky))
