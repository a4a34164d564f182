"""Word-level grounding baseline: no chart; words are scored against
regions directly.  (counterpart of cliora_tpu/models/word_grounding.py;
reference: cliora/net/vg.py ``DioraMLP.forward``:477-482, a DIORA clone
whose forward only computes the word x region attention)
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class WordGroundingOutput(NamedTuple):
    vg_atten_score: torch.Tensor      # (B, B, L, R)
    atten_score: torch.Tensor         # (B, L, R) per-example diagonal


def word_grounding_forward(x_word: torch.Tensor,
                           obj_word: torch.Tensor) -> WordGroundingOutput:
    """x_word: (B, L, D) word-branch embeddings; obj_word: (B, R, D)."""
    vg = torch.einsum("ald,crd->aclr", x_word, obj_word)
    ar = torch.arange(x_word.shape[0], device=x_word.device)
    return WordGroundingOutput(vg, vg[ar, ar])
