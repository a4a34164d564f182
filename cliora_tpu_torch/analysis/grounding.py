"""Phrase-grounding evaluation: box IoU, Recall@1, CCRA.

The port's own copy of cliora_tpu/analysis/grounding.py: numpy host code
over the parse's ``atten_score`` rows (reference:
cliora/scripts/train.py:158-179, cliora/scripts/parse.py:174-212,236-267;
box IoU replaces torchvision.ops.box_iou, which the port does not need).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def box_iou(boxes1: np.ndarray, boxes2: np.ndarray) -> np.ndarray:
    """Pairwise IoU of (N, 4) x (M, 4) xyxy boxes -> (N, M)."""
    boxes1 = np.asarray(boxes1, dtype=np.float64)
    boxes2 = np.asarray(boxes2, dtype=np.float64)
    area1 = (boxes1[:, 2] - boxes1[:, 0]) * (boxes1[:, 3] - boxes1[:, 1])
    area2 = (boxes2[:, 2] - boxes2[:, 0]) * (boxes2[:, 3] - boxes2[:, 1])
    lt = np.maximum(boxes1[:, None, :2], boxes2[None, :, :2])
    rb = np.minimum(boxes1[:, None, 2:], boxes2[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    union = area1[:, None] + area2[None, :] - inter
    return inter / np.maximum(union, 1e-12)


def ground_phrases(
    atten_score: np.ndarray,     # (L, R) word x region scores, one example
    boxes: np.ndarray,           # (R, 4) candidate boxes
    phrases: Dict,               # {key: (start, end_exclusive, gt_box)}
    iou_thresh: float = 0.5,
) -> List[Tuple[Tuple[int, int], int]]:
    """Best-word -> argmax-region grounding for each GT phrase.

    Returns [((start, end_inclusive), correct01), ...].
    (reference: cliora/scripts/parse.py:186-212)
    """
    results = []
    for _, (start, end, gt_box) in phrases.items():
        word_scores = atten_score[start:end]          # (n_words, R)
        best_word = int(word_scores.max(axis=1).argmax())
        region = int(word_scores[best_word].argmax())
        pred_box = boxes[region]
        iou = box_iou(pred_box[None], np.asarray([gt_box]))
        correct = int(iou.max() > iou_thresh)
        results.append(((start, end - 1), correct))
    return results


class GroundingMeter:
    """Recall@1 and CCRA accumulators."""

    def __init__(self):
        self.total = 0
        self.recalled = 0
        self.ccr = 0

    def update(self, ground_res: Sequence[Tuple[Tuple[int, int], int]],
               pred_spans: Optional[set] = None):
        for (start, end), correct in ground_res:
            self.total += 1
            if correct:
                self.recalled += 1
                # CCRA: also require the phrase to be a predicted
                # constituent (single words count)
                if pred_spans is not None and (
                        start == end or (start, end) in pred_spans):
                    self.ccr += 1

    @property
    def recall(self) -> float:
        return self.recalled / (self.total + 1e-8)

    @property
    def ccra(self) -> float:
        return self.ccr / (self.total + 1e-8)


def span_pred_boxes(span_scores: np.ndarray, word_scores: np.ndarray,
                    boxes: np.ndarray, pred_spans, length: int):
    """Per predicted span, the argmax-region box of its best word.

    (reference: cliora/scripts/parse.py:236-256; ``span_scores`` kept for
    CLI parity -- the reference computes but does not use them either)
    """
    del span_scores
    out = []
    for (s, e) in pred_spans:
        word_atten = word_scores[s:e + 1]
        best_word = int(word_atten.max(axis=1).argmax())
        region = int(word_atten[best_word].argmax())
        out.append(boxes[region].tolist())
    return out
