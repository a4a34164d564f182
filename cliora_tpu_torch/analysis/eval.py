"""Validation-loop evaluation: parse F1 + phrase grounding.

The port's counterpart of cliora_tpu/analysis/eval.py, single process
(reference: cliora/scripts/train.py:119-219 ``run_eval``).  Its ``ccra``
is computed after the decode, with each row's predicted spans, as the
JAX package's parse script does (cliora_tpu/scripts/parse.py:135-146);
the JAX ``run_eval`` updates its grounding meter without them, so its
``ccra`` is always 0.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from cliora_tpu_torch.analysis.grounding import GroundingMeter, ground_phrases
from cliora_tpu_torch.analysis.trees import F1Meter, decode_batch


def eval_batch_trees(bp: np.ndarray, length: int, padded_length=None):
    """Backpointer rows -> (tree, pred_span_set) per example; the root span
    is dropped for F1, as the reference does
    (scripts/train.py:187-189).  ``padded_length`` decodes from a padded
    length-bucket chart (layout ``padded_length``, root at ``length``)."""
    n = padded_length or length
    lengths = np.full(len(bp), length, dtype=np.int32)
    return [(tree, set(spans[:-1]))
            for tree, spans in decode_batch(bp, n, lengths)]


def run_eval(trainer, iterator, seed: int = 11,
             use_obj: bool = False) -> Dict[str, float]:
    """corpus_f1 / sent_f1 / grounding recall / CCRA over a validation
    iterator, in one process.

    ``iterator.get_iterator(random_seed=seed)`` yields batch maps with
    ``sentences``, ``length`` (the true length; the longest one of a
    ragged batch), ``batch_size``, optionally ``real_size``, per-row
    ``lengths`` and the chart layout ``padded_length``, gold ``GT`` spans
    and, for grounding, ``VG_GT`` phrases, ``boxes`` and ``obj_feats``.
    Sentences of length <= 2 are skipped, per batch and per row of a
    ragged batch, matching the reference (scripts/train.py:153-154).
    """
    dist = torch.distributed
    if (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1):
        raise NotImplementedError(
            "run_eval across processes: the distributed counter reduction "
            "is not ported yet; evaluate in one process")
    f1 = F1Meter()
    grounding = GroundingMeter()

    for batch_map in iterator.get_iterator(random_seed=seed):
        length = batch_map["length"]
        if length <= 2:
            continue
        res, _ = trainer.parse(batch_map, compute_loss=False,
                               outside=use_obj)
        real = batch_map.get("real_size", batch_map["batch_size"])
        # ragged (mixed-bucket) batches carry per-example lengths;
        # uniform batches share the scalar true length
        lens = batch_map.get("lengths")
        lens = (np.full(real, length, np.int32) if lens is None
                else np.asarray(lens[:real], np.int32))
        ground = use_obj and "atten_score" in res
        # F1 needs gold spans; plain-text/jsonl corpora carry none
        # (scripts/train.py:185-189), so eval then reports losses-only 0s
        gt = batch_map.get("GT")
        decoded = None
        if "cky_bp" in res and (gt is not None or ground):
            n = batch_map.get("padded_length") or length
            decoded = decode_batch(res["cky_bp"][:real], n, lens)
        boxes = np.asarray(batch_map["boxes"]) if ground else None

        for bid in range(real):
            if lens[bid] <= 2:
                continue  # reference skip, per row when ragged
            # drop the root span (train.py:187)
            pred_spans = (None if decoded is None
                          else set(decoded[bid][1][:-1]))
            if ground:
                phrases, _noun_mask = batch_map["VG_GT"][bid]
                if phrases:
                    grounding.update(
                        ground_phrases(res["atten_score"][bid], boxes[bid],
                                       phrases),
                        pred_spans)
            if pred_spans is not None and gt is not None:
                f1.update(pred_spans, set(gt[bid][:-1]))

    return {
        "corpus_f1": f1.corpus_f1,
        "sent_f1": f1.sent_f1,
        "grounding_acc": grounding.recall,
        "ccra": grounding.ccra,
    }
