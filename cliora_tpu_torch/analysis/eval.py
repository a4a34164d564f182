"""Validation-loop evaluation: parse F1 + phrase grounding.

The port's counterpart of cliora_tpu/analysis/eval.py (reference:
cliora/scripts/train.py:119-219 ``run_eval``), in one process or
spread over a trainer's data-parallel group.  Its ``ccra``
is computed after the decode, with each row's predicted spans, as the
JAX package's parse script does (cliora_tpu/scripts/parse.py:135-146);
the JAX ``run_eval`` updates its grounding meter without them, so its
``ccra`` is always 0.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch.distributed as dist

from cliora_tpu_torch.analysis.grounding import GroundingMeter, ground_phrases
from cliora_tpu_torch.analysis.trees import (
    F1Meter,
    decode_batch,
    tree_to_spans,
)
from cliora_tpu_torch.parallel.mesh import is_multiprocess


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
    iterator.

    ``iterator.get_iterator(random_seed=seed)`` yields batch maps with
    ``sentences``, ``length`` (the true length; the longest one of a
    ragged batch), ``batch_size``, optionally ``real_size``, per-row
    ``lengths`` and the chart layout ``padded_length``, gold ``GT`` spans
    and, for grounding, ``VG_GT`` phrases, ``boxes`` and ``obj_feats``.
    Sentences of length <= 2 are skipped, per batch and per row of a
    ragged batch, matching the reference (scripts/train.py:153-154).

    Under a trainer's dp mesh of more than one rank every rank sees the
    whole (unchunked) validation iterator, parses every world-th
    evaluable batch, and the raw counters are summed across the group
    (cliora_tpu/analysis/eval.py:56-64,103-121); the per-sentence F1s
    are gathered in batch order, so every rank returns the one-process
    metrics exactly.  Under tensor parallelism the mp ranks of one dp row
    parse the same batches together (the parse is a collective over the
    mp group) and the counters are summed over the dp group.  All ranks
    must call it together.
    """
    mesh = getattr(trainer, "mesh", None)
    rank, world = (0, 1) if mesh is None else (mesh.rank, mesh.size)
    f1 = F1Meter()
    grounding = GroundingMeter()
    sent_by_batch = {}

    k = -1
    for batch_map in iterator.get_iterator(random_seed=seed):
        length = batch_map["length"]
        if length <= 2:
            continue
        k += 1
        if k % world != rank:
            continue
        n_sent = len(f1.sent)
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
        sent_by_batch[k] = f1.sent[n_sent:]

    if is_multiprocess(mesh):
        _reduce_counters(f1, grounding, sent_by_batch, mesh)
    return {
        "corpus_f1": f1.corpus_f1,
        "sent_f1": f1.sent_f1,
        "grounding_acc": grounding.recall,
        "ccra": grounding.ccra,
    }


def right_branching_f1(iterator, seed: int = 11) -> Dict[str, float]:
    """corpus_f1 / sent_f1 of right-branching trees over the rows
    :func:`run_eval` scores, with its scorer: sentences of length <= 2
    skipped, the root span dropped from both sides.  The baseline a
    grammar-induction run must beat on the same split.
    (scripts/right_branch.py keeps the reference's count, which takes every
    gold span as recalled and so reads corpus F1 1.0 by construction.)"""
    f1 = F1Meter()
    for batch_map in iterator.get_iterator(random_seed=seed):
        length = batch_map["length"]
        gt = batch_map.get("GT")
        if length <= 2 or gt is None:
            continue
        real = batch_map.get("real_size", batch_map["batch_size"])
        lens = batch_map.get("lengths")
        lens = (np.full(real, length, np.int32) if lens is None
                else np.asarray(lens[:real], np.int32))
        for bid in range(real):
            n = int(lens[bid])
            if n <= 2:
                continue
            tree = n - 1
            for i in range(n - 2, -1, -1):
                tree = (i, tree)
            f1.update(set(tree_to_spans(tree)[:-1]), set(gt[bid][:-1]))
    return {"corpus_f1": f1.corpus_f1, "sent_f1": f1.sent_f1}


def _reduce_counters(f1, grounding, sent_by_batch, mesh):
    """Sum the raw counters over the group into ``f1`` and ``grounding``
    and put every rank's per-sentence F1s in batch order (one object
    all-gather)."""
    mine = (f1.tp, f1.fp, f1.fn, grounding.total, grounding.recalled,
            grounding.ccr, sent_by_batch)
    every = [None] * mesh.size
    dist.all_gather_object(every, mine, group=mesh.group)
    f1.tp, f1.fp, f1.fn, grounding.total, grounding.recalled, \
        grounding.ccr = (sum(x[i] for x in every) for i in range(6))
    by_batch = {k: v for x in every for k, v in x[6].items()}
    f1.sent = [s for k in sorted(by_batch) for s in by_batch[k]]
