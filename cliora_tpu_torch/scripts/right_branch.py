"""Right-branching baseline F1; runs no model.

The port's counterpart of cliora_tpu/scripts/right_branch.py
(reference: cliora/scripts/right_branch.py).
"""

from __future__ import annotations

import numpy as np

from cliora_tpu_torch.scripts.common import (
    get_validation_dataset,
    get_validation_iterator,
)
from cliora_tpu_torch.utils.flags import argument_parser, parse_args


def run(options):
    validation_dataset = get_validation_dataset(options)
    validation_iterator = get_validation_iterator(options,
                                                  validation_dataset)
    corpus = [0.0, 0.0, 0.0]
    sent_f1 = []
    for batch_map in validation_iterator.get_iterator(
            random_seed=options.seed):
        length = batch_map["length"]
        if length < 2:
            continue
        for bid in range(batch_map.get("real_size",
                                       batch_map["batch_size"])):
            gold_spans = set(batch_map["GT"][bid][:-1])
            pred_spans = {(i, length - 1) for i in range(1, length - 1)}
            # the reference scores right-branching spans as all-recalled
            # (scripts/right_branch.py:37): tp=|gold|, fn=0
            tp = len(gold_spans)
            fp = len(pred_spans) - tp
            corpus[0] += tp
            corpus[1] += fp

            overlap = pred_spans & gold_spans
            prec = len(overlap) / (len(pred_spans) + 1e-8)
            reca = len(overlap) / (len(gold_spans) + 1e-8)
            if len(gold_spans) == 0:
                reca = 1.0
                if len(pred_spans) == 0:
                    prec = 1.0
            sent_f1.append(2 * prec * reca / (prec + reca + 1e-8))

    tp, fp, fn = corpus
    prec = tp / (tp + fp)
    recall = tp / (tp + fn) if tp + fn else 0.0
    corpus_f1 = (2 * prec * recall / (prec + recall)
                 if prec + recall > 0 else 0.0)
    print(f"corpus_f1:{corpus_f1} \t sent_f1:{np.mean(sent_f1)}")
    return corpus_f1


def main(args=None):
    options = parse_args(argument_parser(), args)
    return run(options)


if __name__ == "__main__":
    main()
