"""Inference / evaluation entry point: CKY parse + grounding + CCRA,
writing ``parse.jsonl``.

The port's counterpart of cliora_tpu/scripts/parse.py; it runs on the
card unless ``--device cpu`` is given.
(reference: cliora/scripts/parse.py)
"""

from __future__ import annotations

import collections
import importlib.util
import json
import os

import numpy as np

from cliora_tpu_torch.analysis.eval import eval_batch_trees
from cliora_tpu_torch.analysis.grounding import (
    GroundingMeter,
    ground_phrases,
    span_pred_boxes,
)
from cliora_tpu_torch.analysis.trees import F1Meter, replace_leaves
from cliora_tpu_torch.scripts.common import (
    build_trainer,
    get_validation_dataset,
    get_validation_iterator,
)
from cliora_tpu_torch.utils.flags import (
    argument_parser,
    parse_args,
    save_flags,
)
from cliora_tpu_torch.utils.observability import (
    configure_experiment,
    get_logger,
)

PUNCTUATION = {x.lower() for x in [
    ".", ",", ":", "-LRB-", "-RRB-", "''", "``", "--", ";", "-", "?",
    "!", "...", "-LCB-", "-RCB-"]}


def remove_using_flat_mask(tree, mask):
    """Drop masked leaves from a nested tree
    (reference: parse.py:24-49)."""
    kept, removed = [], []

    def func(tr, pos=0):
        if not isinstance(tr, (list, tuple)):
            if not mask[pos]:
                removed.append(tr)
                return None, 1
            kept.append(tr)
            return tr, 1
        size, node = 0, []
        for subtree in tr:
            x, xsize = func(subtree, pos=pos + size)
            if x is not None:
                node.append(x)
            size += xsize
        if len(node) == 1:
            node = node[0]
        elif len(node) == 0:
            return None, size
        return node, size

    new_tree, _ = func(tree)
    return new_tree, kept, removed


def postprocess(tree, tokens=None):
    """Detach a trailing punctuation token (reference: parse.py:63-79)."""
    if tokens is None:
        def flatten(tr):
            if not isinstance(tr, (list, tuple)):
                return [tr]
            return [x for sub in tr for x in flatten(sub)]
        tokens = flatten(tree)
    if str(tokens[-1]).lower() not in PUNCTUATION:
        return tree
    mask = [True] * (len(tokens) - 1) + [False]
    tree, kept, removed = remove_using_flat_mask(tree, mask)
    assert len(kept) == len(tokens) - 1
    assert len(removed) == 1
    return (tree, tokens[-1])


def run(options, region_features=None):
    """Parse the validation set into ``parse.jsonl`` and return its
    metrics.  ``region_features``: the Flickr test split's ``(features,
    bboxes, pos_bboxes)`` arrays in place of its HDF5 file."""
    logger = get_logger()
    if options.arch == "word":
        # the JAX script fails on the missing ``cky_bp`` of this arch
        raise ValueError("--arch word parses no trees: it is a grounding "
                         "baseline (train.py's eval reports its grounding)")
    if options.visualize and importlib.util.find_spec("cv2") is None:
        raise ImportError("--visualize needs cv2 (opencv-python)")
    validation_dataset = get_validation_dataset(options)
    validation_iterator = get_validation_iterator(
        options, validation_dataset, region_features=region_features)
    word2idx = validation_dataset["word2idx"]
    embeddings = validation_dataset["embeddings"]
    idx2word = {v: k for k, v in word2idx.items()}

    logger.info("Initializing model.")
    trainer = build_trainer(options, embeddings)

    output_path = os.path.abspath(
        os.path.join(options.experiment_path, "parse.jsonl"))
    logger.info(f"Writing output to = {output_path}")

    f1 = F1Meter()
    grounding = GroundingMeter()
    loss_sums = collections.defaultdict(float)
    num_batches = 0

    with open(output_path, "w") as fout:
        for batch_map in validation_iterator.get_iterator(
                random_seed=options.seed):
            length = batch_map["length"]
            if length <= 2:
                continue
            res, metrics = trainer.parse(batch_map, compute_loss=True,
                                         outside=True)
            for k, v in metrics.items():
                loss_sums[k] += v
            num_batches += 1

            real = batch_map.get("real_size", batch_map["batch_size"])
            trees_spans = eval_batch_trees(
                res["cky_bp"][:real], length,
                padded_length=batch_map.get("padded_length"))
            boxes = np.asarray(batch_map["boxes"])

            if options.visualize and "atten_score" in res:
                from cliora_tpu_torch.analysis.visualize import (
                    visualize_batch,
                )
                visualize_batch(
                    res["atten_score"][:real],
                    batch_map["sentences"][:real],
                    batch_map["example_ids"][:real], boxes, idx2word,
                    img_root=options.img_root)

            batch_ground_res = None
            if "atten_score" in res:
                batch_ground_res = []
                for bid in range(real):
                    phrases, _ = batch_map["VG_GT"][bid]
                    batch_ground_res.append(ground_phrases(
                        res["atten_score"][bid], boxes[bid], phrases))

            for bid, (tree, pred_spans) in enumerate(trees_spans):
                gold_spans = set(batch_map["GT"][bid][:-1])
                f1.update(pred_spans, gold_spans)

                pred_boxes = []
                if "span_scores" in res:
                    pred_boxes = span_pred_boxes(
                        res["span_scores"][bid], res["atten_score"][bid],
                        boxes[bid], pred_spans, length)

                if batch_ground_res is not None:
                    grounding.update(batch_ground_res[bid], pred_spans)

                example_id = batch_map["example_ids"][bid]
                tokens = [idx2word[i] for i in
                          batch_map["sentences"][bid].tolist()]
                tree_words = replace_leaves(tree, tokens)
                if options.postprocess:
                    tree_words = postprocess(tree_words, tokens)
                # attribution: the decode routes can break near-tie
                # backpointers differently (Trainer.parse), so published
                # trees carry the route that produced them
                record = collections.OrderedDict(
                    example_id=str(example_id), tree=tree_words,
                    tree_index_conll=tree, sentence=tokens,
                    gold_spans=list(gold_spans),
                    pred_spans=list(pred_spans),
                    pred_boxes=pred_boxes,
                    parse_impl=res["parse_impl"])
                fout.write(json.dumps(record) + "\n")

    print(f"corpus_f1:{f1.corpus_f1} \t sent_f1:{f1.sent_f1} \t "
          f"grounding acc:{grounding.recall} \t ccra:{grounding.ccra}")
    n = max(num_batches, 1)
    print("recon_loss: {} ; vg_loss: {}; contr_loss: {}; total_loss: {}"
          .format(loss_sums["reconstruction_softmax_loss"] / n,
                  loss_sums["vg_loss"] / n,
                  loss_sums["contrastive_loss"] / n,
                  loss_sums["total_loss"] / n))
    return {"corpus_f1": f1.corpus_f1, "sent_f1": f1.sent_f1,
            "grounding_acc": grounding.recall, "ccra": grounding.ccra}


def main(args=None, region_features=None):
    options = parse_args(argument_parser(), args)
    configure_experiment(options.experiment_path)
    save_flags(options, options.experiment_path)
    return run(options, region_features)


if __name__ == "__main__":
    main()
