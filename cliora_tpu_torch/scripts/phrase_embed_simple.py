"""Dump span representations [inside; outside] to vectors.csv/.npy.

The port's counterpart of cliora_tpu/scripts/phrase_embed_simple.py.
Modes: ``all-spans`` (whole chart), ``latent`` (CKY tree spans),
``given`` (gold trees from the data); the charts come from
``Trainer.parse(outside=True, with_chart=True)``.
(reference: cliora/scripts/phrase_embed_simple.py)
"""

from __future__ import annotations

import os

import numpy as np

from cliora_tpu_torch.analysis.eval import eval_batch_trees
from cliora_tpu_torch.analysis.trees import replace_leaves
from cliora_tpu_torch.chart.offsets import level_offsets
from cliora_tpu_torch.scripts.common import (
    build_trainer,
    get_validation_dataset,
    get_validation_iterator,
)
from cliora_tpu_torch.scripts.parse import postprocess
from cliora_tpu_torch.utils.flags import argument_parser, parse_args
from cliora_tpu_torch.utils.observability import (
    configure_experiment,
    get_logger,
)


def tree_to_pos_size(tree):
    """Internal-node (position, size) pairs of a nested tree
    (reference: phrase_embed_simple.py:142-156)."""
    spans = []

    def helper(tr, pos=0):
        if not isinstance(tr, (tuple, list)):
            return 1
        size = 0
        for node in tr:
            size += helper(node, pos + size)
        spans.append((pos, size))
        return size

    helper(tree)
    return spans


def run(options):
    logger = get_logger()
    validation_dataset = get_validation_dataset(options)
    validation_iterator = get_validation_iterator(options,
                                                  validation_dataset)
    word2idx = validation_dataset["word2idx"]
    idx2word = {v: k for k, v in word2idx.items()}

    trainer = build_trainer(options, validation_dataset["embeddings"])

    meta_path = os.path.abspath(
        os.path.join(options.experiment_path, "vectors.csv"))
    vec_path = os.path.abspath(
        os.path.join(options.experiment_path, "vectors.npy"))
    logger.info(f"Writing vectors to = {vec_path}")

    with open(meta_path, "w") as f_csv, open(vec_path, "ab") as f_vec:
        f_csv.write("example_id,position,size\n")
        for batch_map in validation_iterator.get_iterator(
                random_seed=options.seed):
            length = batch_map["length"]
            if length <= 2:
                continue
            res, _ = trainer.parse(batch_map, outside=True, with_chart=True)
            inside_h = res["inside_h"]
            outside_h = res["outside_h"]
            B = batch_map.get("real_size", batch_map["batch_size"])
            offs = level_offsets(length)

            if options.parse_mode == "all-spans":
                for bid in range(B):
                    ex = batch_map["example_ids"][bid]
                    for level in range(length):
                        for pos in range(length - level):
                            f_csv.write(f"{ex},{pos},{level + 1}\n")
                iv = inside_h[:B].reshape(-1, inside_h.shape[-1])
                ov = outside_h[:B].reshape(-1, outside_h.shape[-1])
            else:
                if options.parse_mode == "latent":
                    span_lists = []
                    for bid, (tree, _) in enumerate(eval_batch_trees(
                            res["cky_bp"][:B], length,
                            padded_length=batch_map.get("padded_length"))):
                        toks = [idx2word[i] for i in
                                batch_map["sentences"][bid].tolist()]
                        tr = replace_leaves(tree, toks)
                        if options.postprocess:
                            tr = postprocess(tr, toks)
                        span_lists.append(tree_to_pos_size(tr))
                else:  # 'given'
                    span_lists = [tree_to_pos_size(t)
                                  for t in batch_map["trees"]]

                batch_index, cell_index = [], []
                for bid, spans in enumerate(span_lists):
                    ex = batch_map["example_ids"][bid]
                    for pos, size in spans:
                        f_csv.write(f"{ex},{pos},{size}\n")
                        batch_index.append(bid)
                        cell_index.append(int(offs[size - 1]) + pos)
                iv = inside_h[batch_index, cell_index]
                ov = outside_h[batch_index, cell_index]

            np.savetxt(f_vec, np.concatenate([iv, ov], axis=1))


def main(args=None):
    parser = argument_parser()
    parser.add_argument("--parse_mode", default="latent",
                        choices=("all-spans", "latent", "given"))
    options = parse_args(parser, args)
    configure_experiment(options.experiment_path)
    run(options)


if __name__ == "__main__":
    main()
