"""Text-only parse/eval (no grounding block).

The port's counterpart of cliora_tpu/scripts/parse_diora.py.  On the card
the batches of a DIORA model decode through the fused inside+CKY kernel
(K1, ``Trainer.parse``'s ``cuda`` route); ``--device cpu`` takes the
plain chart pass.  (reference: cliora/scripts/parse_diora.py)
"""

from __future__ import annotations

import collections
import json
import os

from cliora_tpu_torch.analysis.eval import eval_batch_trees
from cliora_tpu_torch.analysis.trees import F1Meter, replace_leaves
from cliora_tpu_torch.scripts.common import (
    build_trainer,
    get_validation_dataset,
    get_validation_iterator,
)
from cliora_tpu_torch.scripts.parse import postprocess
from cliora_tpu_torch.utils.flags import (
    argument_parser,
    parse_args,
    save_flags,
)
from cliora_tpu_torch.utils.observability import (
    configure_experiment,
    get_logger,
)


def run(options):
    logger = get_logger()
    if options.arch == "word":
        # the JAX script fails on the missing ``cky_bp`` of this arch
        raise ValueError("--arch word parses no trees: it is a grounding "
                         "baseline (train.py's eval reports its grounding)")
    validation_dataset = get_validation_dataset(options)
    validation_iterator = get_validation_iterator(options,
                                                  validation_dataset)
    word2idx = validation_dataset["word2idx"]
    idx2word = {v: k for k, v in word2idx.items()}

    logger.info("Initializing model.")
    trainer = build_trainer(options, validation_dataset["embeddings"])

    output_path = os.path.abspath(
        os.path.join(options.experiment_path, "parse.jsonl"))
    logger.info(f"Writing output to = {output_path}")

    f1 = F1Meter()
    with open(output_path, "w") as fout:
        for batch_map in validation_iterator.get_iterator(
                random_seed=options.seed):
            length = batch_map["length"]
            if length <= 2:
                continue
            res, _ = trainer.parse(batch_map, compute_loss=False,
                                   outside=False)
            real = batch_map.get("real_size", batch_map["batch_size"])
            for bid, (tree, pred_spans) in enumerate(
                    eval_batch_trees(res["cky_bp"][:real], length,
                                     batch_map.get("padded_length"))):
                gold_spans = set(batch_map["GT"][bid][:-1])
                f1.update(pred_spans, gold_spans)
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
                    parse_impl=res["parse_impl"])
                fout.write(json.dumps(record) + "\n")

    print(f"corpus_f1:{f1.corpus_f1} \t sent_f1:{f1.sent_f1}")
    return {"corpus_f1": f1.corpus_f1, "sent_f1": f1.sent_f1}


def main(args=None):
    options = parse_args(argument_parser(), args)
    configure_experiment(options.experiment_path)
    save_flags(options, options.experiment_path)
    return run(options)


if __name__ == "__main__":
    main()
