"""Embed labeled phrases (conll entities) as [inside; outside] vectors and
print nearest-neighbour phrases by inner product.

The port's counterpart of cliora_tpu/scripts/phrase_embed.py.  The search
is exact, on the trainer's device (:func:`inner_product_search`); there
is no faiss route.  (reference: cliora/scripts/phrase_embed.py)
"""

from __future__ import annotations

import numpy as np
import torch

from cliora_tpu_torch.chart.offsets import level_offsets
from cliora_tpu_torch.scripts.common import (
    build_trainer,
    get_validation_dataset,
    get_validation_iterator,
)
from cliora_tpu_torch.utils.flags import argument_parser, parse_args
from cliora_tpu_torch.utils.observability import configure_experiment


def entity_cells(entity_labels, min_size: int = 2):
    """(batch_index, positions, sizes, labels) for every labeled span of
    size >= min_size (reference: phrase_embed.py:57-75,209-213)."""
    rows = []
    for i, lst in enumerate(entity_labels):
        for el in lst or []:
            if el is None:
                continue
            label, pos, size = el[0], el[1], el[2]
            if size >= min_size:
                rows.append((i, pos, size, label))
    if not rows:
        return [], [], [], []
    bi, pos, sizes, labels = zip(*rows)
    return list(bi), list(pos), list(sizes), list(labels)


def inner_product_search(vectors: np.ndarray, k: int, device):
    """Exact top-``k`` inner-product neighbours of every row among all
    rows: ``(scores, indices)``, each (N, min(k, N)), best first.  Equal
    scores keep the lower index first (a stable sort; ``torch.topk``
    leaves the order of ties unspecified)."""
    x = torch.as_tensor(vectors, device=device)
    scores = x @ x.T
    top, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    return top[:, :k].cpu().numpy(), idx[:, :k].cpu().numpy()


def run(options):
    validation_dataset = get_validation_dataset(options)
    validation_iterator = get_validation_iterator(options,
                                                  validation_dataset)
    word2idx = validation_dataset["word2idx"]
    idx2word = {v: k for k, v in word2idx.items()}

    trainer = build_trainer(options, validation_dataset["embeddings"])

    example_ids, phrases, inside, outside = [], [], [], []
    for batch_map in validation_iterator.get_iterator(
            random_seed=options.seed):
        length = batch_map["length"]
        if length <= 2:
            continue
        res, _ = trainer.parse(batch_map, outside=True, with_chart=True)
        real = batch_map.get("real_size", batch_map["batch_size"])
        bi, pos, sizes, labels = entity_cells(
            batch_map["entity_labels"][:real])
        if not bi:
            continue
        offs = level_offsets(length)
        cells = [int(offs[s - 1]) + p for p, s in zip(pos, sizes)]
        inside.append(res["inside_h"][bi, cells])
        outside.append(res["outside_h"][bi, cells])
        sents = batch_map["sentences"].tolist()
        for i, p, s in zip(bi, pos, sizes):
            example_ids.append(batch_map["example_ids"][i])
            phrases.append(tuple(sents[i][p:p + s]))

    vectors = np.concatenate(
        [np.concatenate(inside, 0), np.concatenate(outside, 0)], axis=1
    ).astype(np.float32)
    vectors /= np.maximum(
        np.linalg.norm(vectors, axis=1, keepdims=True), 1e-12)

    D, I = inner_product_search(vectors, options.k_candidates,
                                trainer.device)

    def stringify(phrase):
        return " ".join(idx2word[i] for i in phrase)

    for i in range(vectors.shape[0]):
        topk = []
        for j, score in zip(I[i], D[i]):
            if example_ids[i] == example_ids[j] or phrases[i] == phrases[j]:
                continue
            topk.append((j, score))
            if len(topk) == options.k_top:
                break
        print(f"[query] example_id={example_ids[i]} "
              f"phrase={stringify(phrases[i])}")
        for rank, (j, score) in enumerate(topk):
            print(f"rank={rank} score={score:.3f} "
                  f"example_id={example_ids[j]} "
                  f"phrase={stringify(phrases[j])}")
    return vectors


def main(args=None):
    parser = argument_parser()
    parser.add_argument("--k_candidates", default=100, type=int)
    parser.add_argument("--k_top", default=3, type=int)
    options = parse_args(parser, args)
    configure_experiment(options.experiment_path)
    return run(options)


if __name__ == "__main__":
    main()
