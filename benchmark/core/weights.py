"""A configuration's initial weights, made on the device from the seed.

The tree is the program's (``models/params.py``): the embedding table
and its two projections, the shared mlp compose with its leaf transform,
the split score matrix, the outside root vector, the reconstruction
projection and, for a CLIORA model, the two region encoders.  Every leaf
is N(0, 1), as the program documents, but where the configuration names
another scale: the region encoders, which the program starts at zero
(``img_encoder_init_std``; zero there would make every region score
equal), and the split score matrix (``score_init_std``).  One
``torch.randn`` on a generator seeded with ``--seed`` draws them all, in
this order; each leaf is then its own tensor.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch


def shapes(cfg: Dict) -> List[Tuple[str, tuple, float]]:
    """``(path, shape, std)`` of every leaf, in the program's tree order."""
    D, E, V = cfg["size"], cfg["input_size"], cfg["vocab_size"]
    out = [("embed/embeddings", (V, E), 1.0), ("embed/mat", (D, E), 1.0),
           ("embed/mat1", (D, E), 1.0),
           ("diora/inside_compose/fc0/w", (D, 2 * D), 1.0),
           ("diora/inside_compose/fc0/b", (D,), 1.0),
           ("diora/inside_compose/fc1/w", (D, D), 1.0),
           ("diora/inside_compose/fc1/b", (D,), 1.0),
           ("diora/inside_compose/leaf_fc/w", (D, D), 1.0),
           ("diora/inside_compose/leaf_fc/b", (D,), 1.0),
           ("diora/inside_score/mat", (D, D),
            float(cfg.get("score_init_std", 1.0))),
           ("diora/root_vector_out_h", (D,), 1.0),
           ("reconstruct/mat", (D, E), 1.0)]
    if cfg["use_obj"]:
        F, s = cfg["obj_feat_size"], cfg["img_encoder_init_std"]
        out += [("img_encoder/fc/w", (D, F), s), ("img_encoder/fc/b", (D,), s),
                ("img_encoder/fc_vis/w", (D, F), s),
                ("img_encoder/fc_vis/b", (D,), s)]
    return out


def unflatten(flat: Dict[str, torch.Tensor]) -> Dict:
    tree: Dict = {}
    for path, t in flat.items():
        node = tree
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = t
    return tree


def make(cfg: Dict, seed: int, device) -> Dict:
    """The parameter tree of ``cfg`` drawn from ``seed`` on ``device``."""
    leaves = shapes(cfg)
    total = sum(torch.Size(s).numel() for _, s, _ in leaves)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    draw = torch.randn(total, generator=gen, device=device)
    flat, at = {}, 0
    for path, shape, std in leaves:
        size = torch.Size(shape).numel()
        flat[path] = (draw[at:at + size] * std).reshape(shape).clone()
        at += size
    return unflatten(flat)
