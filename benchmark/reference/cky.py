"""The CKY judge of parsed trees.

A DIORA parse picks, for every chart cell bottom-up, the split ``k`` that
maximises ``v_left + v_right + s_k`` with ``s_k`` the cell's split score
of the inside pass (its bilinear score plus its children's inside
scores); a cell's value is that maximum less ``max_k s_k``.  A tree's
value is therefore a constant less the sum over its internal nodes of
``max_k s_k(node) - s_k(node, its split)``, its *cost*, and the best
tree is the one of least cost.  The judge recomputes the split scores
from the weights and tokens and reports, for every tree, by how much its
cost exceeds the least: a tree that differs from the reference's only at
a near-tie reads about the rounding of the scores, a wrong tree reads
the score it gave up.
"""

from __future__ import annotations

import math
from typing import List

import numpy as np
import torch

from benchmark.reference import model
from benchmark.reference.precision import Precision


@torch.no_grad()
def split_costs(cfg, params, tokens: torch.Tensor,
                precision: str = "float32") -> List[np.ndarray]:
    """Each level's split costs ``max_k s_k - s_k``, (B, n - level, level)
    float64 on the host, of a text-only model's inside pass over
    ``tokens`` (B, n)."""
    P = Precision(precision)
    ep, dp = params["embed"], params["diora"]
    x_span = P.einsum("ble,de->bld", ep["embeddings"][tokens], ep["mat"])
    h0 = model.leaves(cfg, P, dp, x_span)
    _, _, levels = model.inside(cfg, P, dp, h0, with_scores=True)
    return [(s.amax(-1, keepdim=True) - s).double().cpu().numpy()
            for s in levels]


def least_costs(costs: List[np.ndarray], n: int) -> np.ndarray:
    """(B,) least tree cost of each sentence, by the CKY recursion."""
    B = costs[0].shape[0] if costs else 1
    best = [np.zeros((B, n))]
    for level in range(1, n):
        L = n - level
        cand = np.stack([best[k][:, :L] + best[level - k - 1][:, k + 1:k + 1 + L]
                         for k in range(level)], -1)
        best.append(np.min(cand + costs[level - 1], axis=-1))
    return best[n - 1][:, 0]


def tree_cost(costs: List[np.ndarray], b: int, tree, n: int) -> float:
    """Cost of ``tree`` (nested pairs over leaf indices ``0..n-1``) for
    sentence ``b``, or NaN where it is not a binary tree over the
    sentence's leaves in order."""
    total = 0.0
    expect = [0]

    def walk(node):
        nonlocal total
        if not isinstance(node, (tuple, list)):
            if node != expect[0]:
                raise ValueError("leaves out of order")
            expect[0] += 1
            return node, node
        if len(node) != 2:
            raise ValueError("not binary")
        lo, mid = walk(node[0])
        _, hi = walk(node[1])
        total += float(costs[hi - lo - 1][b, lo, mid - lo])
        return lo, hi

    try:
        span = walk(tree)
    except (ValueError, IndexError, TypeError, RecursionError):
        return math.nan
    if span != (0, n - 1) or expect[0] != n:
        return math.nan
    return total


def tree_gaps(cfg, params, tokens: torch.Tensor, trees, precision="float32",
              block: int = 64) -> np.ndarray:
    """Per sentence, the cost of its tree in ``trees`` over the least cost,
    recomputed in blocks of ``block`` sentences; infinite for a tree that
    is not one of the sentence."""
    B, n = tokens.shape
    out = np.full(B, np.inf)
    for lo in range(0, B, block):
        costs = split_costs(cfg, params, tokens[lo:lo + block], precision)
        least = least_costs(costs, n)
        for i in range(min(block, B - lo)):
            c = tree_cost(costs, i, trees[lo + i], n)
            if math.isfinite(c):
                out[lo + i] = c - least[i]
    return out


def best_trees(cfg, params, tokens: torch.Tensor, precision="float32",
               block: int = 64):
    """The least-cost tree of each sentence (first best split on ties), as
    nested pairs: what a parse in ``precision`` would return."""
    B, n = tokens.shape
    trees = []
    for lo in range(0, B, block):
        costs = split_costs(cfg, params, tokens[lo:lo + block], precision)
        Bb = costs[0].shape[0] if costs else min(block, B - lo)
        best = [np.zeros((Bb, n))]
        arg = [None]
        for level in range(1, n):
            L = n - level
            cand = np.stack(
                [best[k][:, :L] + best[level - k - 1][:, k + 1:k + 1 + L]
                 for k in range(level)], -1) + costs[level - 1]
            arg.append(np.argmin(cand, axis=-1))
            best.append(np.min(cand, axis=-1))

        def build(b, level, pos):
            if level == 0:
                return pos
            k = int(arg[level][b, pos])
            return (build(b, k, pos), build(b, level - k - 1, pos + k + 1))

        trees.extend(build(b, n - 1, 0) for b in range(Bb))
    return trees
