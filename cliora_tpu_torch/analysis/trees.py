"""Tree utilities: backpointer decoding and span extraction.

The port's own copy of the decode half of cliora_tpu/analysis/trees.py.
The device-side CKY emits one ``(B, ncells)`` int32 backpointer array;
these helpers turn its rows into nested-tuple trees and span lists on
the host.

Span convention follows the reference eval: ``(left, right)`` with *both
indices inclusive* (cliora/analysis/utils.py:29-49 ``get_spans``).
"""

from __future__ import annotations

import numpy as np

from cliora_tpu_torch import native
from cliora_tpu_torch.chart.offsets import level_offsets

# Which decoder ran the last ``decode_batch`` call in this process:
# "native" (the C decoder) or "python" (no C toolchain to build it).
last_decoder = None


def bp_to_tree(n: int, bp_row, length=None):
    """Backpointer row -> nested tuple of leaf indices.

    ``bp_row[cell(level, pos)]`` = chosen split k: left child (k, pos),
    right child (level-k-1, pos+k+1).  ``length`` decodes a sentence of
    true length ``m <= n`` from a padded length-``n`` chart (root at cell
    ``(m-1, 0)``; every cell under it is valid).
    """
    offs = level_offsets(n)
    bp_row = np.asarray(bp_row)
    m = n if length is None else int(length)

    def build(level, pos):
        if level == 0:
            return int(pos)
        k = int(bp_row[offs[level] + pos])
        return (build(k, pos), build(level - k - 1, pos + k + 1))

    return build(m - 1, 0)


def decode_batch(bp, n, lengths=None):
    """(B, ncells) CKY backpointers -> list of (tree, spans) per row.

    Spans are inclusive ``(l, r)`` pairs in post-order (root last), the
    :func:`tree_to_spans` contract.  The whole batch goes to the C
    decoder (native/_fasttrees.c) when it builds; otherwise the python
    loop below, which is also the parity oracle
    (tests/test_torch_trees.py).  ``last_decoder`` records which ran.
    """
    global last_decoder
    bp = np.ascontiguousarray(bp, dtype=np.int32)
    mod = native.load()
    if mod is not None:
        lens = (None if lengths is None
                else np.ascontiguousarray(lengths, dtype=np.int32))
        trees, spans = mod.decode_batch(bp, n, lens)
        last_decoder = "native"
        return list(zip(trees, spans))
    out = []
    lengths = None if lengths is None else np.asarray(lengths)
    for b, row in enumerate(bp):
        m = None if lengths is None else int(lengths[b])
        tree = bp_to_tree(n, row, length=m)
        out.append((tree, tree_to_spans(tree)))
    last_decoder = "python"
    return out


def tree_to_spans(tree):
    """All internal-node spans of a nested-tuple tree, inclusive indices.

    Includes the root span (callers drop it for F1, as the reference does
    with ``[:-1]`` slicing, cliora/scripts/train.py:187-189).
    """
    spans = []

    def helper(tr):
        if not isinstance(tr, (tuple, list)):
            return (tr, tr)
        left = helper(tr[0])
        right = helper(tr[1])
        span = (left[0], right[1])
        spans.append(span)
        return span

    helper(tree)
    return spans


def tree_to_string(tree, words=None):
    """Nested tuple -> bracketed string ``((a b) c)``."""
    def helper(tr):
        if not isinstance(tr, (tuple, list)):
            return str(words[tr]) if words is not None else str(tr)
        return "(" + " ".join(helper(x) for x in tr) + ")"
    return helper(tree)


def replace_leaves(tree, leaves):
    """Relabel leaf indices with tokens (reference: scripts/parse.py:82-98)."""
    def helper(tr, pos=0):
        if not isinstance(tr, (tuple, list)):
            return 1, leaves[pos]
        out, sofar = [], 0
        for node in tr:
            size, new = helper(node, pos + sofar)
            sofar += size
            out.append(new)
        return sofar, tuple(out)
    return helper(tree)[1]
