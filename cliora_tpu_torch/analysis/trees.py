"""Tree utilities: backpointer decoding, span extraction, F1 stats.

The port's own copy of cliora_tpu/analysis/trees.py.  The device-side
CKY emits one ``(B, ncells)`` int32 backpointer array; these helpers turn
its rows into nested-tuple trees and span lists on the host, and score
predicted spans against gold ones.

Span convention follows the reference eval: ``(left, right)`` with *both
indices inclusive* (cliora/analysis/utils.py:29-49 ``get_spans``).
"""

from __future__ import annotations

import re

import numpy as np

from cliora_tpu_torch import native

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
    # the first cell of each level in the flat level-major layout
    # (chart/offsets.py:level_offsets; not imported, so that a serving
    # host that only decodes loads none of the model's modules)
    rem = n - np.arange(n)
    offs = n * (n + 1) // 2 - rem * (rem + 1) // 2
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


def get_actions(tree_str, SHIFT=0, REDUCE=1, OPEN="(", CLOSE=")"):
    """Bracketed string -> shift/reduce action sequence.

    Tokenizes into brackets and words, then maps each word to SHIFT and
    each closing bracket to REDUCE (binary trees: one fewer reduce than
    shifts).  Behavior matches cliora/analysis/utils.py:3-26.
    """
    brackets = re.escape(OPEN) + re.escape(CLOSE)
    symbols = re.findall(rf"[{brackets}]|[^\s{brackets}]+", tree_str)
    actions = [SHIFT if sym != CLOSE else REDUCE
               for sym in symbols if sym != OPEN]
    n_reduce = sum(1 for a in actions if a == REDUCE)
    assert len(actions) == 2 * n_reduce + 1, tree_str
    return actions


def get_spans(actions, SHIFT=0, REDUCE=1):
    """Actions -> merged spans in reduce order, inclusive indices.

    Runs the shift-reduce machine over (start, end) pairs directly: a
    shift pushes the next leaf as a unit span, a reduce merges the top
    two.  Behavior matches cliora/analysis/utils.py:29-49.
    """
    spans = []
    stack = []
    n_leaves = 0
    for action in actions:
        if action == SHIFT:
            stack.append((n_leaves, n_leaves))
            n_leaves += 1
        else:
            (start, _), (_, end) = stack[-2], stack[-1]
            del stack[-2:]
            spans.append((start, end))
            stack.append((start, end))
    return spans


def get_stats(pred_spans, gold_spans):
    """(tp, fp, fn) between two span collections.

    (reference: cliora/analysis/utils.py:52-64)
    """
    tp = fp = fn = 0
    for span in pred_spans:
        if span in gold_spans:
            tp += 1
        else:
            fp += 1
    for span in gold_spans:
        if span not in pred_spans:
            fn += 1
    return tp, fp, fn


def sent_f1(pred_spans, gold_spans):
    """Per-sentence span F1 (reference: cliora/scripts/train.py:195-204)."""
    pred, gold = set(pred_spans), set(gold_spans)
    overlap = pred & gold
    prec = len(overlap) / (len(pred) + 1e-8)
    reca = len(overlap) / (len(gold) + 1e-8)
    if len(gold) == 0:
        reca = 1.0
        if len(pred) == 0:
            prec = 1.0
    return 2 * prec * reca / (prec + reca + 1e-8)


class F1Meter:
    """Corpus-level micro F1 accumulator."""

    def __init__(self):
        self.tp = self.fp = self.fn = 0
        self.sent = []

    def update(self, pred_spans, gold_spans):
        tp, fp, fn = get_stats(pred_spans, gold_spans)
        self.tp += tp
        self.fp += fp
        self.fn += fn
        self.sent.append(sent_f1(pred_spans, gold_spans))

    @property
    def corpus_f1(self):
        prec = self.tp / max(self.tp + self.fp, 1)
        reca = self.tp / max(self.tp + self.fn, 1)
        if prec + reca == 0:
            return 0.0
        return 2 * prec * reca / (prec + reca)

    @property
    def sent_f1(self):
        return float(np.mean(self.sent)) if self.sent else 0.0


def spans_to_tree(spans, tokens):
    """(pos, size) span list -> nested tuple over ``tokens``.

    Missing single-token spans are filled in.
    (reference: cliora/analysis/diora_tree.py:1-42)
    """
    length = len(tokens)
    have = {span[0] for span in spans if span[1] == 1}
    spans = list(spans) + [(pos, 1) for pos in range(length)
                           if pos not in have]
    spans.sort(key=lambda x: (x[1], x[0]))

    pos_to_node = {}
    for pos, size in spans:
        if size == 1:
            pos_to_node[pos] = (pos, 1, tokens[pos])
            continue
        node = (pos, size, [])
        for i_pos in range(pos, pos + size):
            child = pos_to_node[i_pos]
            if i_pos == child[0]:
                node[2].append(child)
            pos_to_node[i_pos] = node

    def helper(node):
        _, _, payload = node
        if not isinstance(payload, list):
            return payload
        return tuple(helper(x) for x in payload)

    return helper(pos_to_node[0])
