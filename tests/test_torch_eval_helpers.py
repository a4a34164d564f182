"""The port's host-side eval helpers against the JAX package's on seeded
inputs: the F1 half of ``analysis/trees.py``, all of
``analysis/grounding.py`` and ``analysis/eval.py:eval_batch_trees``.  Both
sides are numpy and Python; nothing here compiles."""

import numpy as np
import pytest

from cliora_tpu.analysis import eval as jeval
from cliora_tpu.analysis import grounding as jg
from cliora_tpu.analysis import trees as jtrees
from cliora_tpu_torch.analysis import eval as teval
from cliora_tpu_torch.analysis import grounding as tg
from cliora_tpu_torch.analysis import trees as ttrees

SEEDS = [0, 1, 2, 3]


def _random_tree(rs, lo, hi):
    if lo == hi:
        return lo
    k = rs.randint(lo, hi)
    return (_random_tree(rs, lo, k), _random_tree(rs, k + 1, hi))


def _span_sets(rs, n):
    """Two span sets of one sentence: a random tree's, and a random
    subset of all spans (so hits, misses and empty sets all occur)."""
    pred = set(jtrees.tree_to_spans(_random_tree(rs, 0, n - 1))[:-1])
    every = [(i, j) for i in range(n) for j in range(i + 1, n)]
    gold = {s for s in every if rs.rand() < 0.3}
    return pred, gold


def _boxes(rs, n):
    lo = rs.uniform(0, 60, (n, 2))
    return np.concatenate([lo, lo + rs.uniform(1, 40, (n, 2))], 1)


@pytest.mark.parametrize("seed", SEEDS)
def test_actions_and_spans_match_jax(seed):
    rs = np.random.RandomState(seed)
    n = 2 + seed * 3
    words = [f"w{i}" for i in range(n)]
    tree_str = jtrees.tree_to_string(_random_tree(rs, 0, n - 1), words)
    actions = ttrees.get_actions(tree_str)
    assert actions == jtrees.get_actions(tree_str)
    assert ttrees.get_spans(actions) == jtrees.get_spans(actions)
    # custom symbols
    alt = tree_str.replace("(", "[").replace(")", "]")
    kw = dict(SHIFT=7, REDUCE=9, OPEN="[", CLOSE="]")
    assert ttrees.get_actions(alt, **kw) == jtrees.get_actions(alt, **kw)


@pytest.mark.parametrize("seed", SEEDS)
def test_stats_and_f1_match_jax(seed):
    rs = np.random.RandomState(seed)
    tm, jm = ttrees.F1Meter(), jtrees.F1Meter()
    for n in (2, 3, 5, 8, 12):
        pred, gold = _span_sets(rs, n)
        assert ttrees.get_stats(pred, gold) == jtrees.get_stats(pred, gold)
        assert ttrees.sent_f1(pred, gold) == jtrees.sent_f1(pred, gold)
        tm.update(pred, gold)
        jm.update(pred, gold)
    for empty in ((set(), set()), (set(), {(0, 1)}), ({(0, 1)}, set())):
        assert ttrees.sent_f1(*empty) == jtrees.sent_f1(*empty)
    assert (tm.tp, tm.fp, tm.fn, tm.sent) == (jm.tp, jm.fp, jm.fn, jm.sent)
    assert tm.corpus_f1 == jm.corpus_f1
    assert tm.sent_f1 == jm.sent_f1
    assert ttrees.F1Meter().corpus_f1 == jtrees.F1Meter().corpus_f1 == 0.0


@pytest.mark.parametrize("seed", SEEDS)
def test_spans_to_tree_matches_jax(seed):
    rs = np.random.RandomState(seed)
    n = 3 + 2 * seed
    tokens = [f"t{i}" for i in range(n)]
    # (pos, size) spans of a random tree, some unit spans left out
    spans = [(s, e - s + 1) for s, e in
             jtrees.tree_to_spans(_random_tree(rs, 0, n - 1))]
    spans += [(p, 1) for p in range(n) if rs.rand() < 0.5]
    rs.shuffle(spans)
    assert ttrees.spans_to_tree(spans, tokens) \
        == jtrees.spans_to_tree(spans, tokens)


@pytest.mark.parametrize("seed", SEEDS)
def test_box_iou_matches_jax(seed):
    rs = np.random.RandomState(seed)
    a, b = _boxes(rs, 5 + seed), _boxes(rs, 3)
    b[0] = a[0]                           # IoU 1
    b[1] = [200, 200, 210, 210]           # IoU 0
    got, want = tg.box_iou(a, b), jg.box_iou(a, b)
    np.testing.assert_array_equal(got, want)
    assert got[0, 0] == 1.0 and np.all(got[:, 1] == 0.0)


def _phrases(rs, n, boxes):
    out = {}
    for p in range(4):
        start = rs.randint(0, n)
        end = min(n, start + 1 + rs.randint(0, 3))
        out[f"p{p}"] = (start, end, boxes[rs.randint(len(boxes))].tolist())
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_grounding_matches_jax(seed):
    rs = np.random.RandomState(seed)
    tm, jm = tg.GroundingMeter(), jg.GroundingMeter()
    for n in (3, 6, 9):
        R = 5
        scores = rs.randn(n, R).astype(np.float32)
        boxes = _boxes(rs, R)
        phrases = _phrases(rs, n, boxes)
        got = tg.ground_phrases(scores, boxes, phrases)
        want = jg.ground_phrases(scores, boxes, phrases)
        assert got == want
        pred = set(jtrees.tree_to_spans(_random_tree(rs, 0, n - 1))[:-1])
        tm.update(got, pred)
        jm.update(want, pred)
        tm.update(got)
        jm.update(want)
        span_scores = rs.randn(n * (n + 1) // 2, R)
        assert tg.span_pred_boxes(span_scores, scores, boxes, pred, n) \
            == jg.span_pred_boxes(span_scores, scores, boxes, pred, n)
    assert (tm.total, tm.recalled, tm.ccr) == (jm.total, jm.recalled, jm.ccr)
    assert tm.recall == jm.recall and tm.ccra == jm.ccra


@pytest.mark.parametrize("length,padded", [(6, None), (4, 7), (2, None)])
def test_eval_batch_trees_matches_jax(length, padded):
    """Backpointer rows -> (tree, spans without the root), from a chart of
    its own length or a padded one (every split of a valid cell lies
    inside the sentence)."""
    n = padded or length
    rs = np.random.RandomState(length)
    offs = np.concatenate([[0], np.cumsum(np.arange(n, 0, -1))])
    bp = np.zeros((5, offs[-1]), np.int32)
    for level in range(1, n):
        bp[:, offs[level]:offs[level + 1]] = rs.randint(
            0, level, (5, n - level))
    got = teval.eval_batch_trees(bp, length, padded_length=padded)
    assert got == jeval.eval_batch_trees(bp, length, padded_length=padded)
    assert all(len(spans) == length - 2 for _, spans in got)


def test_run_eval_refuses_more_than_one_process(monkeypatch):
    """Formerly a refusal, now the distributed eval: under a trainer's dp
    mesh of two ranks, rank 1 parses every second evaluable batch (a
    batch of length 2 is not counted), and the counters and per-sentence
    F1s of the group are gathered (the other rank's share stubbed) into
    the metrics one process computes over every batch."""
    from cliora_tpu_torch.parallel.mesh import Mesh

    n, rows = 5, 2
    rs = np.random.RandomState(0)
    batches = [{"sentences": np.zeros((rows, L)), "length": L,
                "batch_size": rows,
                "GT": [sorted(_span_sets(rs, L)[1]) + [(0, L - 1)]
                       for _ in range(rows)]}
               for L in (n, 2, n, n, n)]
    offs = np.concatenate([[0], np.cumsum(np.arange(n, 0, -1))])
    bps = []
    for _ in batches:
        bp = np.zeros((rows, offs[-1]), np.int32)
        for level in range(1, n):
            bp[:, offs[level]:offs[level + 1]] = rs.randint(
                0, level, (rows, n - level))
        bps.append(bp)

    class Trainer:
        def __init__(self, mesh):
            self.mesh, self.parsed = mesh, []

        def parse(self, bm, **k):
            i = next(j for j, b in enumerate(batches) if b is bm)
            self.parsed.append(i)
            return {"cky_bp": bps[i]}, {}

    class It:
        def get_iterator(self, random_seed=None):
            return iter(batches)

    one = Trainer(None)
    want = teval.run_eval(one, It())
    assert one.parsed == [0, 2, 3, 4]

    shares = {}

    def gather(out, mine, group=None):
        shares[1] = mine
        out[:] = [shares[0], shares[1]]

    rank0 = Trainer(Mesh(size=2, rank=0, backend="gloo"))
    monkeypatch.setattr(teval, "_reduce_counters",
                        lambda *a: shares.__setitem__(0, a))
    teval.run_eval(rank0, It())
    assert rank0.parsed == [0, 3]
    f1, grounding, by_batch, _ = shares[0]
    shares[0] = (f1.tp, f1.fp, f1.fn, grounding.total, grounding.recalled,
                 grounding.ccr, by_batch)
    monkeypatch.undo()
    monkeypatch.setattr(teval.dist, "all_gather_object", gather)
    rank1 = Trainer(Mesh(size=2, rank=1, backend="gloo"))
    assert teval.run_eval(rank1, It()) == want
    assert rank1.parsed == [2, 4]
