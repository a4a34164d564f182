"""The one traffic generator: every mix is a JSON file of parameters under
``benchmark/traffic/`` (found by ``core/cell.py``) that this module turns
into batches and requests.

Two kinds of mix exist.  ``train``: rounds of full batches, one batch a
length bucket in each round, in an order drawn from the seed.  ``parse``:
a corpus cut into exact-length requests of at most ``max_batch``
sentences (one partial request a length), served in passes, each pass
in its own order drawn from the seed.

Sizes never depend on ``--seed``.  The corpus of lengths is drawn from
the mix's own ``corpus_seed``, so that every run does the same set of
work; ``--seed`` draws the token ids, negatives, images, which of the
corpus's lengths fill a batch, and the order.

Parameters:

* ``lengths``: ``{"law": "lognormal", "mean", "sigma", "min", "max"}``
  (rounded, clipped) or ``{"law": "fixed", "value"}``.
* ``corpus``, ``corpus_seed``: how many lengths make the corpus.
* ``ids``: ``{"law": "zipf", "exponent", "first"}``: ids ``first..V-1``
  with probability proportional to ``rank ** -exponent``.
* train: ``batch``; ``buckets``: ``{"count", "policy": "quantile"}``
  edges over the corpus's lengths; ``negatives``: ``{"power",
  "epsilon"}``, distinct ids a batch from the corpus's unigram law to
  that power; ``images``: ``{"bank"}`` images of
  ``|N(0, 1)|`` region features drawn at set-up, one a row.
* parse: ``max_batch``.
"""

from __future__ import annotations

from typing import Dict, Iterator, List

import numpy as np


def rng(seed: int) -> np.random.Generator:
    """The numpy generator of a ``--seed`` (any whole number >= 0)."""
    return np.random.default_rng(int(seed))


def corpus_lengths(spec: Dict) -> np.ndarray:
    law = spec["lengths"]
    n = int(spec["corpus"])
    if law["law"] == "fixed":
        return np.full(n, int(law["value"]), dtype=np.int64)
    if law["law"] != "lognormal":
        raise ValueError(f"length law {law['law']!r}")
    x = rng(spec["corpus_seed"]).lognormal(law["mean"], law["sigma"], n)
    return np.clip(np.round(x), law["min"], law["max"]).astype(np.int64)


def quantile_edges(lengths, count: int) -> List[int]:
    """Equal-mass quantile edges over ``lengths``, the largest always an
    edge."""
    ls = np.sort(np.asarray(lengths))
    qs = np.linspace(0, 1, count + 1)[1:]
    idx = np.minimum((qs * len(ls)).astype(int), len(ls) - 1)
    return sorted({int(ls[i]) for i in idx})


def id_law(spec: Dict, vocab: int) -> np.ndarray:
    ids = spec["ids"]
    if ids["law"] != "zipf":
        raise ValueError(f"id law {ids['law']!r}")
    first = int(ids.get("first", 0))
    p = np.zeros(vocab)
    p[first:] = np.arange(1, vocab - first + 1, dtype=np.float64) \
        ** -float(ids["exponent"])
    return p / p.sum()


class TrainMix:
    """Batches of a ``train`` mix: ``batch(edge)`` one batch of a bucket
    (set-up takes its steps so), and ``rounds()`` the rounds of the
    window."""

    def __init__(self, spec: Dict, cfg: Dict, seed: int, bank=None):
        self.spec, self.cfg = spec, cfg
        self.B = int(spec["batch"])
        self.rs = rng(seed)
        lengths = corpus_lengths(spec)
        self.edges = quantile_edges(lengths, int(spec["buckets"]["count"]))
        lo = [0] + self.edges[:-1]
        self.pools = {e: lengths[(lengths > a) & (lengths <= e)]
                      for a, e in zip(lo, self.edges)}
        self.p_ids = id_law(spec, cfg["vocab_size"])
        neg = spec["negatives"]
        q = self.p_ids ** float(neg["power"]) + float(neg["epsilon"]) \
            / cfg["vocab_size"]
        self.p_neg = q / q.sum()
        self.bank = bank

    def batch(self, edge: int) -> Dict[str, np.ndarray]:
        rs, B = self.rs, self.B
        lens = rs.choice(self.pools[edge], B)
        toks = rs.choice(len(self.p_ids), (B, edge), p=self.p_ids)
        toks[np.arange(edge)[None, :] >= lens[:, None]] = 0
        out = {"sentences": toks.astype(np.int64),
               "neg_samples": rs.choice(len(self.p_neg),
                                        self.cfg["k_neg"], replace=False,
                                        p=self.p_neg).astype(np.int64),
               "lengths": lens.astype(np.int64)}
        if self.cfg["use_obj"]:
            out["obj_feats"] = self.bank[rs.integers(0, len(self.bank), B)]
        return out

    def rounds(self) -> Iterator[List[Dict]]:
        while True:
            order = self.rs.permutation(len(self.edges))
            yield [self.batch(self.edges[i]) for i in order]


def image_bank(spec: Dict, cfg: Dict, seed: int, device):
    """``(bank, R, F)`` f32 region features ``|N(0, 1)|`` (pooled ReLU
    features are non-negative), drawn on ``device`` from the seed and
    kept on the host."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) + 1) % 2 ** 63)
    n = int(spec["images"]["bank"])
    x = torch.randn((n, cfg["n_regions"], cfg["obj_feat_size"]),
                    generator=gen, device=device).abs_()
    return x.cpu().numpy()


class ParseMix:
    """Requests of a ``parse`` mix: exact-length batches of at most
    ``max_batch`` sentences, every length's sentences in full requests and
    one partial one.  ``passes()`` yields each pass's request indices in a
    new order."""

    def __init__(self, spec: Dict, cfg: Dict, seed: int):
        self.rs = rng(seed)
        lengths = corpus_lengths(spec)
        p_ids = id_law(spec, cfg["vocab_size"])
        cap = int(spec["max_batch"])
        self.requests: List[np.ndarray] = []
        for n in sorted(set(lengths.tolist())):
            count = int(np.sum(lengths == n))
            for at in range(0, count, cap):
                rows = min(cap, count - at)
                self.requests.append(self.rs.choice(
                    len(p_ids), (rows, n), p=p_ids).astype(np.int64))

    def passes(self) -> Iterator[np.ndarray]:
        while True:
            yield self.rs.permutation(len(self.requests))
