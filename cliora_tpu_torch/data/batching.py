"""Same-length batching and the batch iterator.

The port's copy of cliora_tpu/data/batching.py, its behaviour unchanged:
the same samplers, RNG streams, batch order and negative draws.  The
producer thread below builds numpy batch maps only; it never touches
CUDA (data/prefetch.py uploads them).

Exact same-length batching is the core trick that keeps charts dense and
shapes static -- one compiled XLA program per sentence length
(reference: cliora/data/dataloader.py:11-113).  The iterator is plain
python/numpy (no torch DataLoader): per-example feature fetch happens in a
background prefetch thread so host I/O overlaps device compute, and
multi-host feeding chunks each batch by process index, mirroring the
reference's per-rank chunking (cliora/data/batch_iterator.py:53-66).
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Optional

import numpy as np

from cliora_tpu_torch.data.sampler import NegativeSampler


def choose_buckets(lengths, n_buckets: int, policy: str = "quantile",
                   floor_len: float = 10.0):
    """Pick <= n_buckets padded lengths covering the corpus.

    ``policy="quantile"``: equal-mass quantiles over the example lengths,
    always including the maximum, so frequent lengths pad little and the
    compile count drops from #distinct-lengths to #buckets (the XLA-native
    replacement for one-program-per-length,
    cliora/data/dataloader.py:11-113).

    ``policy="work"``: exact DP minimizing modeled epoch *work* rather
    than example mass.  A sentence padded to bucket edge E costs
    ``floor_len**3 + E**3`` model units: the cubic term is the chart
    pass's O(L^3) cell-pair work, the floor term the measured ~5 ms
    per-step dispatch/host overhead expressed as an equivalent cubic
    length (v5e: t(L) ~ 5ms + 0.0045ms*L^3 per B=128 step, BASELINE.md
    bucketed-envelope table -> floor ~ (5/0.0045)^(1/3) ~ 10.3).
    Quantile edges split where *examples* are dense (the short end, where
    the dispatch floor makes extra buckets useless); work edges split
    where *padded work* is wasted (the long tail, where one bucket edge
    at the max makes mid-length sentences pay (max/L)^3 padding).
    """
    lengths = np.asarray(sorted(lengths))
    if len(lengths) == 0:
        return []
    if policy == "work":
        return _choose_buckets_work(lengths, n_buckets, floor_len)
    if policy != "quantile":
        raise ValueError(f"unknown bucket policy: {policy!r}")
    qs = np.linspace(0, 1, n_buckets + 1)[1:]
    idx = np.minimum((qs * len(lengths)).astype(int), len(lengths) - 1)
    return sorted(set(int(lengths[i]) for i in idx))


def _choose_buckets_work(sorted_lengths, n_buckets: int, floor_len: float):
    """Optimal bucket edges under cost(bucket) = count * (F^3 + edge^3).

    O(m^2 * n_buckets) DP over the m distinct lengths (m <= max length,
    so ~40 for the reference envelope).  Edges are always existing
    lengths (an edge between observed lengths only adds padding) and the
    max length is always an edge.
    """
    vals, counts = np.unique(np.asarray(sorted_lengths), return_counts=True)
    m = len(vals)
    if m <= n_buckets:
        return [int(v) for v in vals]
    w = floor_len ** 3 + vals.astype(np.float64) ** 3  # per-sentence cost
    csum = np.concatenate([[0.0], np.cumsum(counts.astype(np.float64))])
    INF = float("inf")
    # dp[j] = min cost covering distinct lengths [0, j) with k buckets
    dp = np.full(m + 1, INF)
    dp[0] = 0.0
    back = np.zeros((n_buckets + 1, m + 1), np.int64)
    for k in range(1, n_buckets + 1):
        ndp = np.full(m + 1, INF)
        for j in range(1, m + 1):
            # bucket = lengths (i, j], padded to vals[j-1]
            costs = dp[:j] + (csum[j] - csum[:j]) * w[j - 1]
            i = int(np.argmin(costs))
            ndp[j], back[k, j] = costs[i], i
        dp = ndp
    edges, j, k = [], m, n_buckets
    while j > 0:
        edges.append(int(vals[j - 1]))
        j, k = back[k, j], k - 1
    return sorted(set(edges))


def bucket_for(buckets, length: int) -> int:
    """Smallest bucket >= length (lengths beyond the last bucket were
    filtered upstream; fall back to the length itself)."""
    for b in buckets:
        if b >= length:
            return b
    return length


class FixedLengthBatchSampler:
    """Yields lists of example indices, all of identical token length.

    (reference: cliora/data/dataloader.py:11-113; same bucketing, shuffle,
    surplus and length_to_size semantics)
    """

    def __init__(self, lengths, batch_size, include_partial=False, rng=None,
                 maxlen=None, length_to_size=None, dispatch_group=1):
        self.lengths = list(lengths)
        self.batch_size = batch_size
        self.include_partial = include_partial
        self.rng = rng if rng is not None else np.random.RandomState(11)
        self.maxlen = maxlen
        self.length_to_size = length_to_size
        self.dispatch_group = max(1, int(dispatch_group))
        self._batch_size_cache = {0: batch_size}

    def _shuffle_order(self, order):
        """Shuffle the batch-slot order.

        ``dispatch_group == 1`` (default): uniform shuffle, the
        reference's batch-order statistics
        (cliora/data/dataloader.py:75-81).

        ``dispatch_group == K > 1``: BLOCKED shuffle -- same-key slots
        are chunked into runs of up to K and the runs are shuffled.
        Consecutive batches then share a compiled shape for K steps,
        so ``--steps_per_call K`` amortizes dispatch latency; a
        uniform shuffle over >=2 shapes almost never yields the
        same-shape runs Trainer.steps needs (expected run length
        ~1/(1-p)).  SGD sees same-bucket runs of K -- document as a
        deviation from reference order statistics (--batch_order).
        """
        if self.dispatch_group <= 1:
            self.rng.shuffle(order)
            return order
        counts: Dict[int, int] = {}
        for key in order:
            counts[key] = counts.get(key, 0) + 1
        runs = []
        for key, n in counts.items():
            q, r = divmod(n, self.dispatch_group)
            runs += [[key] * self.dispatch_group] * q
            if r:
                runs.append([key] * r)
        self.rng.shuffle(runs)
        return [k for run in runs for k in run]

    def get_batch_size(self, length: int) -> int:
        if self.length_to_size is None:
            return self.batch_size
        if length in self._batch_size_cache:
            return self._batch_size_cache[length]
        start = max(self._batch_size_cache.keys())
        size = self._batch_size_cache[start]
        for n in range(start + 1, length + 1):
            size = self.length_to_size.get(n, size)
            self._batch_size_cache[n] = size
        return size

    def __iter__(self):
        length_map: Dict[int, list] = {}
        for i, length in enumerate(self.lengths):
            if self.maxlen and length > self.maxlen:
                continue
            length_map.setdefault(length, []).append(i)
        for arr in length_map.values():
            self.rng.shuffle(arr)

        order = []
        position = {length: 0 for length in length_map}
        for length, arr in length_map.items():
            size = self.get_batch_size(length)
            order += [length] * (len(arr) // size)
            if self.include_partial and len(arr) % size:
                order += [length]
        order = self._shuffle_order(order)

        for length in order:
            size = self.get_batch_size(length)
            start = position[length]
            position[length] = start + size
            yield length_map[length][start:start + size]


class BucketBatchSampler(FixedLengthBatchSampler):
    """Mixed-length batches within length buckets.

    Where :class:`FixedLengthBatchSampler` groups examples by *exact*
    token length (reference: cliora/data/dataloader.py:11-113), this
    sampler groups them by their covering bucket edge
    (:func:`bucket_for`) and fills every batch with mixed true lengths;
    rows are padded to the edge downstream and the model consumes the
    per-example ``lengths`` vector (the per-example masks in
    ops/chart_pass.py / training/losses.py were built for exactly this).

    This removes the two structural losses of exact grouping measured
    in BASELINE.md's envelope table: examples of rare lengths are
    dropped entirely when no exact length musters a full batch (at
    B=128 on the caption mix, *every* sentence of length >= 30), and
    each length's surplus is wasted (or shape-churned) per epoch.

    ``min_length`` drops too-short examples at composition time: the
    reference skips length<=2 *batches* in its train/eval loops
    (cliora/scripts/train.py:80-81,153-154), which a per-batch filter
    cannot express once lengths are mixed.

    Yields ``(edge, [example indices])`` pairs -- the edge is part of
    the contract because the padded width must be the bucket edge even
    when every sampled row is shorter (one compiled program per bucket,
    never per observed-max).
    """

    def __init__(self, lengths, buckets, batch_size, include_partial=False,
                 rng=None, maxlen=None, length_to_size=None, min_length=3,
                 dispatch_group=1):
        super().__init__(lengths, batch_size,
                         include_partial=include_partial, rng=rng,
                         maxlen=maxlen, length_to_size=length_to_size,
                         dispatch_group=dispatch_group)
        assert buckets, "BucketBatchSampler needs length buckets"
        self.buckets = sorted(int(b) for b in buckets)
        self.min_length = min_length

    def __iter__(self):
        bucket_map: Dict[int, list] = {}
        for i, length in enumerate(self.lengths):
            if self.maxlen and length > self.maxlen:
                continue
            if self.min_length and length < self.min_length:
                continue
            bucket_map.setdefault(
                bucket_for(self.buckets, length), []).append(i)
        for arr in bucket_map.values():
            self.rng.shuffle(arr)

        order = []
        position = {edge: 0 for edge in bucket_map}
        for edge, arr in bucket_map.items():
            size = self.get_batch_size(edge)
            order += [edge] * (len(arr) // size)
            if self.include_partial and len(arr) % size:
                order += [edge]
        order = self._shuffle_order(order)

        for edge in order:
            size = self.get_batch_size(edge)
            start = position[edge]
            position[edge] = start + size
            yield edge, bucket_map[edge][start:start + size]


class BatchIterator:
    """Assembles batch_maps from a dataset + sampler.

    batch_map keys: sentences (B, L) int32, neg_samples (k,) int64,
    batch_size, length, obj_feats, boxes, obj_cates, plus every per-example
    ``extra`` list indexed by the batch.
    (reference: cliora/data/batch_iterator.py:44-184)
    """

    def __init__(self, dataset, extra=None, negative_sampler: Optional[
            NegativeSampler] = None, k_neg: int = 100, batch_size: int = 16,
            include_partial: bool = False, filter_length: Optional[int] = None,
            length_to_size=None, process_index: int = 0,
            process_count: int = 1, prefetch: int = 4,
            pad_batches: bool = False, length_buckets=None,
            mixed_buckets: bool = False, dispatch_group: int = 1):
        self.dataset = dataset
        self.extra = extra or {}
        self.negative_sampler = negative_sampler
        self.k_neg = k_neg
        self.batch_size = batch_size
        self.include_partial = include_partial
        self.filter_length = filter_length
        self.length_to_size = length_to_size
        self.process_index = process_index
        self.process_count = process_count
        self.prefetch = prefetch
        # Pad surplus batches up to the bucket batch size by repeating
        # examples, so XLA compiles one executable per sentence length
        # instead of one per (length, remainder) pair.  ``real_size``
        # records how many leading rows are genuine; evaluation loops
        # must ignore the padding rows.
        self.pad_batches = pad_batches
        # Masked length-bucketing: pad each (same-length) batch's token
        # array up to the smallest bucket length and emit a ``lengths``
        # vector; the model masks pad cells out of the outside pass and
        # losses (ops/chart_pass.py outside_pass, training/losses.py).
        # Batch *composition* is untouched, so losses match the unbucketed
        # run while XLA compiles one program per bucket, not per length.
        self.length_buckets = (sorted(length_buckets)
                               if length_buckets else None)
        # Mixed composition: batches hold mixed TRUE lengths from one
        # bucket (BucketBatchSampler) instead of one exact length.
        if mixed_buckets and not self.length_buckets:
            raise ValueError("mixed_buckets requires length_buckets")
        self.mixed_buckets = mixed_buckets
        # --batch_order blocked: emit same-shape batches in runs of
        # this many so steps_per_call can group them into one dispatch
        self.dispatch_group = max(1, int(dispatch_group))
        self.word2idx = None  # set by make_batch_iterator

    # -- reference-parity introspection helpers (batch_iterator.py:68-80) --
    def get_dataset_size(self):
        return len(self.dataset)

    def get_dataset_minlen(self):
        return min(len(self.dataset[i][1]) for i in range(len(self.dataset)))

    def get_dataset_maxlen(self):
        return max(len(self.dataset[i][1]) for i in range(len(self.dataset)))

    def get_dataset_stats(self):
        return (f"size={self.get_dataset_size()} "
                f"minlen={self.get_dataset_minlen()} "
                f"maxlen={self.get_dataset_maxlen()}")

    def _assemble(self, batch_index, target_size=None, edge=None):
        real_size = len(batch_index)
        if (self.pad_batches and target_size is not None
                and real_size < target_size):
            reps = [batch_index[i % real_size]
                    for i in range(target_size - real_size)]
            batch_index = list(batch_index) + reps
        rows = [self.dataset[i] for i in batch_index]
        index, sents, obj_feats, boxes, obj_cates = zip(*rows)
        if edge is not None:
            # mixed-bucket path: rows carry DIFFERENT true lengths; each
            # pads to the bucket edge (the compiled program's width) and
            # the per-example ``lengths`` vector drives the model masks
            lens = np.asarray([len(s) for s in sents], np.int32)
            sentences = np.zeros((len(sents), int(edge)), np.int32)
            for r, s in enumerate(sents):
                sentences[r, :len(s)] = s
        else:
            sentences = np.asarray(sents, dtype=np.int32)
        batch_map = {
            "index": list(index),
            "sentences": sentences,
            "obj_feats": np.asarray(obj_feats),
            "boxes": np.asarray(boxes),
            "obj_cates": np.asarray(obj_cates),
        }
        if edge is not None:
            batch_map["lengths"] = lens
        elif self.length_buckets is not None:
            true_len = sentences.shape[1]
            padded_len = bucket_for(self.length_buckets, true_len)
            if padded_len > true_len:
                pad = np.zeros(
                    (sentences.shape[0], padded_len - true_len), np.int32)
                batch_map["sentences"] = np.concatenate(
                    [sentences, pad], axis=1)
            batch_map["lengths"] = np.full(
                sentences.shape[0], true_len, np.int32)
        for k, v in self.extra.items():
            batch_map[k] = [v[i] for i in index]

        if self.process_count > 1:
            # per-host chunk along batch dim (reference rank chunking);
            # the ranks' chunks must be equal, as the dp step gathers
            # them (parallel/mesh.py shard_batch's contract)
            rows = len(batch_map["sentences"])
            if rows % self.process_count:
                raise ValueError(
                    f"batch of {rows} rows not divisible by "
                    f"{self.process_count} processes: make the batch "
                    f"size a multiple of the world size (--pad_batches "
                    f"fills a partial batch)")
            for k, v in batch_map.items():
                parts = np.array_split(
                    np.arange(len(v)), self.process_count)
                keep = parts[self.process_index]
                if isinstance(v, np.ndarray):
                    batch_map[k] = v[keep]
                else:
                    batch_map[k] = [v[i] for i in keep]

        B, L = batch_map["sentences"].shape
        batch_map["batch_size"] = B
        batch_map["real_size"] = min(real_size, B)
        # "length" stays the TRUE sentence length so decode/eval consumers
        # are bucket-agnostic; the padded array width is "padded_length".
        # Mixed-bucket batches hold several true lengths -- "length" is
        # the max (consumers needing per-example truth use "lengths").
        batch_map["length"] = (int(batch_map["lengths"].max())
                               if "lengths" in batch_map else L)
        batch_map["padded_length"] = L
        if self.negative_sampler is not None:
            batch_map["neg_samples"] = self.negative_sampler.sample(
                self.k_neg)
        return batch_map

    def get_iterator(self, random_seed=None, **kwargs):
        batch_size = kwargs.get("batch_size", self.batch_size)
        rng = np.random.RandomState(random_seed)
        if random_seed is not None and self.negative_sampler is not None:
            # deterministic per-epoch negative draws: epoch k of a
            # --resume'd run sees the same negatives as epoch k of the
            # uninterrupted run (the reference draws from un-reseeded
            # global numpy state and is not resume-reproducible,
            # cliora/data/batch_iterator.py:147-160)
            self.negative_sampler.set_seed(random_seed)
        lengths = [len(self.dataset[i][1])
                   for i in range(len(self.dataset))]
        include_partial = kwargs.get("include_partial",
                                     self.include_partial)
        if self.mixed_buckets:
            mixed_sampler = BucketBatchSampler(
                lengths, self.length_buckets, batch_size=batch_size,
                rng=rng, maxlen=self.filter_length,
                include_partial=include_partial,
                length_to_size=self.length_to_size,
                dispatch_group=self.dispatch_group)

            def assemble(item):
                edge, batch_index = item
                target = (mixed_sampler.get_batch_size(edge)
                          if batch_index else None)
                return self._assemble(batch_index, target_size=target,
                                      edge=edge)

            sampler = mixed_sampler
        else:
            sampler = FixedLengthBatchSampler(
                lengths, batch_size=batch_size, rng=rng,
                maxlen=self.filter_length,
                include_partial=include_partial,
                length_to_size=self.length_to_size,
                dispatch_group=self.dispatch_group)

            def assemble(batch_index):
                target = sampler.get_batch_size(
                    lengths[batch_index[0]]) if batch_index else None
                return self._assemble(batch_index, target_size=target)

        if self.prefetch <= 0:
            for batch_index in sampler:
                yield assemble(batch_index)
            return

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        _DONE = object()

        def producer():
            try:
                for batch_index in sampler:
                    q.put(assemble(batch_index))
            finally:
                q.put(_DONE)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is _DONE:
                break
            yield item
