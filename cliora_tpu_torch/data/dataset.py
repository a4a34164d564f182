"""Dataset assembly: reader -> vocab -> embeddings -> indexed corpus, and
batch-iterator construction.

The port's copy of cliora_tpu/data/dataset.py.  The one change: the
per-process chunking of train batches takes the ``torch.distributed``
rank and world size where a process group is initialised (0 and 1
otherwise) in place of ``jax.process_index()``/``process_count()``
(cliora_tpu/data/dataset.py:219,246), over the dp rows of a ``--mp``
grid: the mp ranks of one row get the same rows.
(reference: cliora/data/dataset.py)
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from cliora_tpu_torch.data.batching import BatchIterator
from cliora_tpu_torch.data.datasets import (
    COCODataset,
    FlickrDataset,
    SimpleDataset,
)
from cliora_tpu_torch.data.embeddings import UNK_TOKEN, get_embeddings
from cliora_tpu_torch.data.preprocessing import build_text_vocab, indexify
from cliora_tpu_torch.data.readers import (
    COCOReader,
    ConllReader,
    FlickrReader,
    JSONLReader,
    PTBReader,
    PlainTextReader,
    SyntheticReader,
)
from cliora_tpu_torch.data.sampler import NegativeSampler, calculate_freq_dist

READERS = {
    "flickr": FlickrReader,
    "coco": COCOReader,
    "ptb": PTBReader,
    "txt": PlainTextReader,
    "jsonl": JSONLReader,
    "conll": ConllReader,
    "synthetic": SyntheticReader,
}


class ReaderManager:
    """reader -> vocab -> embeddings -> indexify
    (reference: cliora/data/dataset.py:66-108)"""

    def __init__(self, reader):
        self.reader = reader

    def run(self, options, text_path, embeddings_path) -> Dict:
        result = self.reader.read(text_path)
        sentences = result["sentences"]
        extra = result["extra"]
        metadata = result.get("metadata", {})

        word2idx = metadata.get("word2idx") or build_text_vocab(sentences)

        if "embeddings" in metadata:
            embeddings = metadata.pop("embeddings")
        else:
            embeddings, word2idx = get_embeddings(
                options, embeddings_path, word2idx)

        unk_index = word2idx.get(UNK_TOKEN)
        sentences = indexify(sentences, word2idx, unk_index)

        return {
            "sentences": sentences,
            "embeddings": embeddings,
            "word2idx": word2idx,
            "extra": extra,
            "metadata": metadata,
        }


class ReconstructDataset:
    """(reference: cliora/data/dataset.py:111-124; extended to every
    reader the CLI supports, not just coco/flickr)"""

    def initialize(self, options, text_path=None, embeddings_path=None,
                   filter_length=0, data_type=None) -> Dict:
        if data_type == "synthetic":
            reader = SyntheticReader(
                nexamples=getattr(options, "synthetic_nexamples", 100),
                vocab_size=getattr(options, "synthetic_vocabsize", 1000),
                embedding_size=getattr(options, "synthetic_embeddingsize",
                                       1024),
                minlen=getattr(options, "synthetic_minlen", 5),
                maxlen=getattr(options, "synthetic_maxlen", 20),
                seed=getattr(options, "synthetic_seed", 11),
                length=getattr(options, "synthetic_length", None))
        else:
            cls = READERS.get(data_type)
            if cls is None:
                raise NotImplementedError(data_type)
            reader = cls(lowercase=options.lowercase,
                         filter_length=filter_length)
        return ReaderManager(reader).run(options, text_path,
                                         embeddings_path)


class ConsolidateDatasets:
    """Merge vocab/embeddings of several datasets into a master mapping.

    (reference: cliora/data/dataset.py:16-63)
    """

    def __init__(self, datasets):
        self.datasets = datasets

    def run(self):
        master: Dict[str, int] = {}
        old2master_lst = []
        for dset in self.datasets:
            old2master = {}
            for w, idx in dset["word2idx"].items():
                if w not in master:
                    master[w] = len(master)
                old2master[idx] = master[w]
            old2master_lst.append(old2master)

        if isinstance(self.datasets[0]["embeddings"], int):
            # --emb none: "embeddings" is the trainable-table vocab size
            # (data/embeddings.py get_embeddings); only the vocab merges
            embeddings = len(master)
        else:
            size = self.datasets[0]["embeddings"].shape[1]
            embeddings = np.zeros((len(master), size), dtype=np.float32)
            for dset, old2master in zip(self.datasets, old2master_lst):
                src, dst = zip(*old2master.items())
                embeddings[np.asarray(dst)] = \
                    dset["embeddings"][np.asarray(src)]

        for dset, old2master in zip(self.datasets, old2master_lst):
            dset["sentences"] = [[old2master[i] for i in s]
                                 for s in dset["sentences"]]
            dset["word2idx"] = master
            dset["embeddings"] = embeddings


def process_rank_and_count(mp: int = 1):
    """``(dp rank, dp size)`` of this process in its ``torch.distributed``
    group laid out as a ``dp x mp`` grid (rank ``d * mp + m``,
    parallel/mesh.py), or ``(0, 1)`` without one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank() // mp, dist.get_world_size() // mp
    return 0, 1


def make_batch_iterator(options, dset, shuffle=True, include_partial=False,
                        filter_length=0, batch_size=None,
                        length_to_size=None, mode: str = "train",
                        data_path: Optional[str] = None,
                        pad_batches: bool = False,
                        length_buckets=None,
                        region_features=None) -> BatchIterator:
    """(reference: cliora/data/dataset.py:127-160)

    ``region_features``: the ``(features, bboxes, pos_bboxes)`` arrays of
    a Flickr split, handed to :class:`FlickrDataset` in place of reading
    its HDF5 file (data/datasets.py ``read_features``)."""
    sentences = dset["sentences"]
    word2idx = dset["word2idx"]
    extra = dset["extra"]

    # Auto-bucketing applies to the TRAIN iterator only: the analysis /
    # eval scripts index charts by exact length (run_eval itself is
    # padded-aware, but parse/phrase_embed chart dumps are not).
    if length_buckets is None and mode == "train":
        explicit = getattr(options, "length_buckets", None)
        if explicit:
            # normalized to ascending order: downstream consumers
            # (--bucket_sizes expansion below, bucket_for) assume it
            length_buckets = sorted(
                int(x) for x in str(explicit).split(","))
        elif getattr(options, "n_length_buckets", 0):
            from cliora_tpu_torch.data.batching import choose_buckets
            lens = [len(s) for s in sentences
                    if not filter_length or len(s) <= filter_length]
            policy = getattr(options, "bucket_policy", "work")
            length_buckets = choose_buckets(
                lens, options.n_length_buckets, policy=policy,
                floor_len=getattr(options, "bucket_floor_len", 10.0))
            from cliora_tpu_torch.utils.observability import get_logger
            get_logger().info(
                f"length buckets ({policy}): {length_buckets} "
                f"(one compiled program per bucket)")

    # --bucket_sizes 'edge:B,...': per-BUCKET batch sizes, expanded to
    # every exact length inside the bucket so each padded bucket still
    # compiles exactly one (B, L) program.  Explicit --length_to_size
    # entries (exact length -> size) take precedence.  Produced by
    # tools/autotune_buckets.py; the production form of the reference's
    # length_to_size dict (cliora/data/dataloader.py:27-38).
    bucket_sizes = getattr(options, "bucket_sizes", None)
    if bucket_sizes and length_buckets and mode == "train":
        per_bucket = {int(a): int(b) for a, b in
                      (p.split(":") for p in str(bucket_sizes).split(","))}
        unknown = set(per_bucket) - set(int(b) for b in length_buckets)
        if unknown:
            raise ValueError(
                f"--bucket_sizes names non-bucket edges {sorted(unknown)}; "
                f"buckets are {list(length_buckets)}")
        if batch_size is None:
            raise ValueError("--bucket_sizes needs an explicit batch size")
        # length_to_size is a sticky step function in the sampler
        # (reference semantics, FixedLengthBatchSampler.get_batch_size),
        # so uncovered buckets are explicitly reset to the default.
        expanded, prev = {}, 0
        for edge in sorted(int(b) for b in length_buckets):
            sz = per_bucket.get(edge, batch_size)
            for n in range(prev + 1, edge + 1):
                expanded[n] = sz
            prev = edge
        expanded.update(length_to_size or {})
        length_to_size = expanded

    negative_sampler = NegativeSampler(
        freq_dist=calculate_freq_dist(sentences, len(word2idx)),
        dist_power=getattr(options, "freq_dist_power", 0.75))

    use_obj = getattr(options, "obj_feats", False)
    data_type = getattr(options, "data_type", None)
    if use_obj and data_type == "flickr":
        kwargs = {} if data_path is None else {"data_path": data_path}
        dataset = FlickrDataset(sentences, extra["example_ids"], mode,
                                features=region_features, **kwargs)
    elif use_obj and data_type == "coco":
        dataset = COCODataset(sentences, extra["example_ids"])
    else:
        dataset = SimpleDataset(sentences)

    rank, world = process_rank_and_count(getattr(options, "mp", 1))

    # Per-process chunking applies to TRAIN batches only (each process
    # feeds its local shard of the global batch, reference rank chunking,
    # cliora/data/batch_iterator.py:53-66).  Validation/parse iterators
    # stay whole: eval runs per-process-local on the chief over the FULL
    # validation set (scripts/train.py run_train).
    chunked = mode == "train"
    mixed = bool(getattr(options, "mixed_buckets", False)) and chunked
    if mixed and not length_buckets:
        raise ValueError("--mixed_buckets requires --length_buckets or "
                         "--n_length_buckets")
    # --batch_order blocked: emit same-shape TRAIN batches in runs of
    # steps_per_call so Trainer.steps can fuse them into one dispatch
    # (a uniform shuffle over many shapes never forms such runs)
    dispatch_group = 1
    if (chunked
            and getattr(options, "batch_order", "shuffle") == "blocked"):
        dispatch_group = max(1, int(getattr(options, "steps_per_call", 1)
                                    or 1))
    it = BatchIterator(
        dataset, extra=extra, negative_sampler=negative_sampler,
        k_neg=getattr(options, "k_neg", 100),
        batch_size=batch_size,
        include_partial=include_partial,
        filter_length=filter_length,
        length_to_size=length_to_size,
        process_index=rank if chunked else 0,
        process_count=world if chunked else 1,
        pad_batches=pad_batches,
        length_buckets=length_buckets,
        mixed_buckets=mixed,
        dispatch_group=dispatch_group)
    it.word2idx = word2idx
    return it
