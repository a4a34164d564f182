"""Throughput at the mixed-length training envelope: bucketed
sentences up to L=40 (the port's counterpart of tools/bench_bucketed.py).

The reference trains Flickr with ``--train_filter_length 40`` over
naturally mixed caption lengths; the bench's L=20 measures one fixed
length.  This tool measures the mixed-length path: a caption-like length
mix (lognormal, clipped to [min_len, 40]), the masked length bucketing of
data/batching.py (``BatchIterator`` with ``length_buckets``), one
``Trainer.steps`` CUDA graph per (padded length, batch size), and
``--remat auto`` (short buckets unremated, long ones checkpointed to fit
the card: ops/chart_pass.py ``remat_enabled``).

Each bucket's steady step time is measured on a batch kept on the card
(the device prefetcher's steady state) and weighted by the bucket's batch
count in one real epoch of the sampler:

    sents/s = covered sentences / sum_b (n_batches_b * step_time_b)

All of a trainer's graphs share one memory pool, so memory follows the
largest shape.  Prints one JSON line.  Usage::

    python -m cliora_tpu_torch.tools.bench_bucketed [--cliora]
        [--batch 128] [--n_buckets 4] [--sentences 20000]
        [--steps_per_call 10] [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from cliora_tpu_torch.data.batching import BatchIterator, choose_buckets
from cliora_tpu_torch.data.sampler import NegativeSampler
from cliora_tpu_torch.models.config import ModelConfig
from cliora_tpu_torch.ops.chart_pass import remat_enabled
from cliora_tpu_torch.tools import common
from cliora_tpu_torch.tools.common import D, E, F, KNEG, R, V
from cliora_tpu_torch.training.trainer import (
    GRAPH_WARMUP_STEPS,
    TrainConfig,
    Trainer,
)


def sample_lengths(n, lo, hi, rs):
    """Caption-like length mix: lognormal(mean~13 tokens) clipped
    (tools/bench_bucketed.py:41-44)."""
    x = rs.lognormal(mean=2.55, sigma=0.45, size=n)
    return np.clip(np.round(x), lo, hi).astype(int)


def bucket_size_map(buckets, sizes, batch):
    """Every exact length -> its bucket's batch size, so that each padded
    bucket makes one (B, L) graph; ``sizes`` maps a bucket edge to its
    size, lengths of buckets it does not list keep ``batch``."""
    out, prev = {}, 0
    for edge in buckets:
        for n in range(prev + 1, edge + 1):
            out[n] = sizes.get(edge, batch)
        prev = edge
    return out


def epoch_plan(lengths, rs, *, n_buckets, policy="quantile", batch=128,
               bucket_sizes=None, mixed=False, include_partial=False,
               pad_batches=False):
    """One real epoch of the sampler over a corpus of ``lengths`` (token
    ids drawn from ``rs``): ``buckets``, ``n_batches`` and a
    representative batch ``rep`` per (padded length, batch size), and the
    ``covered`` and ``dropped`` sentences.  ``bucket_sizes``: a bucket
    edge -> batch size dict (``--bucket_sizes``)."""
    buckets = choose_buckets(lengths, n_buckets, policy=policy)
    # the production data path: dataset rows -> same-length sampler ->
    # bucket padding + lengths vectors (masked bucketing)
    dataset = [(i, rs.randint(2, V, n).tolist(),
                np.zeros(1, np.float32), np.zeros(1, np.float32), 0)
               for i, n in enumerate(lengths)]
    sampler = NegativeSampler(np.ones(V) / V)
    sampler.set_seed(1)
    length_to_size = (bucket_size_map(buckets, bucket_sizes, batch)
                      if bucket_sizes else None)
    it = BatchIterator(dataset, negative_sampler=sampler, k_neg=KNEG,
                       batch_size=batch, include_partial=include_partial,
                       length_buckets=buckets, prefetch=0,
                       length_to_size=length_to_size,
                       mixed_buckets=mixed, pad_batches=pad_batches)
    n_batches, rep, covered = {}, {}, 0
    for bm in it.get_iterator(random_seed=0):
        key = (bm["padded_length"], bm["batch_size"])
        n_batches[key] = n_batches.get(key, 0) + 1
        rep.setdefault(key, bm)
        covered += bm["real_size"]
    return {"buckets": buckets, "n_batches": n_batches, "rep": rep,
            "covered": covered, "dropped": len(lengths) - covered}


def parse_bucket_sizes(text):
    """``'L:B,L:B'`` -> {L: B}."""
    return {int(k): int(v) for k, v in (p.split(":")
                                        for p in text.split(","))}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", default=128, type=int)
    ap.add_argument("--min_len", default=5, type=int)
    ap.add_argument("--max_len", default=40, type=int)
    ap.add_argument("--n_buckets", default=4, type=int)
    ap.add_argument("--bucket_policy", default="quantile",
                    choices=("quantile", "work"))
    ap.add_argument("--sentences", default=20000, type=int,
                    help="epoch size used for the bucket-mass weights")
    ap.add_argument("--steps_per_call", default=10, type=int)
    ap.add_argument("--timed_calls", default=3, type=int,
                    help="timed Trainer.steps calls per bucket")
    ap.add_argument("--cliora", action="store_true",
                    help="full CLIORA step (visual losses, K2-K4); default "
                         "is the DIORA text pretrain envelope of "
                         "train_diora.sh")
    ap.add_argument("--bucket_sizes", default=None,
                    help="per-bucket batch sizes 'L:B,L:B,...' (padded "
                         "bucket length -> batch size); lengths not listed "
                         "keep --batch (the --length_to_size lever)")
    ap.add_argument("--mixed", action="store_true",
                    help="mixed-length batch composition within buckets "
                         "(--mixed_buckets): every batch holds mixed true "
                         "lengths padded to its bucket edge")
    ap.add_argument("--include_partial", action="store_true",
                    help="emit surplus (short) batches too; with "
                         "--pad_batches they pad to full size")
    ap.add_argument("--pad_batches", action="store_true")
    ap.add_argument("--remat", default="auto",
                    help="'auto' (default) | 'true' | 'false'")
    ap.add_argument("--remat_frac", default=0.85, type=float)
    ap.add_argument("--hidden", default=D, type=int,
                    help="chart width (bench.py: 400)")
    common.add_device_flag(ap)
    args = ap.parse_args(argv)
    dev = common.device_for(args.device)

    rs = np.random.RandomState(0)
    lengths = sample_lengths(args.sentences, args.min_len, args.max_len, rs)
    plan = epoch_plan(
        lengths, rs, n_buckets=args.n_buckets, policy=args.bucket_policy,
        batch=args.batch, mixed=args.mixed,
        include_partial=args.include_partial, pad_batches=args.pad_batches,
        bucket_sizes=(parse_bucket_sizes(args.bucket_sizes)
                      if args.bucket_sizes else None))
    n_batches, rep = plan["n_batches"], plan["rep"]

    remat = (args.remat if args.remat == "auto"
             else args.remat.lower() in ("1", "true", "yes"))
    cfg = ModelConfig(size=args.hidden, input_size=E,
                      compute_dtype="bfloat16", use_obj=args.cliora,
                      remat=remat, remat_frac=args.remat_frac)
    tc = TrainConfig(lr=5e-4, k_neg=KNEG, emb_trainable=True,
                     vg_loss=args.cliora, use_contr=args.cliora,
                     attn_impl="cuda" if args.cliora else "einsum")
    trainer = Trainer.build(cfg, tc, V, seed=0, device=dev)

    K = args.steps_per_call
    per_bucket = {}
    for key in sorted(rep):
        Lp, B = key
        bm = rep[key]
        batch = {"sentences": torch.as_tensor(bm["sentences"]),
                 "neg_samples": torch.as_tensor(bm["neg_samples"]),
                 "lengths": torch.as_tensor(bm["lengths"], dtype=torch.int64)}
        if args.cliora:
            batch["obj_feats"] = torch.as_tensor(
                rs.randn(B, R, F).astype(np.float32))
        batch = {k: v.to(dev) for k, v in batch.items()}

        t0 = time.perf_counter()
        trainer.steps([batch] * (GRAPH_WARMUP_STEPS + 1))  # warm-ups, capture
        common.sync(dev)
        capture_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        for _ in range(args.timed_calls):
            ms = trainer.steps([batch] * K)
        common.sync(dev)
        dt = (time.perf_counter() - t0) / (args.timed_calls * K)
        loss = float(ms[-1]["total_loss"])
        per_bucket[f"{Lp}:{B}"] = {
            "ms_per_step": round(dt * 1e3, 2),
            "sents_per_sec": round(B / dt, 1),
            "n_batches": n_batches[key],
            "remat": bool(remat_enabled(cfg, B, Lp, args.hidden)),
            "capture_s": round(capture_s, 2),
            "loss_finite": bool(np.isfinite(loss)),
        }
        print(f"bucket L<={Lp} B={B}: {dt * 1e3:7.2f} ms/step  "
              f"{B / dt:7.0f} sents/s  x{n_batches[key]} batches  "
              f"remat={per_bucket[f'{Lp}:{B}']['remat']}", flush=True)

    # throughput counts real sentences only: padded or repeated rows do
    # work but carry no training signal
    epoch_s = sum(n * per_bucket[f"{L}:{B}"]["ms_per_step"] / 1e3
                  for (L, B), n in n_batches.items())
    common.emit({
        "metric": ("cliora" if args.cliora else "diora")
        + "_bucketed_mixed_length_train_sents_per_sec_per_card",
        "value": round(plan["covered"] / epoch_s, 1) if epoch_s else None,
        "unit": "sentences/sec/card",
        "buckets": [int(b) for b in plan["buckets"]],
        "batch": args.batch,
        "mixed": args.mixed,
        "covered_sentences": plan["covered"],
        "dropped_sentences": plan["dropped"],
        "remat": args.remat,
        "remat_frac": args.remat_frac,
        "steps_per_call": K,
        "per_bucket": per_bucket,
        "max_memory_allocated_bytes": common.peak_bytes(dev),
        **common.device_record(dev)})


if __name__ == "__main__":
    main()
