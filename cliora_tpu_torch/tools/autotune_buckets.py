"""Autotune the bucketed-training envelope for a corpus on the card (the
port's counterpart of tools/autotune_buckets.py).

Picks work-optimal bucket edges (data/batching.py ``choose_buckets``,
the exact DP over the corpus length histogram), then probes the real
graphed train step on the card for each (bucket, candidate batch size)
and prints flags to paste:

    --length_buckets 9,12,...,40 --bucket_sizes 9:512,12:256

A larger batch can run more sentences/s where a step of the default
batch leaves the card partly idle; where that stops (or the card runs
out of memory) depends on the corpus mix and the model, so it is
measured.  Each probe runs in a fresh child process (an out-of-memory
error leaves nothing behind).  A larger batch changes the SGD batch at
those lengths, so a size other than ``--batch`` is chosen only where it
wins by ``--min_gain`` (5 %) or more.  Usage::

    python -m cliora_tpu_torch.tools.autotune_buckets [--cliora]
        [--n_buckets 10] [--batch_candidates 128,256,512]
        [--sentences 20000] [--lengths_file path] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from cliora_tpu_torch.tools import common
from cliora_tpu_torch.tools.bench_l40 import ROOT
from cliora_tpu_torch.tools.common import D, E, F, KNEG, R, V


def probe_one(spec: dict, dev: torch.device) -> dict:
    """Child mode: the (B, L) graphed train step's ms a step
    (tools/autotune_buckets.py:45-85)."""
    from cliora_tpu_torch.models.config import ModelConfig
    from cliora_tpu_torch.ops.chart_pass import remat_enabled
    from cliora_tpu_torch.training.trainer import TrainConfig, Trainer

    B, L, K = spec["B"], spec["L"], spec["steps_per_call"]
    cliora = spec["cliora"]
    cfg = ModelConfig(size=D, input_size=E, compute_dtype="bfloat16",
                      use_obj=cliora, remat="auto",
                      remat_frac=spec["remat_frac"])
    tc = TrainConfig(lr=5e-4, k_neg=KNEG, emb_trainable=True,
                     vg_loss=cliora, use_contr=cliora,
                     attn_impl="cuda" if cliora else "einsum")
    trainer = Trainer.build(cfg, tc, V, seed=0, device=dev)
    rs = np.random.RandomState(0)
    batch = {"sentences": rs.randint(2, V, (B, L)),
             "neg_samples": rs.choice(V, KNEG, replace=False),
             "lengths": np.full((B,), L, np.int64)}
    if cliora:
        batch["obj_feats"] = rs.randn(B, R, F).astype(np.float32)
    batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
    trainer.steps([batch] * K)                # warm-ups, capture, replays
    common.sync(dev)
    t0 = time.perf_counter()
    for _ in range(spec["timed_calls"]):
        trainer.steps([batch] * K)
    common.sync(dev)
    dt = (time.perf_counter() - t0) / (spec["timed_calls"] * K)
    return {"B": B, "L": L, "ms_per_step": round(dt * 1e3, 2),
            "sents_per_sec": round(B / dt, 1),
            "remat": bool(remat_enabled(cfg, B, L, D))}


def run_probe(spec: dict, device: str, timeout: float = 1200):
    """One probe in a child process: its JSON line, or None where it
    failed (out of memory, a timeout)."""
    try:
        r = subprocess.run(
            [sys.executable, "-m", "cliora_tpu_torch.tools.autotune_buckets",
             "--probe", json.dumps(spec), "--device", device],
            capture_output=True, text=True, timeout=timeout, cwd=ROOT)
        line = [ln for ln in r.stdout.splitlines() if ln.startswith("{")]
        return json.loads(line[-1]) if r.returncode == 0 and line else None
    except (subprocess.TimeoutExpired, json.JSONDecodeError):
        return None


def choose(results, buckets, batch, cands, min_gain):
    """Each bucket's batch size: the candidate with the most sentences/s,
    unless ``batch``'s probe ran and the winner beats it by less than
    ``min_gain`` (tools/autotune_buckets.py:161-176).  ``results`` maps
    (L, B) to a probe's record, or None where it failed.  Returns
    ``(chosen, upsized)``: {L: B} and the buckets not at ``batch``."""
    chosen, upsized = {}, []
    for L in buckets:
        base = results.get((L, batch))
        best_B, best = batch, base
        for B in cands:
            r = results.get((L, B))
            if r and (best is None
                      or r["sents_per_sec"] > best["sents_per_sec"]):
                best_B, best = B, r
        if (base and best_B != batch
                and best["sents_per_sec"]
                < base["sents_per_sec"] * (1 + min_gain)):
            best_B = batch                  # not worth the other dynamics
        chosen[L] = best_B
        if best_B != batch:
            upsized.append(L)
    return chosen, upsized


def flags_line(n_buckets, buckets, chosen, upsized):
    """The train CLI's flags for the choice
    (tools/autotune_buckets.py:205-209)."""
    flags = f"--n_length_buckets {n_buckets}"
    flags += f" --length_buckets {','.join(str(b) for b in buckets)}"
    if upsized:
        flags += " --bucket_sizes " + ",".join(f"{L}:{chosen[L]}"
                                               for L in upsized)
    return flags


def project(lengths, rs, buckets, chosen, results, batch):
    """Corpus sentences/s with the chosen sizes: the real sampler re-run so
    that each bucket's batch count follows its size; None where no
    chosen probe ran."""
    from cliora_tpu_torch.data.batching import BatchIterator
    from cliora_tpu_torch.data.sampler import NegativeSampler
    from cliora_tpu_torch.tools.bench_bucketed import bucket_size_map

    dataset = [(i, rs.randint(2, V, n).tolist(),
                np.zeros(1, np.float32), np.zeros(1, np.float32), 0)
               for i, n in enumerate(lengths)]
    sampler = NegativeSampler(np.ones(V) / V)
    sampler.set_seed(1)
    it = BatchIterator(dataset, negative_sampler=sampler, k_neg=KNEG,
                       batch_size=batch, include_partial=False,
                       length_buckets=list(buckets), prefetch=0,
                       length_to_size=bucket_size_map(buckets, chosen, batch))
    n_batches, n_sents = {}, 0
    for bm in it.get_iterator(random_seed=0):
        Lp = bm["padded_length"]
        n_batches[Lp] = n_batches.get(Lp, 0) + 1
        n_sents += bm["batch_size"]
    epoch_s = sum(n * results[(L, chosen[L])]["ms_per_step"] / 1e3
                  for L, n in n_batches.items()
                  if results.get((L, chosen[L])))
    return round(n_sents / epoch_s, 1) if epoch_s else None


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--probe", help="child mode: JSON spec")
    ap.add_argument("--n_buckets", default=10, type=int)
    ap.add_argument("--batch", default=128, type=int,
                    help="default (reference-parity) batch size")
    ap.add_argument("--batch_candidates", default="128,256,512")
    ap.add_argument("--min_gain", default=0.05, type=float,
                    help="choose a batch size other than --batch only "
                         "where it beats --batch by this fraction")
    ap.add_argument("--cliora", action="store_true")
    ap.add_argument("--steps_per_call", default=10, type=int)
    ap.add_argument("--timed_calls", default=3, type=int)
    ap.add_argument("--remat_frac", default=0.85, type=float)
    ap.add_argument("--sentences", default=20000, type=int)
    ap.add_argument("--min_len", default=5, type=int)
    ap.add_argument("--max_len", default=40, type=int)
    ap.add_argument("--lengths_file", default=None,
                    help="corpus length histogram: one int per line "
                         "(default: the caption-like synthetic mix)")
    common.add_device_flag(ap)
    args = ap.parse_args(argv)
    dev = common.device_for(args.device)
    if args.probe:
        common.emit(probe_one(json.loads(args.probe), dev))
        return

    from cliora_tpu_torch.data.batching import choose_buckets
    from cliora_tpu_torch.tools.bench_bucketed import sample_lengths

    rs = np.random.RandomState(0)
    if args.lengths_file:
        lengths = np.loadtxt(args.lengths_file, dtype=int)
        lengths = lengths[(lengths >= 2)]
    else:
        lengths = sample_lengths(args.sentences, args.min_len, args.max_len,
                                 rs)
    buckets = choose_buckets(lengths, args.n_buckets, policy="work")
    cands = sorted({int(b) for b in args.batch_candidates.split(",")}
                   | {args.batch})
    print(f"work-optimal edges: {buckets}; probing B in {cands} "
          f"({len(buckets) * len(cands)} probes, one process each)",
          flush=True)

    results = {}
    for L in buckets:
        for B in cands:
            spec = {"B": B, "L": L, "cliora": args.cliora,
                    "steps_per_call": args.steps_per_call,
                    "timed_calls": args.timed_calls,
                    "remat_frac": args.remat_frac}
            got = results[(L, B)] = run_probe(spec, str(dev))
            print(f"  L<={L} B={B}: "
                  + (f"{got['ms_per_step']} ms, {got['sents_per_sec']} "
                     f"sents/s, remat={got['remat']}" if got
                     else "failed (OOM or timeout)"), flush=True)

    chosen, upsized = choose(results, buckets, args.batch, cands,
                             args.min_gain)
    common.emit({
        "metric": "autotuned_projected_sents_per_sec_per_card",
        "value": project(lengths, rs, buckets, chosen, results, args.batch),
        "unit": "sentences/sec/card",
        "buckets": [int(b) for b in buckets],
        "chosen_batch": {int(L): int(chosen[L]) for L in buckets},
        "flags": flags_line(args.n_buckets, buckets, chosen, upsized),
        "note": ("upsized buckets change the SGD batch at those lengths "
                 "(not reference-parity dynamics)" if upsized else
                 "default batch won everywhere"),
        "probes": [{"L": L, "B": B, **(r or {"failed": True})}
                   for (L, B), r in sorted(results.items())],
        **common.device_record(dev)})


if __name__ == "__main__":
    main()
