"""Host-side CKY backpointer decode throughput: the C decoder against the
Python one (the port's counterpart of tools/bench_decode.py).

The device emits (B, ncells) backpointers; the host turns them into
trees and spans (analysis/trees.py ``decode_batch``).  This times that
loop both ways on random valid backpointers (chart/offsets.py
``random_backpointers``): first the port's C decoder (native/), then the
Python path, forced by marking the C decoder unavailable for the run and
restored afterwards.  It runs on the host only and needs no card.

Usage::

    python -m cliora_tpu_torch.tools.bench_decode [--batch 128]
        [--length 20] [--reps 50]
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from cliora_tpu_torch import native
from cliora_tpu_torch.analysis import trees
from cliora_tpu_torch.chart.offsets import random_backpointers
from cliora_tpu_torch.tools import common


def timed(bp, n, reps):
    """(seconds a batch, the decoded trees, the decoder that ran)."""
    out = trees.decode_batch(bp, n)
    t0 = time.perf_counter()
    for _ in range(reps):
        trees.decode_batch(bp, n)
    return ((time.perf_counter() - t0) / reps, [t for t, _ in out],
            trees.last_decoder)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", default=128, type=int)
    ap.add_argument("--length", default=20, type=int)
    ap.add_argument("--reps", default=50, type=int)
    args = ap.parse_args(argv)

    n, B = args.length, args.batch
    bp = random_backpointers(np.random.RandomState(0), n, B)
    results, decoded, ran = {}, {}, {}
    if native.load() is not None:
        results["native_C"], decoded["native_C"], ran["native_C"] = timed(
            bp, n, args.reps)
    saved = native._CACHE
    native._CACHE = None                      # the Python path for this run
    try:
        results["python"], decoded["python"], ran["python"] = timed(
            bp, n, args.reps)
    finally:
        native._CACHE = saved
    for name, dt in results.items():
        print(f"{name:>9}: {dt * 1e3:7.2f} ms/batch  "
              f"{B / dt:9.0f} sentences/s", flush=True)
    rec = {"metric": "bench_decode", "batch": B, "length": n,
           "reps": args.reps, "decoders": ran,
           **{f"{k}_ms": v * 1e3 for k, v in results.items()},
           **{f"{k}_sents_per_s": B / v for k, v in results.items()}}
    if "native_C" in results:
        rec["speedup"] = results["python"] / results["native_C"]
        rec["trees_equal"] = decoded["native_C"] == decoded["python"]
        print(f"  speedup: {rec['speedup']:.1f}x", flush=True)
    common.emit({**rec, "device": "cpu", "power_limit": None,
                 "host_cpus": os.cpu_count()})


if __name__ == "__main__":
    main()
