"""Serving-path throughput: the sealed bundle against the live
``Trainer.parse`` (the port's counterpart of tools/bench_serving.py).

Exports a DIORA text bundle (D=400, one padded-length bucket; weights as
program inputs, or baked with ``--baked_params``), loads it with
``ExportedParser``, captures its CUDA graphs (``warmup``), and times
``parse`` (pad, replay, host CKY decode) against the live
``Trainer.parse`` on the same B x L batch.  The live route is recorded
(``parse_impl``): on the card an exact-length DIORA batch takes the
fused inside+CKY kernel K1, the bundle the plain chart pass with
``lengths``.  ``--concurrency N`` runs N threads of one-sentence
requests in this process through ``MicroBatcher`` against
lock-serialized calls.  ``--bundle_dir`` keeps the bundle and reuses it:
a second run measures a restart, which loads the programs and captures
the graphs again (a CUDA graph cannot be written to disk).

Usage::

    python -m cliora_tpu_torch.tools.bench_serving [--batch 128]
        [--length 20] [--steps 20] [--concurrency 16] [--device cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import os
import tempfile
import threading
import time

import numpy as np
import torch

from cliora_tpu_torch.tools import common


def bench_concurrent(served, sents, args):
    """N threads x M one-sentence requests: micro-batched dispatch
    (``MicroBatcher``) against a lock-serialized call per request
    (tools/bench_serving.py:28-87).  Returns req/s and ms a request of
    each."""
    from cliora_tpu_torch.serving import MicroBatcher

    N, M = args.concurrency, max(1, args.requests // args.concurrency)
    reqs = [[sents[i % len(sents)]] for i in range(N)]

    def run(fn):
        barrier = threading.Barrier(N)

        def stream(i):
            barrier.wait()
            for _ in range(M):
                fn(reqs[i])

        threads = [threading.Thread(target=stream, args=(i,))
                   for i in range(N)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return time.perf_counter() - t0

    if args.no_warm:
        print("warmup : skipped (--no_warm); the first call of each new "
              "coalesced shape runs eagerly", flush=True)
    else:
        t0 = time.perf_counter()
        n = served.warmup(N)     # every quantized batch shape up to N rows
        print(f"warmup : {n} shapes in {time.perf_counter() - t0:.1f}s",
              flush=True)

    lock = threading.Lock()

    def serialized(sentences):
        with lock:
            return served.parse(sentences)

    t0 = time.perf_counter()
    serialized(reqs[0])
    print(f"first single-sentence response: {time.perf_counter() - t0:.2f}s",
          flush=True)
    mb = MicroBatcher(served, max_batch=N, max_wait_ms=5.0)
    try:
        t0 = time.perf_counter()
        mb.submit(reqs[0])
        print(f"first microbatch response: {time.perf_counter() - t0:.2f}s",
              flush=True)
        total, out = N * M, {"clients": N, "requests": N * M}
        for name, fn in (("serialized", serialized),
                         ("microbatch", mb.submit)):
            dt = run(fn)
            out[name] = {"req_per_s": total / dt,
                         "ms_per_req": dt / total * 1e3}
            print(f"{name:>10}: {total / dt:8.1f} req/s at concurrency "
                  f"{N} ({dt / total * 1e3:.2f} ms/req)", flush=True)
    finally:
        mb.close()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", default=128, type=int)
    ap.add_argument("--length", default=20, type=int)
    ap.add_argument("--hidden", default=400, type=int)
    ap.add_argument("--steps", default=20, type=int)
    ap.add_argument("--concurrency", default=1, type=int,
                    help="also bench N concurrent one-sentence request "
                         "streams through serving.MicroBatcher against "
                         "lock-serialized calls")
    ap.add_argument("--requests", default=200, type=int,
                    help="requests of the concurrent benchmark")
    ap.add_argument("--no_warm", action="store_true",
                    help="skip the capture before the concurrent "
                         "benchmark (each new coalesced shape then runs "
                         "eagerly)")
    ap.add_argument("--bundle_dir", default=None,
                    help="keep the bundle here and reuse it if present: "
                         "a second run measures a restart (load and "
                         "capture again)")
    ap.add_argument("--baked_params", action="store_true",
                    help="export with the weights baked into the programs "
                         "instead of as their inputs; a reused bundle "
                         "follows its manifest")
    common.add_device_flag(ap)
    args = ap.parse_args(argv)
    dev = common.device_for(args.device)

    from cliora_tpu_torch.analysis.trees import decode_batch
    from cliora_tpu_torch.models.config import ModelConfig
    from cliora_tpu_torch.models.params import init_params
    from cliora_tpu_torch.serving import (
        ExportedParser,
        export_parser,
        save_bundle,
    )
    from cliora_tpu_torch.training.trainer import TrainConfig, Trainer
    from cliora_tpu_torch.utils.prng import PRNGKey

    B, L = args.batch, args.length
    cfg = ModelConfig(size=args.hidden, input_size=1024)
    params = init_params(PRNGKey(0), cfg, 10000)
    rs = np.random.RandomState(0)
    sents = [list(rs.randint(2, 10000, L)) for _ in range(B)]

    if args.bundle_dir:
        ctx = contextlib.nullcontext(args.bundle_dir)
        reuse = os.path.exists(os.path.join(args.bundle_dir,
                                            "manifest.json"))
    else:
        ctx = tempfile.TemporaryDirectory()
        reuse = False
    in_args = not args.baked_params
    rec = {"metric": "bench_serving", "batch": B, "length": L,
           "hidden": args.hidden, "reused_bundle": reuse}
    if not reuse:
        t0 = time.perf_counter()
        arts = export_parser(cfg, params, [L], platforms=[dev.type],
                             params_in_args=in_args)
        rec["export_s"] = time.perf_counter() - t0
        rec["bundle_mb"] = len(arts[L]) / 1e6
        print(f"export: {rec['export_s']:.1f}s, {rec['bundle_mb']:.2f} MB "
              f"({'weights-as-args' if in_args else 'baked'})", flush=True)
    with ctx as d:
        if not reuse:
            save_bundle(d, cfg, arts, params=params if in_args else None)
        else:
            print(f"reusing bundle at {d} (restart: load and capture "
                  f"again)", flush=True)
        t0 = time.perf_counter()
        served = ExportedParser(d, device=dev)
        rec["load_s"] = time.perf_counter() - t0
        rec["weights"] = ("args" if served.meta.get("params_in_args")
                          else "baked")
        t0 = time.perf_counter()
        rec["warm_shapes"] = served.warmup(B)
        bundle_trees = served.parse(sents)       # the first call of shape B
        rec["warmup_s"] = time.perf_counter() - t0
        print(f"warmup + first call (B={B}): {rec['warmup_s']:.1f}s, "
              f"{rec['warm_shapes']} shapes", flush=True)
        t0 = time.perf_counter()
        for _ in range(args.steps):
            served.parse(sents)
        dt = (time.perf_counter() - t0) / args.steps
        rec.update(bundle_ms_per_batch=dt * 1e3, bundle_sents_per_s=B / dt)
        print(f"bundle : {dt * 1e3:7.1f} ms/batch  {B / dt:8.0f} sents/s",
              flush=True)
        rec["concurrency"] = (bench_concurrent(served, sents, args)
                              if args.concurrency > 1 else None)
        rec["eager_calls"] = served.eager_calls

    trainer = Trainer(cfg, TrainConfig(k_neg=5), params, device=dev)
    batch = {"sentences": np.asarray(sents, np.int64)}
    res, _ = trainer.parse(batch)                  # warm
    live_trees = [t for t, _ in decode_batch(res["cky_bp"], L)]
    t0 = time.perf_counter()
    for _ in range(args.steps):
        res, _ = trainer.parse(batch)
    dt = (time.perf_counter() - t0) / args.steps
    rec.update(live_ms_per_batch=dt * 1e3, live_sents_per_s=B / dt,
               parse_impl=res["parse_impl"],
               trees_equal=sum(a == b for a, b in zip(bundle_trees,
                                                      live_trees)))
    print(f"live   : {dt * 1e3:7.1f} ms/batch  {B / dt:8.0f} sents/s "
          f"(parse_impl={res['parse_impl']}); bundle trees equal to live: "
          f"{rec['trees_equal']} of {B}", flush=True)
    common.emit({**rec, **common.device_record(dev)})


if __name__ == "__main__":
    main()
