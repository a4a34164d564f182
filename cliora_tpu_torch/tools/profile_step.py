"""Profile the bench train step on the card and attribute its device time
per CUDA kernel (the port's counterpart of tools/profile_step.py).

Usage::

    python -m cliora_tpu_torch.tools.profile_step [--steps 20] [--top 30]
        [--source] [--dtype bfloat16|float32] [--device cpu]

Builds bench.py's CLIORA configuration (B=128, L=20, D=400, E=1,024,
V=10,000 trainable, k_neg 100, 36 x 2,048-d regions, VG + contrastive,
``attn_impl="cuda"``: kernels K2-K4), warms ``Trainer.steps`` (its two
eager warm-up steps and the capture of the CUDA graph), times ``--steps``
replayed steps to one sync, then profiles ``--steps`` replayed steps with
``torch.profiler``.  Prints the wall ms a step, the device-busy ms a step
and the idle share between them, and the top ``--top`` device kernels by
ms a step with their launches a step.  ``--source`` names each kernel's
aten op and the port's file:line that called it, from one eager step
profiled with its Python stacks (a replayed graph's kernels carry no CPU
op).  Ends with one JSON line.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from cliora_tpu_torch.models.config import ModelConfig
from cliora_tpu_torch.tools import common
from cliora_tpu_torch.tools.common import D, E, F, KNEG, R, V
from cliora_tpu_torch.training.trainer import (
    GRAPH_WARMUP_STEPS,
    TrainConfig,
    Trainer,
)


def build(B=128, L=20, dtype="bfloat16", device=None, attn_impl="cuda",
          D=D, E=E, V=V, K=KNEG, R=R, F=F, use_contr=True):
    """The bench trainer and one batch on its device (tools/profile_step.py:
    32-48); the widths and the span x region route may be changed, as
    ``tools/bench.py`` does for its FLOP count and its CPU tests."""
    cfg = ModelConfig(size=D, input_size=E, use_obj=True, n_regions=R,
                      obj_feat_size=F, compute_dtype=dtype)
    tc = TrainConfig(lr=5e-4, k_neg=K, vg_loss=True, use_contr=use_contr,
                     emb_trainable=True, attn_impl=attn_impl)
    trainer = Trainer.build(cfg, tc, V, seed=0, device=device)
    rs = np.random.RandomState(0)
    batch = {"sentences": rs.randint(0, V, (B, L)),
             "neg_samples": rs.choice(V, K, replace=False),
             "obj_feats": rs.randn(B, R, F).astype(np.float32)}
    return trainer, {k: torch.as_tensor(v).to(trainer.device)
                     for k, v in batch.items()}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--source", action="store_true",
                    help="name each kernel's aten op and the port's "
                         "file:line, from one profiled eager step")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--length", type=int, default=20)
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float32"))
    common.add_device_flag(ap)
    args = ap.parse_args(argv)
    dev = common.device_for(args.device)

    trainer, batch = build(args.batch, args.length, args.dtype, dev)
    t0 = time.perf_counter()
    trainer.steps([batch] * (GRAPH_WARMUP_STEPS + 1))    # warm-ups, capture
    common.sync(dev)
    capture_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    metrics = trainer.steps([batch] * args.steps)
    common.sync(dev)
    wall = (time.perf_counter() - t0) / args.steps * 1e3
    print(f"wall per step: {wall:.2f} ms", flush=True)

    table, calls, busy = {}, {}, 0.0
    if dev.type == "cuda":
        table, busy = common.profile_kernels(lambda: trainer.steps([batch]),
                                             reps=args.steps, calls=calls)
    if table:
        print(f"device busy: {busy:.2f} ms/step over {args.steps} steps "
              f"(idle share {common.idle_share(busy, wall):.3f})",
              flush=True)
        print("by class: " + ", ".join(
            f"{cls} {r['ms']:.2f} ms x{r['launches']}"
            for cls, r in common.by_class(table).items()), flush=True)
    else:
        print("device total: not measured (no device trace)", flush=True)
    sources = {}
    if args.source and dev.type == "cuda":
        sources = common.traced_sources(lambda: trainer.step(batch))
    top = sorted(table.items(), key=lambda kv: -kv[1]["ms"])[:args.top]
    for name, rec in top:
        site = ("{} (x{})".format(*sources[name][0]) if name in sources
                else "")
        print(f"{rec['ms']:8.3f} ms  x{rec['count']:<5d} {name[:60]:60s} "
              f"{site[:120]}", flush=True)
    common.emit({
        "metric": "profile_step", "dtype": args.dtype, "batch": args.batch,
        "length": args.length, "steps": args.steps,
        "capture_s": capture_s, "wall_ms_per_step": wall,
        "device_ms_per_step": busy if table else "not measured",
        "idle_share": (common.idle_share(busy, wall) if table
                       else "not measured"),
        "kernels_per_step": sum(r["count"] for r in table.values()),
        "graph_launches_per_step": calls.get("cudaGraphLaunch", 0),
        "hand_kernels_per_step": common.hand_launches(table),
        "by_class": common.by_class(table),
        "total_loss_last": float(metrics[-1]["total_loss"]),
        "max_memory_allocated_bytes": common.peak_bytes(dev),
        "top": [{"name": name, "ms": rec["ms"], "launches": rec["count"],
                 "traced": rec["traced"],
                 **({"sources": sources[name]} if name in sources else {})}
                for name, rec in top],
        **common.device_record(dev)})


if __name__ == "__main__":
    main()
