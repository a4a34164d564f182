"""The L=40 memory levers on the card: selective remat against gradient
accumulation (the port's counterpart of tools/bench_l40.py).

At B=128, L=40 the unremated bf16 CLIORA step holds ~25 GB above the
trainer.  Remat recomputes chart levels; ``accum_steps`` halves the
activations of each microbatch without recompute.  Each config runs in a
fresh child process (an out-of-memory error, or a capture it breaks,
leaves nothing behind for the next) as ``Trainer.steps`` calls of
``STEPS`` steps: one warm call (the two eager warm-up steps, the capture,
the replays), then one timed call to a sync.  Prints one JSON line per
config, ``{"config", "ms_per_step" | null, "sents_per_sec", "peak_gb",
"error"}``, then a summary line.  Usage::

    python -m cliora_tpu_torch.tools.bench_l40           # all configs
    python -m cliora_tpu_torch.tools.bench_l40 --one '{"name": "accum_2",
        "remat": false, "remat_frac": 0.0, "accum": 2}'  # child mode
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from cliora_tpu_torch.tools import common
from cliora_tpu_torch.tools.common import D, E, F, KNEG, R, V

B, L = 128, 40
STEPS = 10
# at the JAX tool's 5e-4 the N(0, 1) init diverges to inf at L=40 within
# a few steps (PERF.md section 6, PR 13): the steps train at
# chip_smoke.py's REMAT_LR, so that every timed step is finite
LR = 1e-5
# the package's parent directory, where a child finds cliora_tpu_torch
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

CONFIGS = [
    {"name": "remat_frac_0.85", "remat": True, "remat_frac": 0.85,
     "accum": 1},
    {"name": "accum_2", "remat": False, "remat_frac": 0.0, "accum": 2},
    {"name": "accum_4", "remat": False, "remat_frac": 0.0, "accum": 4},
    {"name": "accum_2_remat_0.85", "remat": True, "remat_frac": 0.85,
     "accum": 2},
    # 'dots': matrix-product outputs saved, gathers and elementwise work
    # recomputed; swept over remat_frac for the fit edge
    {"name": "dots_frac_0.0", "remat": True, "remat_frac": 0.0,
     "accum": 1, "policy": "dots"},
    {"name": "dots_frac_0.5", "remat": True, "remat_frac": 0.5,
     "accum": 1, "policy": "dots"},
    {"name": "dots_frac_0.85", "remat": True, "remat_frac": 0.85,
     "accum": 1, "policy": "dots"},
    # 'gathers': everything saved but the chart-child gathers
    {"name": "gathers_frac_0.0", "remat": True, "remat_frac": 0.0,
     "accum": 1, "policy": "gathers"},
    {"name": "gathers_text", "remat": True, "remat_frac": 0.0,
     "accum": 1, "policy": "gathers", "text": True},
]


def run_one(spec: dict, dev: torch.device) -> dict:
    """Child mode: one config's ms a step (tools/bench_l40.py:68-111)."""
    from cliora_tpu_torch.models.config import ModelConfig
    from cliora_tpu_torch.training.trainer import TrainConfig, Trainer

    # text: the DIORA text pretrain (reconstruction only), where
    # accumulation is exact (no batch-coupled losses)
    text = spec.get("text", False)
    cfg = ModelConfig(size=D, input_size=E, use_obj=not text, n_regions=R,
                      obj_feat_size=F, compute_dtype="bfloat16",
                      remat=spec["remat"], remat_frac=spec["remat_frac"],
                      remat_policy=spec.get("policy", "full"))
    tc = TrainConfig(lr=LR, k_neg=KNEG, vg_loss=not text,
                     use_contr=not text, emb_trainable=True,
                     attn_impl="cuda", accum_steps=spec["accum"])
    trainer = Trainer.build(cfg, tc, V, seed=0, device=dev)
    rs = np.random.RandomState(0)
    batch = {"sentences": rs.randint(0, V, (B, L)),
             "neg_samples": rs.choice(V, KNEG, replace=False)}
    obj = rs.randn(B, R, F).astype(np.float32)
    if not text:
        batch["obj_feats"] = obj
    batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}

    trainer.steps([batch] * STEPS)               # warm-ups, capture, replays
    common.sync(dev)
    t0 = time.perf_counter()
    metrics = trainer.steps([batch] * STEPS)
    common.sync(dev)
    dt = time.perf_counter() - t0
    return {"config": spec["name"], "ms_per_step": round(1e3 * dt / STEPS, 1),
            "sents_per_sec": round(B * STEPS / dt, 1),
            "peak_gb": round(common.peak_bytes(dev) / 2 ** 30, 2)
            if dev.type == "cuda" else "not measured",
            "loss_finite": bool(np.isfinite(float(
                metrics[-1]["total_loss"]))),
            "error": None}


def error_tag(stderr: str) -> str:
    """What a failed child says: ``OOM`` where torch ran out of device
    memory, else its last line."""
    lines = (stderr or "").strip().splitlines()
    if any("OutOfMemoryError" in ln or "CUDA out of memory" in ln
           for ln in lines):
        return "OOM"
    return lines[-1][:200] if lines else "no output"


def start_child(spec: dict, device: str) -> subprocess.Popen:
    """One config's child process, started."""
    return subprocess.Popen(
        [sys.executable, "-m", "cliora_tpu_torch.tools.bench_l40",
         "--one", json.dumps(spec), "--device", device],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT)


def child_result(proc: subprocess.Popen, spec: dict,
                 timeout: float = 1200) -> dict:
    """A child's JSON line, or a record of why it failed; a child past
    ``timeout`` seconds is killed."""
    try:
        stdout, stderr = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        return {"config": spec["name"], "ms_per_step": None,
                "error": f"timeout after {timeout} s"}
    out = [ln for ln in stdout.splitlines() if ln.startswith("{")]
    if proc.returncode == 0 and out:
        return json.loads(out[-1])
    return {"config": spec["name"], "ms_per_step": None,
            "error": error_tag(stderr)}


def run_child(spec: dict, device: str, timeout: float = 1200) -> dict:
    """One config in a child process, to its end."""
    return child_result(start_child(spec, device), spec, timeout)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--one", help="child mode: JSON spec for one config")
    common.add_device_flag(ap)
    args = ap.parse_args(argv)
    dev = common.device_for(args.device)
    if args.one:
        common.emit(run_one(json.loads(args.one), dev))
        return
    results = []
    for spec in CONFIGS:
        rec = run_child(spec, str(dev))
        results.append(rec)
        common.emit(rec)
    common.emit({"metric": "bench_l40", "batch": B, "length": L,
                 "steps": STEPS, "configs": results,
                 **common.device_record(dev)})


if __name__ == "__main__":
    main()
