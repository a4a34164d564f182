#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (cliora_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds every CUDA kernel of the port's main path from the sources in
this checkout, holds each against its plain PyTorch version on the card,
drives the DIORA text parse end to end through ``Trainer.parse`` at the
full width of the README's quick-start model (hidden 400, embeddings
1024, vocab 10,000, random weights from a seed; parse requests of 128
sentences of length 20), checks the parses, and times the kernel against
its plain version and its bound.

Prints one JSON object per phase, then the ``kernels`` summary, then the
card's name and power limit as nvidia-smi reports them, and last
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero
before the last line; without a CUDA device it exits non-zero at once.
No check falls back to the CPU.
"""

import dataclasses
import json
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from cliora_tpu_torch import kernels, native
from cliora_tpu_torch.analysis import trees
from cliora_tpu_torch.chart.offsets import ncells
from cliora_tpu_torch.models.config import ModelConfig
from cliora_tpu_torch.models.diora import embed_span, leaf_transform
from cliora_tpu_torch.models.params import to_device
from cliora_tpu_torch.ops import inside_cky
from cliora_tpu_torch.training.trainer import TrainConfig, Trainer

B, N, D, E, V = 128, 20, 400, 1024, 10_000
SEED = 0
F32_ATOL = 1e-4          # inside_s and CKY value, kernel vs plain, f32
BF16_BP_AGREE = 0.99     # bf16 backpointer agreement, kernel vs plain
# bf16 inside_s and CKY value, kernel vs plain: the two round the h chart
# at different points; observed 0.021 at 128x20 on an H100, against
# scores whose mean magnitude is printed beside it (``mean_abs_s``)
BF16_ATOL = 0.1
# The bf16 kernel and the bf16 plain chart pass round at different points
# (l M kept in f32 vs stored in bf16); a sanity floor, not a contract.
BF16_ROUTE_AGREE = 0.95
# Published H100 SXM peaks (NVIDIA data sheet, dense): f32 without the
# tensor cores, bf16 on the tensor cores, HBM3 bandwidth.
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12
KERNELS = {
    "inside_cky": {
        "route": "cuda",
        "source": "cliora_tpu_torch/csrc/inside_cky.cu",
        "replaces": "cliora_tpu/ops/pallas_chart.py:122",
    },
}
# the __global__ functions of each kernel's source, as the profiler names
# them: its CUDA launches per call are counted from the profile
DEVICE_FUNCS = {
    "inside_cky": re.compile(
        r"::(prep_weights|init_leaves|project|fc0|fc1|combine)<"),
}


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, what):
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(lines):
    regs = [int(m.group(1)) for line in lines
            for m in [re.search(r"Used (\d+) registers", line)] if m]
    spills = sum(int(x) for line in lines
                 for x in re.findall(r"(\d+) bytes spill", line))
    return {"max_registers": max(regs, default=None), "spill_bytes": spills}


def leaves(tr, tokens):
    x_span = embed_span(tr.params["embed"],
                        torch.as_tensor(tokens).to(tr.device))
    return leaf_transform(tr.cfg, tr.params["diora"], x_span)


def flops_and_bytes(b, n, d):
    """Work of one kernel call.  FLOP: 6 D^2 per chart cell below the root
    (its projections W0[:, :D] h, W0[:, D:] h, h M) + 2 D^2 + 2 D per
    (cell, split) row (fc1 and the dot of l M with r).  Bytes: f32 leaves
    and weights read once, the three (B, ncells) outputs written once."""
    rows = b * sum((n - lvl) * lvl for lvl in range(1, n))
    cells = b * (ncells(n) - 1)
    flops = cells * 6 * d * d + rows * (2 * d * d + 2 * d)
    nbytes = 4 * (b * n * d + 4 * d * d + 2 * d + 3 * b * ncells(n))
    return flops, nbytes, rows


def bound(b, n, d, dtype):
    flops, nbytes, rows = flops_and_bytes(b, n, d)
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    # the TPU kernel's formulation (fc0 and l M per row: 8 D^2 + 2 D per
    # row), for comparison with its FLOP count
    per_row = rows * (8 * d * d + 2 * d)
    return {"flop": flops, "bytes": nbytes,
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flop_per_row_formulation": per_row,
            "bound_ms_per_row_formulation": per_row / PEAK_FLOPS[dtype] * 1e3}


def cuda_ms(fn, reps=10, runs=5):
    """Per-call ms of ``fn`` over ``runs`` runs of ``reps`` warm calls,
    timed with CUDA events."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / reps)
    return out


def kernel_vs_plain(dp, h0, dtype):
    got = inside_cky.fused_inside_cky(dp, h0, compute_dtype=dtype)
    torch.cuda.synchronize()
    want = inside_cky.fused_inside_cky_plain(dp, h0, compute_dtype=dtype)
    torch.cuda.synchronize()
    (s, bp, val), (ps, pbp, pval) = got, want
    differ = int((bp != pbp).sum().item())
    return {
        "max_abs_err": max((s - ps).abs().max().item(),
                           (val - pval).abs().max().item()),
        "bp_agree": 1.0 - differ / bp.numel(),
        "cells_differ": differ,
        "mean_abs_s": ps.abs().mean().item(),
        "finite": bool(torch.isfinite(s).all() and torch.isfinite(val).all()),
        "shapes_ok": (tuple(s.shape) == (h0.shape[0], ncells(h0.shape[1]), 1)
                      and bp.dtype == torch.int32),
    }


def profile_kernels(fn):
    """Device ms by CUDA kernel name over one call of ``fn``; empty when
    the profiler sees no device activity."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            rec = by_name.setdefault(evt.name[:60], {"ms": 0.0, "count": 0})
            rec["ms"] += evt.device_time_total / 1e3
            rec["count"] += 1
    return by_name


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "the card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    # the plain versions are the reference: full f32 matmuls, no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    emit({"phase": "env", "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "allow_tf32": {"matmul": False, "cudnn": False}})

    # -- build every kernel of the path from this checkout's sources
    built = kernels.build(list(KERNELS), force=True)
    for name in KERNELS:
        rec = built[name]
        emit({"phase": "build", "kernel": name, "seconds": rec["seconds"],
              **ptxas_summary(rec["ptxas"]), "ptxas": rec["ptxas"]})
    # the host decoder builds at first use too: build it here, not inside
    # the first timed request
    t0 = time.perf_counter()
    decoder_mod = native.load()
    emit({"phase": "build", "decoder": "native" if decoder_mod else "python",
          "seconds": time.perf_counter() - t0})

    # -- the model: README quick-start DIORA at full width, random weights
    cfg32 = ModelConfig(size=D, input_size=E)
    tr32 = Trainer.build(cfg32, TrainConfig(), V, seed=SEED)
    check(tr32.device.type == "cuda", "trainer is not on the card")
    tr16 = Trainer(dataclasses.replace(cfg32, compute_dtype="bfloat16"),
                   TrainConfig(), tr32.params)
    dp = tr32.params["diora"]
    rs = np.random.RandomState(SEED)

    # -- each kernel vs its plain version, at the main path's shapes
    checked = {}
    for (b, n) in ((B, N), (B, 3), (37, 12)):
        with torch.no_grad():
            h0 = leaves(tr32, rs.randint(0, V, (b, n)))
            for dtype in ("float32", "bfloat16"):
                rec = kernel_vs_plain(dp, h0, dtype)
                emit({"phase": "kernel", "name": "inside_cky", "dtype": dtype,
                      "shape": [b, n, D], **rec})
                check(rec["finite"] and rec["shapes_ok"],
                      f"inside_cky {dtype} {b}x{n}: non-finite or bad shape")
                if dtype == "float32":
                    check(rec["cells_differ"] == 0
                          and rec["max_abs_err"] <= F32_ATOL,
                          f"inside_cky f32 {b}x{n} disagrees with plain")
                else:
                    check(rec["bp_agree"] >= BF16_BP_AGREE
                          and rec["max_abs_err"] <= BF16_ATOL,
                          f"inside_cky bf16 {b}x{n} disagrees with plain: "
                          f"bp agreement {rec['bp_agree']}, max abs error "
                          f"{rec['max_abs_err']}")
                checked[(b, n, dtype)] = rec

    # -- the main path: parse requests through Trainer.parse + decode
    batches = [{"sentences": rs.randint(0, V, (B, N))} for _ in range(5)]
    bf16_batch = {"sentences": rs.randint(0, V, (B, N))}
    len_batch = {"sentences": rs.randint(0, V, (B, N)),
                 "lengths": rs.randint(2, N + 1, B).astype(np.int32)}
    plan = ([("float32", tr32, bt) for bt in batches]
            + [("bfloat16", tr16, bf16_batch), ("float32", tr32, len_batch)])
    done = []
    inside_cky.launches = 0
    for dtype, tr, batch in plan:
        before = inside_cky.launches
        t0 = time.perf_counter()
        res, _ = tr.parse(batch)
        t1 = time.perf_counter()
        decoded = trees.decode_batch(res["cky_bp"], N, batch.get("lengths"))
        t2 = time.perf_counter()
        done.append((dtype, tr, batch, res, decoded, trees.last_decoder,
                     before, inside_cky.launches, t1 - t0, t2 - t1))
    main_launches = {"inside_cky": inside_cky.launches}

    for i, (dtype, tr, batch, res, decoded, decoder, before, after, t_parse,
            t_dec) in enumerate(done):
        rec = {"phase": "parse", "request": i, "dtype": dtype, "batch": B,
               "n": N, "lengths": "lengths" in batch,
               "parse_impl": res["parse_impl"],
               "launches_delta": after - before,
               "ms": (t_parse + t_dec) * 1e3, "parse_ms": t_parse * 1e3,
               "decode_ms": t_dec * 1e3,
               "sentences_per_s": B / (t_parse + t_dec),
               "decoder": decoder}
        plain, _ = tr.parse(batch, impl="plain")
        differ = int(np.sum(plain["cky_bp"] != res["cky_bp"]))
        agree = 1.0 - differ / plain["cky_bp"].size
        # the kernel and the plain chart pass group fc0's sums differently
        # (two K=D products vs one K=2D product), so a near-tie split may
        # flip on a rare cell even at f32; the trees are what is held
        rec["bp_agree_plain_route"] = agree
        rec["cells_differ_plain_route"] = differ
        if "lengths" in batch:
            check(res["parse_impl"] == "plain" and after == before,
                  "lengths request did not take the plain route")
            # inside values of valid cells depend only on valid cells:
            # each padded sentence parses as it does alone at its length
            alone = []
            for j in range(4):
                m = int(batch["lengths"][j])
                one, _ = tr.parse({"sentences": batch["sentences"][j:j + 1,
                                                                   :m]})
                alone.append(trees.decode_batch(one["cky_bp"], m)[0][0])
            rec["trees_equal_alone"] = alone == [t for t, _ in decoded[:4]]
            check(rec["trees_equal_alone"], "padded parse != parse alone")
        else:
            check(res["parse_impl"] == "cuda" and after - before == 1,
                  f"request {i} did not run the CUDA kernel")
        if dtype == "float32":
            rec["trees_equal_plain_route"] = decoded == trees.decode_batch(
                plain["cky_bp"], N, batch.get("lengths"))
            check(rec["trees_equal_plain_route"],
                  f"request {i}: trees differ from the plain route")
        else:
            check(agree >= BF16_ROUTE_AGREE,
                  f"bf16 request: bp agreement with plain route {agree}")
        emit(rec)
    check(main_launches["inside_cky"] >= 5, "main path skipped the kernel")

    # the card agrees with the CPU on a small input
    small = {"sentences": rs.randint(0, V, (37, 12))}
    cpu = Trainer(cfg32, TrainConfig(), to_device(tr32.params, "cpu"),
                  device="cpu")
    on_card, _ = tr32.parse(small)
    on_cpu, _ = cpu.parse(small)
    differ = int(np.sum(on_card["cky_bp"] != on_cpu["cky_bp"]))
    emit({"phase": "cpu_reference", "shape": [37, 12, D],
          "card_route": on_card["parse_impl"],
          "cpu_route": on_cpu["parse_impl"], "cells_differ": differ})
    check(differ == 0, "card and CPU parses differ at f32")

    # -- timing at the main shape: plain, kernel, kernel, plain
    timing = {}
    with torch.no_grad():
        h0 = leaves(tr32, batches[0]["sentences"])
        for dtype in ("float32", "bfloat16"):
            def kern():
                return inside_cky.fused_inside_cky(dp, h0, compute_dtype=dtype)

            def plain():
                return inside_cky.fused_inside_cky_plain(dp, h0,
                                                         compute_dtype=dtype)

            p1, k1, k2, p2 = (cuda_ms(plain), cuda_ms(kern), cuda_ms(kern),
                              cuda_ms(plain))
            by_kernel = profile_kernels(kern)
            own = [r["count"] for name, r in by_kernel.items()
                   if DEVICE_FUNCS["inside_cky"].search(name)]
            rec = {"ms": statistics.median(k1 + k2),
                   "plain_ms": statistics.median(p1 + p2),
                   **bound(B, N, D, dtype), "library_ms": None,
                   "kernel_runs_ms": k1 + k2, "plain_runs_ms": p1 + p2,
                   "cuda_launches_per_call": (sum(own) if own
                                              else "not measured")}
            timing[dtype] = rec
            emit({"phase": "timing", "name": "inside_cky", "dtype": dtype,
                  "shape": [B, N, D], **rec})
            emit({"phase": "profile", "name": "inside_cky", "dtype": dtype,
                  "device_ms": (sum(r["ms"] for r in by_kernel.values())
                                if by_kernel else "not measured"),
                  "by_kernel": by_kernel})

    # one request's device busy share, against the unprofiled request
    # time (median of the warm f32 kernel-route requests above)
    def request():
        res, _ = tr32.parse(batches[1])
        trees.decode_batch(res["cky_bp"], N)

    wall = statistics.median((d[-2] + d[-1]) * 1e3 for d in done[1:5])
    by_kernel = profile_kernels(request)
    busy = sum(r["ms"] for r in by_kernel.values())
    emit({"phase": "request_profile", "batch": B, "n": N,
          "request_ms": wall,
          "device_busy_ms": busy if by_kernel else "not measured",
          "idle_share": 1 - busy / wall if by_kernel else "not measured",
          "by_kernel": by_kernel})

    f32 = timing["float32"]
    main_rec = checked[(B, N, "float32")]
    emit({"kernels": [{
        "name": name, **meta, "launches": main_launches[name],
        "max_abs_err": main_rec["max_abs_err"], "ms": f32["ms"],
        "plain_ms": f32["plain_ms"], "bound_ms": f32["bound_ms"],
        "bound_by": f32["bound_by"], "library_ms": None,
        "dtype": "float32", "shape": [B, N, D],
        "cuda_launches_per_call": f32["cuda_launches_per_call"],
        "bf16": {k: timing["bfloat16"][k]
                 for k in ("ms", "plain_ms", "bound_ms", "bound_by")}
        | {"bp_agree": checked[(B, N, "bfloat16")]["bp_agree"]},
    } for name, meta in KERNELS.items()]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
