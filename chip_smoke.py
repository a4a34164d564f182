#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (cliora_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds every CUDA kernel of the port's paths from the sources in this
checkout (one nvcc per source, started together), holds each against its
plain PyTorch version on the card, and drives the port's paths at full
width with random weights from a seed:

  * the DIORA text parse through ``Trainer.parse`` (README quick-start
    model: hidden 400, embeddings 1024, vocab 10,000; requests of 128
    sentences of length 20), kernel K1;
  * the CLIORA parse (bench.py's model below, image encoder moved off its
    zero init): 7 requests in f32 and 7 in bf16 through
    ``Trainer.parse(compute_loss=True, outside=True)``, each decoded,
    its phrases grounded and its predicted spans boxed, as the JAX
    package's parse script serves them; a small parse card vs CPU;
    ``run_eval`` over 4 full-width batches (one ragged, one of length 2);
    ``.npz`` and reference ``.pt`` checkpoint trips.  It launches none of
    K1-K4 (the plain route, as under the JAX gating), and fails if any of
    their counters moves;
  * the CLIORA train step through ``Trainer.step`` (the configuration of
    bench.py: B=128, L=20, D=400, E=1024, V=10,000, k_neg=100, 36 regions
    x 2048-d features, bf16 and f32, the fused span x region route
    ``attn_impl='cuda'``), kernels K2-K4;
  * the same steps through ``Trainer.steps`` (phase ``train_graphs``):
    the warm-up steps, one step captured as a CUDA graph and replayed --
    capture ms, graphed step ms over 10 steps with one sync, device-busy
    ms and idle share of a profiled replay, graph launches and device
    kernels a step, K2-K4 by name in the replayed step (2 each), peak
    memory, beside the eager ``train`` summary; graphed against eager
    steps over 3 batches in f32 and bf16 at dropout 0 and 0.1;
    ``accum_steps=2`` at full width (K2-K4 4 times a step) and on a small
    step against the CPU; an optimizer-state checkpoint trip whose
    resumed step has the uninterrupted one's bits; and a capture that
    fails raises rather than stepping eagerly;
  * the port's CLIs on a synthetic grounded corpus (phase ``cli``);
  * every other model the JAX package builds: the TreeLSTM compose at
    the bench configuration in bf16 and f32 (phase ``treelstm``: eager and
    graphed steps, K2-K4 twice a replay, graphed against eager bits, a
    TreeLSTM DIORA parse on the plain route, the card against the CPU);
    remat of the chart levels at B=128, L=40, bf16 (phase ``remat``: the
    unremated step and the full, selective, dots and gathers policies,
    each graphed, with step ms and peak memory; each against the
    unremated gradients at dropout 0.1; graphed against eager bits; the
    unremated peaks that calibrate the auto-remat estimate); the
    chart-free ``word`` baseline (phase ``word``: no hand kernel); and the
    train CLI with ``--arch treelstm``, ``--arch word`` and ``--remat
    --remat_frac 0.85`` (phase ``cli_archs``);
  * serving (phase ``serve``): the README quick-start model exported by
    ``scripts/export_model.py`` (buckets 10/20/40, symbolic batch, weights
    as inputs and baked; four export processes at once with the CLIORA
    bundle below), loaded by ``ExportedParser`` and warmed to 64 rows (21
    CUDA graphs in one pool), 512 sentences of 2-40 tokens through
    ``parse`` in calls of 64 rows, the HTTP server of ``scripts/serve.py``
    (16 clients x 16 one-sentence requests micro-batched, then serialized
    behind a lock), a restarted server process, and the CLIORA train
    step's model as a bundle (128 sentences with 36 x 2048-d regions,
    and a parse racing ``warmup_async``); every served output equals
    ``Trainer.parse(impl="plain")`` on the same padded rows and every
    replay its eager program, bit for bit; no call after warmup runs
    eagerly; none of K1-K4 is launched;

checks the parses, the losses and their descent, the kernel route
against the plain ``chunked`` route and a small step against the CPU,
and times each kernel against its plain version and its bound.  K1 is
checked at the parse shapes and at the shapes of the card-only test
(tests/test_torch_inside_cky.py: D = 48, 24 and 16, one without the
unit norm), twice per call to show it repeats bit for bit, and its
timing breaks down by device function (project, fc0, fc1, combine: ms,
launches, TFLOP/s or GB/s).  K2-K4
are checked at the step's calls (VG f32, contrastive bf16 and f32), an
odd shape and the edges of the Hopper tiles, and timed at the three
calls; K2 (wgmma + TMA) and K4 (a one-hot GEMM on the tensor cores) are
also timed against a ``torch.matmul`` of the same bf16 operands (the
product alone), K3 and K4 on the all-ties argmax of init against random
argmax, K4's f32 route against the bf16 GEMM on a two-term split of the
span, K3 beside its shared-memory floor and the image segments it took,
and K3 with its argmax and g staged in 8-byte against 4-byte copies.  At
the VG and f32 contrastive calls K2's f32 route is also timed against a
``torch.matmul`` of the same f32 operands with TF32 off, and K4's f32
route (accumulators in registers) on all-ties against random argmax; the
build fails if that K4 kernel spills.

Prints one JSON object per phase, then the ``kernels`` summary, then the
card's name and power limit as nvidia-smi reports them, and last
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero
before the last line; without a CUDA device it exits non-zero at once.
No check falls back to the CPU.
"""

import contextlib
import dataclasses
import gc
import importlib.util
import io
import json
import math
import os
import pickle
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from cliora_tpu_torch import kernels, native, serving
from cliora_tpu_torch.analysis import trees
from cliora_tpu_torch.analysis.eval import run_eval
from cliora_tpu_torch.analysis.grounding import ground_phrases, span_pred_boxes
from cliora_tpu_torch.chart.offsets import ncells
from cliora_tpu_torch.data.prefetch import device_prefetch
from cliora_tpu_torch.models.config import ModelConfig
from cliora_tpu_torch.models.diora import embed_span, leaf_transform
from cliora_tpu_torch.models.params import init_diora_params, to_device
from cliora_tpu_torch.ops import chart_pass, inside_cky, span_region
from cliora_tpu_torch.ops.core import unit_norm
from cliora_tpu_torch.scripts import common as cli_common
from cliora_tpu_torch.scripts import export_model as cli_export
from cliora_tpu_torch.scripts import parse as cli_parse
from cliora_tpu_torch.scripts import parse_diora as cli_parse_diora
from cliora_tpu_torch.scripts import serve as cli_serve
from cliora_tpu_torch.scripts import train as cli_train
from cliora_tpu_torch.training import trainer as trainer_mod
from cliora_tpu_torch.training.checkpoint import (
    export_torch_checkpoint,
    flatten,
    import_torch_checkpoint,
    load_opt_state,
    load_params,
    params_from_numpy,
    save_opt_state,
    save_params,
)
from cliora_tpu_torch.training.trainer import (
    GRAPH_WARMUP_STEPS,
    TrainConfig,
    Trainer,
    compute_losses,
    tree_leaves,
)
from cliora_tpu_torch.utils import flags as cli_flags

B, N, D, E, V = 128, 20, 400, 1024, 10_000
K_NEG, R, F = 100, 36, 2048        # bench.py:42
TRAIN_STEPS = 10
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
# span x region kernels vs their plain versions, as a fraction of the
# largest magnitude of the plain result (at least 1).  f32: the sums differ
# in order only.  bf16 K2: both take exact bf16 products with f32 sums, the
# tensor cores in their own order; bf16 K3: the f32 sum is rounded to bf16
# once, so two orders may land one bf16 step (2^-8 relative) apart.
SR_F32_RTOL = 1e-4
SR_BF16_MAX_RTOL = 1e-3
SR_BF16_ARGMAX_AGREE = 0.99
SR_BF16_DSPAN_RTOL = 1e-2
# the kernel route vs the chunked route, one full-width train step
ROUTE_LOSS_RTOL = {"float32": 1e-4, "bfloat16": 1e-2}
ROUTE_GRAD_COS = {"float32": 0.999, "bfloat16": 0.99}
CPU_LOSS_RTOL = 1e-5     # a small f32 step, card vs CPU
# Trainer.steps as a replayed CUDA graph: the timed steps() call, and the
# tolerances of graphed against eager steps -- the JAX package's for its
# steps against step (tests/test_training.py:144-155)
GRAPH_STEPS = 10
STEPS_LOSS_RTOL = 1e-5
STEPS_PARAM_ATOL = 1e-6
# accum_steps=2 on a small step, card vs CPU: the losses at CPU_LOSS_RTOL,
# the clipped gradients at SR_F32_RTOL of each leaf's largest magnitude
# (at least 1), the updated parameters at the port's one-step check
# against JAX (tests/test_torch_train_step.py): 1e-3 * lr on the entries
# whose gradient exceeds 1e-6
ONE_STEP_PARAM_ATOL_LR = 1e-3
# host-side calls that put work on the card, as the profiler names them
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync",
                "cudaGraphLaunch")
# the CLIORA parse: requests per dtype, and a small parse card vs CPU
# (scores as absolute error, metrics relative)
PARSE_REQUESTS = 7
PARSE_CPU_SCORE_ATOL = 1e-4
PARSE_CPU_LOSS_RTOL = 1e-4
# Stand-in grounding traffic: no source in the repo gives Flickr30K
# Entities' phrases per caption or their lengths, so each row gets this
# many phrases of 1-4 words on uniform random boxes.  ground_phrases' cost
# grows with the phrase count: it is timed apart from the rest of the
# request and reported per phrase, so it can be scaled to a real count.
PHRASES_PER_ROW = 3
# Published H100 SXM peaks (NVIDIA data sheet, dense): f32 without the
# tensor cores, bf16 on the tensor cores, HBM3 bandwidth.
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12
# Hopper shared memory: 128 bytes a clock on each of the H100 SXM's 132 SMs
SMS, SMEM_BYTES_PER_CLOCK = 132, 128
SOURCES = ("inside_cky", "span_region")
KERNELS = {
    "inside_cky": {
        "route": "cuda",
        "source": "cliora_tpu_torch/csrc/inside_cky.cu",
        "replaces": "cliora_tpu/ops/pallas_chart.py:122",
    },
    "span_region_fwd": {
        "route": "cuda",
        "source": "cliora_tpu_torch/csrc/span_region.cu",
        "replaces": "cliora_tpu/ops/span_region.py:65",
    },
    "span_region_dspan": {
        "route": "cuda",
        "source": "cliora_tpu_torch/csrc/span_region.cu",
        "replaces": "cliora_tpu/ops/span_region.py:156",
    },
    "span_region_dobj": {
        "route": "cuda",
        "source": "cliora_tpu_torch/csrc/span_region.cu",
        "replaces": "cliora_tpu/ops/span_region.py:177",
    },
}
# K1's device functions as the profiler names them (f32: fc0, fc1_simt,
# project_simt; bf16: fc1_wgmma, project_wgmma)
K1_FUNCS = re.compile(r"::(prep_weights|init_leaves|combine|fc0|project_simt|"
                      r"project_wgmma|fc1_simt|fc1_wgmma)[<(]")
# the __global__ functions of each kernel, as the profiler names them: its
# CUDA launches per call are counted from the profile
DEVICE_FUNCS = {
    "inside_cky": K1_FUNCS,
    "span_region_fwd": re.compile(r"::k2_fwd_(bf16<|f32\()"),
    "span_region_dspan": re.compile(r"::k3_dspan<"),
    "span_region_dobj": re.compile(r"::k4_dobj_(gemm\(|f32<|regs\()"),
    # the second pass of K3 and K4 where they cut their sums into segments
    "segment_reduce": re.compile(r"::segment_reduce<"),
}
SR_KERNELS = ("span_region_fwd", "span_region_dspan", "span_region_dobj")
# the device functions and formulation of each kernel's f32 route at the
# model's R = 36 (the VG call, and the contrastive call of the f32 step)
SR_F32_ROUTES = {
    "span_region_fwd": {
        "device_functions": ["k2_fwd_f32"],
        "formulation": "f32 FMA on the CUDA cores, each score summed over D "
                       "in order from 0 (the order of torch's f32 GEMM); "
                       "max/argmax from a shared-memory score tile"},
    "span_region_dspan": {
        "device_functions": ["k3_dspan", "segment_reduce"],
        "formulation": "gather of obj rows from shared memory, f32 FMA"},
    "span_region_dobj": {
        "device_functions": ["k4_dobj_regs", "segment_reduce"],
        "formulation": "argmax-routed f32 FMA, one fmaf a row per entry in "
                       "row order, accumulators in registers"},
}
# phase cli: a synthetic grounded corpus in the Flickr layout
# (tools/make_synthetic_flickr.py: 4-16 tokens, up to 12 regions an image
# padded to 36, 2048-d features), and the shell scripts' flags less their
# paths (scripts/train_diora.sh, scripts/train_cliora.sh), each run with
# graphed steps in same-shape runs of 10
ROOT = os.path.dirname(os.path.abspath(__file__))
CLI_TRAIN, CLI_TEST = 4096, 512
_SCRIPT_FLAGS = ["--seed", "1234", "--arch", "mlp", "--batch_size", "32",
                 "--emb", "none", "--hidden_dim", "400", "--k_neg", "100",
                 "--log_every_batch", "100", "--normalize", "unit",
                 "--reconstruct_mode", "softmax",
                 "--train_filter_length", "40"]
DIORA_FLAGS = _SCRIPT_FLAGS + ["--lr", "5e-4"]
CLIORA_FLAGS = _SCRIPT_FLAGS + ["--lr", "1e-5", "--obj_feats", "--use_contr",
                                "--alpha_contr", "1.0", "--vg_loss",
                                "--alpha_vg", "1.0"]
CLI_RUN_FLAGS = ["--steps_per_call", "10", "--batch_order", "blocked"]
# kernels of span_region.cu that ptxas must compile without spills
NO_SPILL = ("k4_dobj_regs",)
# K1 at the shapes of its card-only test (B, n, D, norm): odd widths, one
# k tile, one level, no unit norm
K1_TEST_SHAPES = ((5, 7, 48, "unit"), (2, 2, 24, "unit"), (6, 3, 16, "none"))


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


def max_sm_clock_hz():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def ptxas_summary(lines):
    regs = [int(m.group(1)) for line in lines
            for m in [re.search(r"Used (\d+) registers", line)] if m]
    spills = sum(int(x) for line in lines
                 for x in re.findall(r"(\d+) bytes spill", line))
    return {"max_registers": max(regs, default=None), "spill_bytes": spills,
            "by_function": ptxas_by_function(lines)}


def kernel_name(mangled):
    """``name<template arguments as mangled>`` of a mangled __global__
    function in a namespace, e.g. ``k2_fwd_bf16<Li36E>``."""
    rest, name = mangled[3:], mangled
    while (m := re.match(r"\d+", rest)):
        n = int(m.group(0))
        name, rest = rest[m.end():m.end() + n], rest[m.end() + n:]
    if rest.startswith("I") and "EEv" in rest:
        return f"{name}<{rest[1:rest.index('EEv')]}>"
    return name


def ptxas_by_function(lines):
    """Registers and spill bytes of each compiled kernel, by
    :func:`kernel_name`."""
    out, cur = {}, None
    for line in lines:
        m = re.search(r"Compiling entry function '(_ZN\w+)'", line)
        if m:
            cur = kernel_name(m.group(1))
            out[cur] = {"registers": None, "spill_bytes": 0}
            continue
        if cur is None:
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[cur]["registers"] = int(m.group(1))
        out[cur]["spill_bytes"] += sum(
            int(x) for x in re.findall(r"(\d+) bytes spill", line))
    return out


def leaves(tr, tokens):
    x_span = embed_span(tr.params["embed"],
                        torch.as_tensor(tokens).to(tr.device))
    return leaf_transform(tr.cfg, tr.params["diora"], x_span)[0]


def flops_and_bytes(b, n, d):
    """Work of one K1 call.  FLOP: 6 D^2 per chart cell below the root
    (its projections W0[:, :D] h, W0[:, D:] h, h M) + 2 D^2 + 2 D per
    (cell, split) row (fc1 and the dot of l M with r).  Bytes: f32 leaves
    and weights read once, the three (B, ncells) outputs written once."""
    rows = b * sum((n - lvl) * lvl for lvl in range(1, n))
    cells = b * (ncells(n) - 1)
    flops = cells * 6 * d * d + rows * (2 * d * d + 2 * d)
    nbytes = 4 * (b * n * d + 4 * d * d + 2 * d + 3 * b * ncells(n))
    return flops, nbytes, rows


def roofline(flops, nbytes, peak_flops):
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return {"flop": flops, "bytes": nbytes,
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def bound(b, n, d, dtype):
    flops, nbytes, rows = flops_and_bytes(b, n, d)
    # the TPU kernel's formulation (fc0 and l M per row: 8 D^2 + 2 D per
    # row), for comparison with its FLOP count
    per_row = rows * (8 * d * d + 2 * d)
    return {**roofline(flops, nbytes, PEAK_FLOPS[dtype]),
            "flop_per_row_formulation": per_row,
            "bound_ms_per_row_formulation": per_row / PEAK_FLOPS[dtype] * 1e3}


def sr_bound(name, span, obj):
    """Work of one K2/K3/K4 call on these inputs.  K2: 2 A M C R D FLOP in
    the span dtype; reads span and the span-dtype obj, writes max and
    argmax (A, C, M) f32 + int32.  K3: 2 A M C D FLOP of f32 FMA on the
    CUDA cores; reads g, argmax and f32 obj, writes dspan in the span
    dtype; beside it the shared-memory floor of its gather formulation.
    K4: the same FLOP; reads span, g and argmax, writes f32 dobj; on f32
    spans with R = 36 beside it the floor of its formulation, the span
    slices (256 columns, the last one zero-filled past D) read once from
    shared memory per (row, image)."""
    A, M, Dd = span.shape
    C, Rr, _ = obj.shape
    es = span.element_size()
    gam = 8 * A * C * M                  # g f32 + argmax int32
    if name == "span_region_fwd":
        dtype = "bfloat16" if span.dtype == torch.bfloat16 else "float32"
        return roofline(2 * A * M * C * Rr * Dd,
                        es * (A * M * Dd + C * Rr * Dd) + gam,
                        PEAK_FLOPS[dtype])
    flops = 2 * A * M * C * Dd
    if name == "span_region_dspan":
        return (roofline(flops, gam + 4 * C * Rr * Dd + es * A * M * Dd,
                         PEAK_FLOPS["float32"])
                | smem_floor(A, M, C, Dd))
    rec = roofline(flops, es * A * M * Dd + gam + 4 * C * Rr * Dd,
                   PEAK_FLOPS["float32"])
    if span.dtype == torch.float32 and Rr == 36:
        rec |= smem_floor(A, M, C, 256 * -(-Dd // 256))
    return rec


def smem_floor(A, M, C, Dd):
    """The floor of a formulation that reads A M C D f32 entries once from
    shared memory (K3 gathers obj rows, K4's f32 route reads span rows),
    at the shared-memory rate of the card's maximum SM clock."""
    nbytes = 4 * A * M * C * Dd
    clock = max_sm_clock_hz()
    return {"smem_gather_bytes": nbytes, "sm_clock_max_hz": clock,
            "smem_floor_ms": nbytes / (SMS * SMEM_BYTES_PER_CLOCK * clock)
            * 1e3}


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


def kernel_vs_plain(dp, h0, dtype, norm="unit"):
    got = inside_cky.fused_inside_cky(dp, h0, norm=norm, compute_dtype=dtype)
    torch.cuda.synchronize()
    want = inside_cky.fused_inside_cky_plain(dp, h0, norm=norm,
                                             compute_dtype=dtype)
    again = inside_cky.fused_inside_cky(dp, h0, norm=norm,
                                        compute_dtype=dtype)
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
        "bitwise_repeat": all(torch.equal(a, b) for a, b in zip(got, again)),
    }


def check_k1(rec, what):
    check(rec["finite"] and rec["shapes_ok"], f"{what}: non-finite or bad shape")
    check(rec["bitwise_repeat"], f"{what}: two calls differ")
    if rec["dtype"] == "float32":
        check(rec["cells_differ"] == 0 and rec["max_abs_err"] <= F32_ATOL,
              f"{what} disagrees with plain")
    else:
        check(rec["bp_agree"] >= BF16_BP_AGREE
              and rec["max_abs_err"] <= BF16_ATOL,
              f"{what} disagrees with plain: bp agreement "
              f"{rec['bp_agree']}, max abs error {rec['max_abs_err']}")


def k1_by_function(by_kernel, b, n, d, dtype):
    """K1's profile per device function: ms and launches per call, and the
    rate of its work.  project: 6 D^2 FLOP per cell below the root; fc1:
    2 D^2 per (cell, split) row; fc0: the f32 P_l and P_r slices read and
    h1 written per row; combine: l M (f32), r and hk (chart dtype) read
    per row, the cell's h written."""
    es = 2 if dtype == "bfloat16" else 4
    rows = b * sum((n - lvl) * lvl for lvl in range(1, n))
    cells = b * (ncells(n) - 1)
    work = {"project": ("flop", cells * 6 * d * d),
            "fc1": ("flop", rows * 2 * d * d),
            "fc0": ("bytes", rows * d * 12),
            "combine": ("bytes", rows * d * (4 + 2 * es)
                        + b * (ncells(n) - n) * d * es)}
    out = {}
    for name, rec in by_kernel.items():
        m = K1_FUNCS.search(name)
        if not m:
            continue
        fn = m.group(1)
        row = out.setdefault(fn, {"ms": 0.0, "launches": 0})
        row["ms"] += rec["ms"]
        row["launches"] += rec["count"]
    for fn, row in out.items():
        kind, amount = work.get(fn.split("_")[0], (None, None))
        if kind == "flop":
            row["flop"] = amount
            row["tflop_s"] = amount / row["ms"] / 1e9
        elif kind == "bytes":
            row["bytes"] = amount
            row["gb_s"] = amount / row["ms"] / 1e6
    return out


def profile_kernels(fn, reps=1, calls=None):
    """Device ms and launches by CUDA kernel name per call of ``fn``, over
    ``reps`` calls; empty when the profiler sees no device activity.  A
    trace can miss the first kernel launched after it starts, so a short
    spin kernel (``torch.cuda._sleep``) runs first and is left out of the
    result.  It can also miss a later launch, so a count per call is
    rounded from several calls, ms is the mean of the launches the trace
    holds times that count (a kernel of fewer than one launch a call
    gets its ms over ``reps``), and ``traced`` says how many it holds.
    ``calls``, a dict, receives the host-side ``LAUNCH_CALLS`` per call of
    ``fn`` by name (the spin kernel's launch left out)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for evt in prof.events():
        if (evt.device_type == torch.autograd.DeviceType.CUDA
                and "spin_kernel" not in evt.name):
            rec = by_name.setdefault(evt.name[:60], {"ms": 0.0, "traced": 0})
            rec["ms"] += evt.device_time_total / 1e3
            rec["traced"] += 1
        elif calls is not None and evt.name in LAUNCH_CALLS:
            calls[evt.name] = calls.get(evt.name, 0) + 1
    if calls is not None and calls.get("cudaLaunchKernel"):
        calls["cudaLaunchKernel"] -= 1            # the spin kernel
    if calls is not None:
        for name in calls:
            calls[name] /= reps
    for rec in by_name.values():
        rec["count"] = round(rec["traced"] / reps)
        rec["ms"] *= (rec["count"] / rec["traced"] if rec["count"]
                      else 1 / reps)
    return by_name


def own_launches(by_kernel, *names):
    """CUDA launches of the device functions of kernels ``names`` in a
    profile."""
    own = [r["count"] for k, r in by_kernel.items()
           if any(DEVICE_FUNCS[n].search(k) for n in names)]
    return sum(own) if own else "not measured"


# -- the parse path: K1 -------------------------------------------------------

def parse_path(rs):
    """K1 against its plain version, parse requests through
    ``Trainer.parse``, card vs CPU, timing.  Returns the K1 entry of the
    kernels line."""
    # the model: README quick-start DIORA at full width, random weights
    cfg32 = ModelConfig(size=D, input_size=E)
    tr32 = Trainer.build(cfg32, TrainConfig(), V, seed=SEED)
    check(tr32.device.type == "cuda", "trainer is not on the card")
    tr16 = Trainer(dataclasses.replace(cfg32, compute_dtype="bfloat16"),
                   TrainConfig(), tr32.params)
    dp = tr32.params["diora"]

    # -- the kernel vs its plain version, at the main path's shapes
    checked = {}
    for (b, n) in ((B, N), (B, 3), (37, 12)):
        with torch.no_grad():
            h0 = leaves(tr32, rs.randint(0, V, (b, n)))
            for dtype in ("float32", "bfloat16"):
                rec = {"dtype": dtype, **kernel_vs_plain(dp, h0, dtype)}
                emit({"phase": "kernel", "name": "inside_cky",
                      "shape": [b, n, D], **rec})
                check_k1(rec, f"inside_cky {dtype} {b}x{n}")
                checked[(b, n, dtype)] = rec
    # the shapes of the card-only test, with weights of their own width
    test_rs = np.random.RandomState(SEED + 3)
    for (b, n, d, norm) in K1_TEST_SHAPES:
        sdp = to_device(init_diora_params(
            torch.Generator().manual_seed(SEED), ModelConfig(size=d)),
            tr32.device)
        h0 = unit_norm(torch.as_tensor(
            test_rs.randn(b, n, d).astype(np.float32))).to(tr32.device)
        for dtype in ("float32", "bfloat16"):
            rec = {"dtype": dtype, **kernel_vs_plain(sdp, h0, dtype, norm)}
            emit({"phase": "kernel", "name": "inside_cky",
                  "shape": [b, n, d], "norm": norm, **rec})
            check_k1(rec, f"inside_cky {dtype} {b}x{n}x{d} norm={norm}")

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
    path_launches = inside_cky.launches

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
    check(path_launches >= 5, "the parse path skipped the kernel")

    # the card agrees with the CPU on a small input
    small = {"sentences": rs.randint(0, V, (37, 12))}
    cpu = Trainer(cfg32, TrainConfig(), to_device(tr32.params, "cpu"),
                  device="cpu")
    on_card, _ = tr32.parse(small)
    on_cpu, _ = cpu.parse(small)
    differ = int(np.sum(on_card["cky_bp"] != on_cpu["cky_bp"]))
    emit({"phase": "cpu_reference", "path": "parse", "shape": [37, 12, D],
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
            by_kernel = profile_kernels(kern, reps=5)
            rec = {"ms": statistics.median(k1 + k2),
                   "plain_ms": statistics.median(p1 + p2),
                   **bound(B, N, D, dtype), "library_ms": None,
                   "kernel_runs_ms": k1 + k2, "plain_runs_ms": p1 + p2,
                   "cuda_launches_per_call": own_launches(by_kernel,
                                                          "inside_cky"),
                   "by_function": k1_by_function(by_kernel, B, N, D, dtype)}
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
    return {
        "name": "inside_cky", **KERNELS["inside_cky"],
        "launches": path_launches,
        "max_abs_err": main_rec["max_abs_err"], "ms": f32["ms"],
        "plain_ms": f32["plain_ms"], "bound_ms": f32["bound_ms"],
        "bound_by": f32["bound_by"], "library_ms": None,
        "dtype": "float32", "shape": [B, N, D],
        "cuda_launches_per_call": f32["cuda_launches_per_call"],
        "by_function": f32["by_function"],
        "bf16": {k: timing["bfloat16"][k]
                 for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                           "cuda_launches_per_call", "by_function")}
        | {"bp_agree": checked[(B, N, "bfloat16")]["bp_agree"],
           "max_abs_err": checked[(B, N, "bfloat16")]["max_abs_err"]},
    }


# -- the CLIORA parse and its eval: no hand kernel -------------------------

def random_tree(rs, lo, hi):
    if lo == hi:
        return lo
    k = rs.randint(lo, hi)
    return (random_tree(rs, lo, k), random_tree(rs, k + 1, hi))


def eval_batch(rs, b, n, v, k, regions, feats, lengths=None):
    """A CLIORA batch as the data pipeline makes it for eval: sentences,
    regions, gold spans (a random tree's, root last), ``VG_GT`` phrases
    whose gold box is one of the image's candidate ``boxes``, and the
    length fields (``lengths`` for a ragged batch)."""
    batch = train_batch(rs, b, n, v, k, regions, feats)
    lens = np.full(b, n) if lengths is None else lengths
    lo = rs.uniform(0, 400, (b, regions, 2))
    boxes = np.concatenate([lo, lo + rs.uniform(20, 200, (b, regions, 2))],
                           -1).astype(np.float32)
    gt, vg = [], []
    for row in range(b):
        m = int(lens[row])
        gt.append(trees.tree_to_spans(random_tree(rs, 0, m - 1)))
        phrases = {}
        for p in range(PHRASES_PER_ROW):
            start = rs.randint(0, m)
            end = min(m, start + 1 + rs.randint(0, 4))
            phrases[f"p{p}"] = (start, end,
                                boxes[row, rs.randint(regions)].tolist())
        vg.append((phrases, None))
    batch.update({"GT": gt, "VG_GT": vg, "boxes": boxes,
                  "length": int(max(lens)), "padded_length": n,
                  "batch_size": b, "real_size": b})
    if lengths is not None:
        batch["lengths"] = np.asarray(lengths, np.int32)
    return batch


class BatchList:
    """An in-memory validation iterator (``run_eval``'s interface)."""

    def __init__(self, batches):
        self.batches = batches

    def get_iterator(self, random_seed=None):
        del random_seed
        return iter(self.batches)


def covers(tree, spans, n):
    """A decoded tree covers its sentence: leaves 0..n-1 in order, n - 1
    internal spans, the root (0, n - 1) last."""
    leaves = []

    def walk(t):
        if isinstance(t, tuple):
            for c in t:
                walk(c)
        else:
            leaves.append(t)

    walk(tree)
    return (leaves == list(range(n)) and len(spans) == n - 1
            and tuple(spans[-1]) == (0, n - 1))


def parse_request(tr, batch):
    """One request as the JAX package's parse script serves it
    (scripts/parse.py:105-146): the parse with losses and the outside
    pass, the decode, each row's phrases grounded and each predicted
    span's box.  Returns the parse's result, its metrics, the decoded
    rows and the host seconds of each part (``ground``: ground_phrases
    over the stand-in phrases; ``span_boxes``: span_pred_boxes over the
    decoded spans)."""
    t0 = time.perf_counter()
    res, metrics = tr.parse(batch, compute_loss=True, outside=True)
    t1 = time.perf_counter()
    decoded = trees.decode_batch(res["cky_bp"], batch["padded_length"])
    t2 = time.perf_counter()
    grounded = sum(len(ground_phrases(res["atten_score"][row],
                                      batch["boxes"][row],
                                      batch["VG_GT"][row][0]))
                   for row in range(len(decoded)))
    t3 = time.perf_counter()
    boxes = sum(len(span_pred_boxes(res["span_scores"][row],
                                    res["atten_score"][row],
                                    batch["boxes"][row], set(spans[:-1]),
                                    batch["length"]))
                for row, (_, spans) in enumerate(decoded))
    t4 = time.perf_counter()
    return res, metrics, decoded, {"parse": t1 - t0, "decode": t2 - t1,
                                   "ground": t3 - t2, "span_boxes": t4 - t3,
                                   "phrases": grounded,
                                   "span_boxes_n": boxes}


def kernel_counts():
    return {"inside_cky": inside_cky.launches, **span_region.launches}


def cliora_parse_requests(dtype, tr, batches):
    """PARSE_REQUESTS requests through ``Trainer.parse`` (plain route), then
    one profiled request: host ms per part, device busy ms, idle share,
    CUDA launches, peak memory, top kernels, losses."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reqs = []
    for i, batch in enumerate(batches):
        res, metrics, decoded, t = parse_request(tr, batch)
        n = batch["padded_length"]
        rec = {"phase": "cliora_parse_request", "dtype": dtype, "request": i,
               "parse_impl": res["parse_impl"], "losses": metrics,
               "ms": sum(t[k] for k in ("parse", "decode", "ground",
                                        "span_boxes")) * 1e3,
               "parse_ms": t["parse"] * 1e3, "decode_ms": t["decode"] * 1e3,
               "ground_ms": t["ground"] * 1e3,
               "span_boxes_ms": t["span_boxes"] * 1e3,
               "phrases": t["phrases"], "span_boxes": t["span_boxes_n"],
               "trees_cover": all(covers(tree, spans, n)
                                  for tree, spans in decoded),
               "shapes": {k: list(v.shape) for k, v in res.items()
                          if k != "parse_impl"}}
        emit(rec)
        check(res["parse_impl"] == "plain",
              f"CLIORA {dtype} request {i} took route {res['parse_impl']}")
        check(all(math.isfinite(x) for x in metrics.values()),
              f"CLIORA {dtype} request {i}: non-finite loss {metrics}")
        check(rec["trees_cover"], f"CLIORA {dtype} request {i}: a decoded "
              "tree does not cover its sentence")
        check(all(np.isfinite(res[k]).all()
                  for k in ("atten_score", "span_scores")),
              f"CLIORA {dtype} request {i}: non-finite scores")
        reqs.append(rec)
    peak = torch.cuda.max_memory_allocated()
    warm = reqs[2:]
    wall = statistics.median(r["ms"] for r in warm)
    by_kernel = profile_kernels(lambda: parse_request(tr, batches[1]))
    busy = sum(r["ms"] for r in by_kernel.values())
    summary = {
        "phase": "cliora_parse", "dtype": dtype, "batch": B, "n": N,
        "requests": len(reqs), "request_ms_median_warm": wall,
        "sentences_per_s": B / wall * 1e3,
        "parse_ms_median_warm": statistics.median(r["parse_ms"]
                                                  for r in warm),
        "decode_ms_median_warm": statistics.median(r["decode_ms"]
                                                   for r in warm),
        "ground_ms_median_warm": statistics.median(r["ground_ms"]
                                                   for r in warm),
        "ground_phrases_stand_in": PHRASES_PER_ROW,
        "ground_us_per_phrase_median_warm": statistics.median(
            r["ground_ms"] * 1e3 / r["phrases"] for r in warm),
        "request_ms_without_ground_median_warm": statistics.median(
            r["ms"] - r["ground_ms"] for r in warm),
        "span_boxes_ms_median_warm": statistics.median(r["span_boxes_ms"]
                                                       for r in warm),
        "request_device_busy_ms": busy if by_kernel else "not measured",
        "idle_share": 1 - busy / wall if by_kernel else "not measured",
        "cuda_launches_per_request": (sum(r["count"]
                                          for r in by_kernel.values())
                                      if by_kernel else "not measured"),
        "max_memory_allocated_bytes": peak,
        "top_kernels": dict(sorted(by_kernel.items(),
                                   key=lambda kv: -kv[1]["ms"])[:5]),
        "losses_last": reqs[-1]["losses"], "card": nvidia_smi_line()}
    emit(summary)


def cliora_parse_cpu_reference(rs):
    """A small f32 CLIORA parse (B=6, L=6, D=48, R=4, F=32) on the card and
    on the CPU from the same weights, with and without ``lengths``."""
    cfg, tc = train_configs("float32", size=48, input_size=64, n_regions=4,
                            obj_feat_size=32)
    base = Trainer.build(cfg, tc, 100, seed=SEED + 4, device="cpu")
    flat = perturbed(base.params, rs)
    card = Trainer(cfg, tc, params_from_numpy(flat, "cuda"))
    cpu = Trainer(cfg, tc, params_from_numpy(flat, "cpu"), device="cpu")
    batch = train_batch(rs, 6, 6, 100, 7, 4, 32)
    for tag, extra in (("full", {}),
                       ("lengths", {"lengths": np.array([6, 3, 5, 2, 4, 6],
                                                         np.int32)})):
        bm = {**batch, **extra}
        (g, gm), (w, wm) = (card.parse(bm, compute_loss=True, outside=True),
                            cpu.parse(bm, compute_loss=True, outside=True))
        rec = {"phase": "cpu_reference", "path": "cliora_parse",
               "shape": [6, 6, 48], "case": tag,
               "cells_differ": int(np.sum(g["cky_bp"] != w["cky_bp"])),
               "atten_score_max_abs_err":
                   float(np.abs(g["atten_score"] - w["atten_score"]).max()),
               "span_scores_max_abs_err":
                   float(np.abs(g["span_scores"] - w["span_scores"]).max()),
               "losses_card": gm, "losses_cpu": wm,
               "loss_rel_diff": {k: abs(gm[k] - wm[k]) / max(abs(wm[k]),
                                                             1e-12)
                                 for k in wm}}
        emit(rec)
        check(rec["cells_differ"] == 0,
              f"CLIORA parse {tag}: card and CPU backpointers differ")
        check(rec["atten_score_max_abs_err"] <= PARSE_CPU_SCORE_ATOL
              and rec["span_scores_max_abs_err"] <= PARSE_CPU_SCORE_ATOL,
              f"CLIORA parse {tag}: card and CPU scores differ")
        check(set(gm) == set(wm) and all(
            r <= PARSE_CPU_LOSS_RTOL for r in rec["loss_rel_diff"].values()),
            f"CLIORA parse {tag}: card and CPU losses differ")


def cliora_parse_checkpoints(cfg, tc, tr, batch):
    """Parameter checkpoints on the card: ``save_params`` -> ``load_params``
    and ``export_torch_checkpoint`` -> ``import_torch_checkpoint``, each
    into a fresh trainer of other weights, then the same parse: equal
    bits."""
    want, _ = tr.parse(batch)
    with tempfile.TemporaryDirectory() as tmp:
        for fmt, save, load in (("npz", save_params, load_params),
                                ("pt", export_torch_checkpoint,
                                 import_torch_checkpoint)):
            path = f"{tmp}/model.{fmt}"
            save(path, tr.params)
            fresh = Trainer.build(cfg, tc, V, seed=SEED + 7)
            params, missing = load(path, fresh.params)
            fresh.install_state(params)
            got, _ = fresh.parse(batch)
            rec = {"phase": "cliora_parse_checkpoint", "format": fmt,
                   "missing": missing,
                   "cky_bp_equal": bool(np.array_equal(got["cky_bp"],
                                                       want["cky_bp"])),
                   "atten_score_equal_bits": bool(np.array_equal(
                       got["atten_score"], want["atten_score"])),
                   "span_scores_equal_bits": bool(np.array_equal(
                       got["span_scores"], want["span_scores"]))}
            emit(rec)
            check(not missing and rec["cky_bp_equal"]
                  and rec["atten_score_equal_bits"]
                  and rec["span_scores_equal_bits"],
                  f"CLIORA parse after a {fmt} checkpoint trip differs")


def cliora_parse_path(rs):
    """The CLIORA parse at bench.py's full width: requests in f32 and bf16,
    card vs CPU, ``run_eval``, checkpoints.  Launches none of K1-K4: a
    CLIORA model and a parse with losses take the plain route, as under
    the JAX gating (cliora_tpu/training/trainer.py:745-749), and the eval
    forward materializes the span x region scores by einsum."""
    t_phase = time.perf_counter()
    before = kernel_counts()
    cfg, tc = train_configs("float32")
    base = Trainer.build(cfg, tc, V, seed=SEED)
    check(base.device.type == "cuda", "trainer is not on the card")
    flat = perturbed(base.params, rs)
    del base
    tr32 = Trainer(cfg, tc, params_from_numpy(flat, "cuda"))
    tr16 = Trainer(dataclasses.replace(cfg, compute_dtype="bfloat16"), tc,
                   tr32.params)
    for dtype, tr in (("float32", tr32), ("bfloat16", tr16)):
        batches = [eval_batch(rs, B, N, V, K_NEG, R, F)
                   for _ in range(PARSE_REQUESTS)]
        cliora_parse_requests(dtype, tr, batches)
        torch.cuda.empty_cache()
    cliora_parse_cpu_reference(rs)

    # run_eval over 4 full-width batches: one ragged, one of length 2.
    # The ragged lengths (uniform in 2..N) and the phrases are stand-ins,
    # not a measured caption mix: sentences/s covers the rows longer than 2
    ragged = rs.randint(2, N + 1, B).astype(np.int32)
    ragged[0] = N
    evals = [eval_batch(rs, B, N, V, K_NEG, R, F),
             eval_batch(rs, B, N, V, K_NEG, R, F, lengths=ragged),
             eval_batch(rs, B, 2, V, K_NEG, R, F),
             eval_batch(rs, B, N, V, K_NEG, R, F)]
    sentences = sum(int(np.sum((bm.get("lengths", np.full(B, bm["length"]))
                                > 2)))
                    for bm in evals if bm["length"] > 2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = run_eval(tr32, BatchList(evals), seed=SEED, use_obj=True)
    wall = time.perf_counter() - t0
    eval_rec = {"phase": "cliora_run_eval", "dtype": "float32",
                "batches": len(evals), "sentences": sentences,
                "seconds": wall, "sentences_per_s": sentences / wall,
                **metrics}
    emit(eval_rec)
    check(0.0 <= metrics["ccra"] <= metrics["grounding_acc"] <= 1.0
          and 0.0 <= metrics["corpus_f1"] <= 1.0
          and 0.0 <= metrics["sent_f1"] <= 1.0,
          f"run_eval metrics out of range: {metrics}")

    cliora_parse_checkpoints(cfg, tc, tr32, evals[0])
    after = kernel_counts()
    rec = {"phase": "cliora_parse_summary", "launches_before": before,
           "launches_after": after, "wall_seconds":
               time.perf_counter() - t_phase}
    emit(rec)
    check(after == before, f"the CLIORA parse launched a hand kernel: "
          f"{before} -> {after}")
    del tr32, tr16
    torch.cuda.empty_cache()


# -- the train path: K2-K4 ----------------------------------------------------

def span_region_vs_plain(span, obj, g):
    """K2, K3 and K4 on the card vs their plain versions on the same
    inputs (K3/K4 fed the kernel's argmax), each backward kernel twice."""
    sync = torch.cuda.synchronize
    dt = span.dtype
    Rr = obj.shape[1]
    mx, am = span_region.span_region_fwd(span, obj)
    sync()
    pmx, pam = span_region.span_region_fwd_plain(span, obj)
    scale = max(1.0, pmx.abs().max().item())
    rec = {"fwd_max_abs_err": (mx - pmx).abs().max().item(),
           "fwd_scale": scale,
           "argmax_agree": (am == pam).float().mean().item(),
           "finite": bool(torch.isfinite(mx).all()),
           "shapes_ok": (mx.shape == pmx.shape and am.dtype == torch.int32)}
    if dt == torch.float32:
        # K2's f32 route sums in the order of torch's f32 GEMM, which the
        # plain version runs: recorded, the f32 step's route check leans
        # on it (PERF.md section 6)
        rec["fwd_bits_equal_plain"] = bool(torch.equal(mx, pmx))
        # the argmax is held wherever the top two scores differ by more
        # than the tolerance of the max
        top2 = torch.topk(torch.einsum("amd,crd->acmr", span, obj),
                          min(2, Rr), dim=-1).values
        gap = (top2[..., 0] - top2[..., -1]) > SR_F32_RTOL * scale
        rec["argmax_equal_off_ties"] = bool(torch.equal(am[gap], pam[gap]))
        rec["near_ties"] = int((~gap).sum().item())
        del top2
    dspan = span_region.span_region_dspan(obj, am, g, dt)
    dobj = span_region.span_region_dobj(span, am, g, Rr, torch.float32)
    sync()
    pdspan = span_region.span_region_dspan_plain(obj, am, g, dt)
    pdobj = span_region.span_region_dobj_plain(span, am, g, Rr,
                                               torch.float32)
    rec.update({
        "dspan_max_abs_err":
            (dspan.float() - pdspan.float()).abs().max().item(),
        "dspan_scale": max(1.0, pdspan.float().abs().max().item()),
        "dobj_max_abs_err": (dobj - pdobj).abs().max().item(),
        "dobj_scale": max(1.0, pdobj.abs().max().item()),
        "dspan_bitwise_repeat": bool(torch.equal(
            dspan, span_region.span_region_dspan(obj, am, g, dt))),
        "dobj_bitwise_repeat": bool(torch.equal(
            dobj, span_region.span_region_dobj(span, am, g, Rr,
                                               torch.float32))),
    })
    zmx, zam = span_region.span_region_fwd(span, torch.zeros_like(obj))
    rec["ties_argmax_zero"] = bool(torch.equal(zam, torch.zeros_like(zam))
                                   and torch.equal(zmx, torch.zeros_like(zmx)))
    zdobj = span_region.span_region_dobj(span, zam, torch.zeros_like(g), Rr,
                                         torch.float32)
    rec["zero_g_dobj_zero"] = bool(torch.equal(zdobj,
                                               torch.zeros_like(zdobj)))
    # K3 on the all-ties argmax with nonzero g
    zdspan = span_region.span_region_dspan(obj, zam, g, dt)
    pzdspan = span_region.span_region_dspan_plain(obj, zam, g, dt)
    rec["ties_dspan_max_abs_err"] = (zdspan.float()
                                     - pzdspan.float()).abs().max().item()
    rec["ties_dspan_scale"] = max(1.0, pzdspan.float().abs().max().item())
    rec["ties_dspan_bitwise_repeat"] = bool(torch.equal(
        zdspan, span_region.span_region_dspan(obj, zam, g, dt)))
    rec["dspan_segments"] = span_region.dspan_segments(
        span.shape[0] * span.shape[1], obj.shape[0], obj.shape[2])
    return rec


def check_span_region(rec, what, bf16):
    check(rec["finite"] and rec["shapes_ok"], f"{what}: non-finite or shape")
    if bf16:
        check(rec["argmax_agree"] >= SR_BF16_ARGMAX_AGREE
              and rec["fwd_max_abs_err"]
              <= SR_BF16_MAX_RTOL * rec["fwd_scale"],
              f"{what}: K2 disagrees with plain")
        check(rec["dspan_max_abs_err"]
              <= SR_BF16_DSPAN_RTOL * rec["dspan_scale"]
              and rec["ties_dspan_max_abs_err"]
              <= SR_BF16_DSPAN_RTOL * rec["ties_dspan_scale"],
              f"{what}: K3 disagrees with plain")
    else:
        check(rec["fwd_max_abs_err"] <= SR_F32_RTOL * rec["fwd_scale"]
              and rec["argmax_equal_off_ties"],
              f"{what}: K2 disagrees with plain")
        check(rec["dspan_max_abs_err"] <= SR_F32_RTOL * rec["dspan_scale"]
              and rec["ties_dspan_max_abs_err"]
              <= SR_F32_RTOL * rec["ties_dspan_scale"],
              f"{what}: K3 disagrees with plain")
    check(rec["dobj_max_abs_err"] <= SR_F32_RTOL * rec["dobj_scale"],
          f"{what}: K4 disagrees with plain")
    check(rec["dspan_bitwise_repeat"] and rec["dobj_bitwise_repeat"]
          and rec["ties_dspan_bitwise_repeat"],
          f"{what}: K3/K4 not bitwise repeatable")
    check(rec["ties_argmax_zero"], f"{what}: all-ties argmax is not 0")
    check(rec["zero_g_dobj_zero"], f"{what}: g all zero, dobj not zero")


def train_configs(dtype, attn_impl="cuda", attn_dropout=0.1, **model_kw):
    """bench.py's CLIORA train configuration (bench.py:89-92)."""
    model = dict(size=D, input_size=E, use_obj=True, n_regions=R,
                 obj_feat_size=F, compute_dtype=dtype,
                 attn_dropout=attn_dropout)
    model.update(model_kw)
    return (ModelConfig(**model),
            TrainConfig(lr=5e-4, k_neg=K_NEG, vg_loss=True, use_contr=True,
                        emb_trainable=True, attn_impl=attn_impl))


def train_batch(rs, b, n, v, k, regions, feats):
    return {"sentences": rs.randint(0, v, (b, n)),
            "neg_samples": rs.choice(v, k, replace=False),
            "obj_feats": rs.randn(b, regions, feats).astype(np.float32)}


def perturbed(params, rs, scale=0.01):
    """The weights with the zero-init image encoder moved off its tied
    state (tests/test_span_region.py:87-98), as a CPU flat dict."""
    flat = flatten(params)
    for k in flat:
        if k.startswith("img_encoder/"):
            flat[k] = (scale * rs.randn(*flat[k].shape)).astype(np.float32)
    return flat


def train_steps(dtype, batch):
    """TRAIN_STEPS steps of the full-width CLIORA model on one fixed batch
    through ``Trainer.step``, K2-K4 counted per step, then the same number
    of steps without a host sync between them and a profiled step (after
    a warm-up step inside the profiler)."""
    cfg, tc = train_configs(dtype)
    tr = Trainer.build(cfg, tc, V, seed=SEED)
    check(tr.device.type == "cuda", "trainer is not on the card")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steps = []
    for i in range(TRAIN_STEPS):
        before = dict(span_region.launches)
        t0 = time.perf_counter()
        metrics = tr.step(batch)
        losses = {k: float(v) for k, v in metrics.items()}   # syncs
        ms = (time.perf_counter() - t0) * 1e3
        delta = {k: span_region.launches[k] - before[k] for k in SR_KERNELS}
        rec = {"phase": "train_step", "dtype": dtype, "step": i,
               "losses": losses, "launches_delta": delta, "ms": ms}
        emit(rec)
        check(all(math.isfinite(x) for x in losses.values()),
              f"{dtype} step {i}: non-finite loss")
        check(all(d == 2 for d in delta.values()),
              f"{dtype} step {i}: K2/K3/K4 launches {delta}, expected 2 each")
        steps.append(rec)
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        metrics = tr.step(batch)
    torch.cuda.synchronize()
    pipelined = (time.perf_counter() - t0) * 1e3 / TRAIN_STEPS
    check(math.isfinite(float(metrics["total_loss"])), "non-finite loss")
    by_kernel = profile_kernels(lambda: tr.step(batch))
    warm = [s["ms"] for s in steps[2:]]
    step_ms = statistics.median(warm)
    busy = sum(r["ms"] for r in by_kernel.values())
    first, last = (steps[0]["losses"]["total_loss"],
                   steps[-1]["losses"]["total_loss"])
    summary = {
        "phase": "train", "dtype": dtype, "batch": B, "n": N,
        "batch_on_device": True,
        "cuda_launches_per_step": sum(r["count"] for r in by_kernel.values()),
        "steps": TRAIN_STEPS, "step_ms_median_warm": step_ms,
        "sentences_per_s": B / step_ms * 1e3,
        "pipelined_step_ms": pipelined,
        "pipelined_sentences_per_s": B / pipelined * 1e3,
        "max_memory_allocated_bytes": peak,
        "profiled_step_device_busy_ms": busy if by_kernel else "not measured",
        "idle_share": 1 - busy / step_ms if by_kernel else "not measured",
        "total_loss_first": first, "total_loss_last": last,
        "launches_per_step_profiled": {
            k: own_launches(by_kernel, k)
            for k in SR_KERNELS + ("segment_reduce",)},
        "top_kernels": dict(sorted(by_kernel.items(),
                                   key=lambda kv: -kv[1]["ms"])[:12]),
    }
    emit(summary)
    check(last < first, f"{dtype}: total loss did not descend on the "
          f"fixed batch ({first} -> {last})")
    del tr
    torch.cuda.empty_cache()
    return summary


def step_grads(cfg, tc, flat, batch, device):
    """Losses and gradients of one step's loss (no update) on ``device``."""
    tr = Trainer(cfg, tc, params_from_numpy(flat, device), device=device)
    tokens, neg, obj, _ = tr._place_batch(batch)
    total, metrics = compute_losses(cfg, tc, tr.params, tokens, neg,
                                    obj_feats=obj, train=True)
    total.backward()
    grads = {k: (torch.zeros_like(p) if p.grad is None else p.grad).float()
             for k, p in zip(flatten(tr.params), tree_leaves(tr.params))}
    return {k: float(v.detach()) for k, v in metrics.items()}, grads


def route_vs_chunked(rs):
    """One full-width step's losses and gradients under attn_impl='cuda'
    against 'chunked' on the same weights and batch, dropout off."""
    batch = train_batch(rs, B, N, V, K_NEG, R, F)
    base = Trainer.build(*train_configs("float32"), V, seed=SEED + 1,
                         device="cpu")
    flat = perturbed(base.params, rs)
    del base
    out = {}
    for dtype in ("float32", "bfloat16"):
        res = {}
        for impl in ("cuda", "chunked"):
            cfg, tc = train_configs(dtype, attn_impl=impl, attn_dropout=0.0)
            before = dict(span_region.launches)
            res[impl] = step_grads(cfg, tc, flat, batch, "cuda")
            res[impl + "_launches"] = {k: span_region.launches[k] - before[k]
                                       for k in SR_KERNELS}
        (m_k, g_k), (m_c, g_c) = res["cuda"], res["chunked"]
        rel = {k: abs(m_k[k] - m_c[k]) / max(abs(m_c[k]), 1e-12) for k in m_c}
        cos = {}
        for k in g_c:
            a, b = g_k[k].reshape(-1), g_c[k].reshape(-1)
            na, nb = a.norm().item(), b.norm().item()
            if na > 0 and nb > 0:
                cos[k] = (a @ b).item() / (na * nb)
        rec = {"phase": "route_vs_chunked", "dtype": dtype,
               "losses_cuda": m_k, "losses_chunked": m_c,
               "loss_rel_diff": rel, "grad_cosine": cos,
               "min_grad_cosine": min(cos.values()),
               "launches_cuda": res["cuda_launches"],
               "launches_chunked": res["chunked_launches"]}
        emit(rec)
        check(all(r <= ROUTE_LOSS_RTOL[dtype] for r in rel.values()),
              f"{dtype}: kernel-route losses differ from chunked: {rel}")
        check(rec["min_grad_cosine"] >= ROUTE_GRAD_COS[dtype],
              f"{dtype}: kernel-route gradient cosine "
              f"{rec['min_grad_cosine']}")
        check(all(v == 2 for v in res["cuda_launches"].values())
              and all(v == 0 for v in res["chunked_launches"].values()),
              "route launches")
        out[dtype] = rec
        torch.cuda.empty_cache()
    return out


def train_cpu_reference(rs):
    """A small f32 CLIORA step ('chunked') on the card and on the CPU."""
    small = dict(b=6, n=6, v=100, k=7, regions=5, feats=32)
    cfg, tc = train_configs("float32", attn_impl="chunked", attn_dropout=0.0,
                            size=48, input_size=64, n_regions=5,
                            obj_feat_size=32)
    tc = dataclasses.replace(tc, k_neg=7)
    base = Trainer.build(cfg, tc, 100, seed=SEED + 2, device="cpu")
    flat = perturbed(base.params, rs)
    batch = train_batch(rs, **small)
    on_card, _ = step_grads(cfg, tc, flat, batch, "cuda")
    on_cpu, _ = step_grads(cfg, tc, flat, batch, "cpu")
    rel = {k: abs(on_card[k] - on_cpu[k]) / max(abs(on_cpu[k]), 1e-12)
           for k in on_cpu}
    emit({"phase": "cpu_reference", "path": "train", "shape": [6, 6, 48],
          "losses_card": on_card, "losses_cpu": on_cpu, "rel_diff": rel})
    check(all(r <= CPU_LOSS_RTOL for r in rel.values()),
          f"card and CPU train-step losses differ: {rel}")


# -- the graphed train path: Trainer.steps as a replayed CUDA graph -----------

def finite_losses(metrics):
    return all(math.isfinite(float(v)) for m in metrics for v in m.values())


def graphed_train(dtype, batch, eager):
    """``Trainer.steps`` at bench.py's configuration: the warm-up steps,
    the capture with its first replay, ``GRAPH_STEPS`` replayed steps
    timed by the host clock with one sync at the end (twice), and a
    profiled replay; beside the eager ``train`` summary of the same
    configuration and batch."""
    cfg, tc = train_configs(dtype)
    tr = Trainer.build(cfg, tc, V, seed=SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    warm = tr.steps([batch] * GRAPH_WARMUP_STEPS)
    check(finite_losses(warm), f"{dtype}: non-finite warm-up loss")
    warm_ms = (time.perf_counter() - t0) * 1e3 / GRAPH_WARMUP_STEPS
    before = dict(span_region.launches)
    t0 = time.perf_counter()
    first = tr.steps([batch])
    check(finite_losses(first), f"{dtype}: non-finite loss")   # syncs
    capture_ms = (time.perf_counter() - t0) * 1e3
    at_capture = {k: span_region.launches[k] - before[k] for k in SR_KERNELS}
    check(all(v == 2 for v in at_capture.values()),
          f"{dtype}: K2/K3/K4 launches at the capture {at_capture}")
    runs = []
    for _ in range(2):
        before = dict(span_region.launches)
        t0 = time.perf_counter()
        metrics = tr.steps([batch] * GRAPH_STEPS)
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0) * 1e3 / GRAPH_STEPS)
        check(span_region.launches == before,
              f"{dtype}: a replay moved a kernel counter")
    check(finite_losses(metrics), f"{dtype}: non-finite graphed loss")
    peak = torch.cuda.max_memory_allocated()
    calls = {}
    by_kernel = profile_kernels(lambda: tr.steps([batch]), reps=3,
                                calls=calls)
    busy = sum(r["ms"] for r in by_kernel.values())
    step_ms = statistics.mean(runs)
    in_step = {k: own_launches(by_kernel, k)
               for k in SR_KERNELS + ("segment_reduce",)}
    losses = [float(m["total_loss"]) for m in warm + first + metrics]
    summary = {
        "phase": "train_graphs", "dtype": dtype, "batch": B, "n": N,
        # the eager run's trainer had these weights and this batch
        "first_loss_equals_eager": losses[0] == eager["total_loss_first"],
        "warmup_steps": GRAPH_WARMUP_STEPS,
        "warmup_step_ms": warm_ms,
        "capture_and_first_replay_ms": capture_ms,
        "graphed_step_ms_runs": runs, "graphed_step_ms": step_ms,
        "graphed_sentences_per_s": B / step_ms * 1e3,
        "eager_step_ms_median_warm": eager["step_ms_median_warm"],
        "eager_pipelined_step_ms": eager["pipelined_step_ms"],
        "eager_device_busy_ms": eager["profiled_step_device_busy_ms"],
        "eager_cuda_launches_per_step": eager["cuda_launches_per_step"],
        "replayed_step_device_busy_ms": busy if by_kernel else "not measured",
        "idle_share": 1 - busy / step_ms if by_kernel else "not measured",
        "device_kernels_per_step": sum(r["count"]
                                       for r in by_kernel.values()),
        "graph_launches_per_step": calls.get("cudaGraphLaunch", 0),
        "host_launch_calls_per_step": calls,
        "launches_per_replayed_step_profiled": in_step,
        "launches_at_capture": at_capture,
        "max_memory_allocated_bytes": peak,
        "eager_max_memory_allocated_bytes":
            eager["max_memory_allocated_bytes"],
        "total_loss_first": losses[0], "total_loss_last": losses[-1],
        "top_kernels": dict(sorted(by_kernel.items(),
                                   key=lambda kv: -kv[1]["ms"])[:8]),
    }
    emit(summary)
    check(all(in_step[k] == 2 for k in SR_KERNELS),
          f"{dtype}: K2/K3/K4 in a replayed step's profile {in_step}, "
          f"expected 2 each")
    check(losses[-1] < losses[0], f"{dtype}: graphed total loss did not "
          f"descend on the fixed batch ({losses[0]} -> {losses[-1]})")
    del tr
    torch.cuda.empty_cache()
    return summary


def max_rel(got, want):
    return max(abs(float(g[k]) - float(w[k])) / max(abs(float(w[k])), 1e-12)
               for g, w in zip(got, want) for k in w)


def params_diff(a, b):
    fa, fb = flatten(a.params), flatten(b.params)
    return (max(float(np.abs(fa[k] - fb[k]).max()) for k in fa),
            all(np.array_equal(fa[k], fb[k]) for k in fa))


def graphed_vs_eager(flat, batches):
    """From one set of weights, the three batches twice: eager ``step``
    calls against ``steps`` (warm-up steps, the capture, then replays),
    in f32 and bf16, with dropout off and at 0.1; equal bits."""
    return [arch_vs_eager("train_graphs", *train_configs(
                dtype, attn_dropout=dropout), flat, batches)
            for dtype in ("float32", "bfloat16") for dropout in (0.0, 0.1)]


def graphed_two_keys(rs):
    """Two shape keys (L = 6 and 8) replayed alternately, their graphs in
    the trainer's one shared memory pool, against eager steps of the same
    batches in the same order (B=6, D=48, f32, dropout 0.1): each key's
    warm-up steps, capture and two replays."""
    small = dict(b=6, v=100, k=7, regions=5, feats=32)
    cfg, tc = train_configs("float32", size=48, input_size=64,
                            n_regions=5, obj_feat_size=32)
    tc = dataclasses.replace(tc, k_neg=7)
    base = Trainer.build(cfg, tc, 100, seed=SEED + 4, device="cpu")
    flat = perturbed(base.params, rs)
    seq = [{k: torch.as_tensor(v).to("cuda")
            for k, v in train_batch(rs, n=n, **small).items()}
           for _ in range(GRAPH_WARMUP_STEPS + 3) for n in (6, 8)]
    eager = Trainer(cfg, tc, params_from_numpy(flat, "cuda"))
    graphed = Trainer(cfg, tc, params_from_numpy(flat, "cuda"))
    want = [eager.step(b) for b in seq]
    got = [graphed.steps([b])[0] for b in seq]
    rel = max_rel(got, want)
    pdiff, pbits = params_diff(graphed, eager)
    rec = {"phase": "train_graphs_two_keys", "steps": len(seq),
           "graphs": len(graphed._graphs),
           "graph_pools": int(graphed._graph_pool is not None),
           "loss_max_rel_diff": rel,
           "losses_equal_bits": all(torch.equal(g[k], w[k])
                                    for g, w in zip(got, want) for k in w),
           "param_max_abs_diff": pdiff, "params_equal_bits": pbits}
    emit(rec)
    check(rec["graphs"] == 2 and rel <= STEPS_LOSS_RTOL
          and pdiff <= STEPS_PARAM_ATOL,
          f"two shape keys in one pool: {rec}")
    return rec


def graphed_accum(batch):
    """``accum_steps=2`` at bench.py's configuration (bf16): the warm-up
    steps and a replayed step, each profiled: K2-K4 4 times a step."""
    cfg, tc = train_configs("bfloat16")
    tr = Trainer.build(cfg, dataclasses.replace(tc, accum_steps=2), V,
                       seed=SEED)
    recs = []
    for i in range(GRAPH_WARMUP_STEPS + 1):
        res = []
        by_kernel = profile_kernels(lambda: res.extend(tr.steps([batch])))
        in_step = {k: own_launches(by_kernel, k) for k in SR_KERNELS}
        rec = {"phase": "train_graphs_accum", "dtype": "bfloat16",
               "accum_steps": 2, "step": i,
               "route": "replay" if i >= GRAPH_WARMUP_STEPS else "warm-up",
               "losses": {k: float(v) for k, v in res[0].items()},
               "device_busy_ms": sum(r["ms"] for r in by_kernel.values()),
               "launches_profiled": in_step}
        emit(rec)
        check(finite_losses(res), f"accum step {i}: non-finite loss")
        check(all(v == 4 for v in in_step.values()),
              f"accum step {i}: K2/K3/K4 {in_step}, expected 4 each")
        recs.append(rec)
    del tr
    torch.cuda.empty_cache()
    return recs


def graphed_accum_vs_cpu(rs):
    """``accum_steps=2`` on a small f32 step (B=6, L=6, D=48): a replayed
    step on the card (the warm-up steps, then the initial state installed
    back in place) against an eager step on the CPU."""
    small = dict(b=6, n=6, v=100, k=7, regions=5, feats=32)
    cfg, tc = train_configs("float32", attn_dropout=0.0, size=48,
                            input_size=64, n_regions=5, obj_feat_size=32)
    tc = dataclasses.replace(tc, k_neg=7, accum_steps=2)
    base = Trainer.build(cfg, tc, 100, seed=SEED + 3, device="cpu")
    flat = perturbed(base.params, rs)
    batch = train_batch(rs, **small)
    cpu = Trainer(cfg, tc, params_from_numpy(flat, "cpu"), device="cpu")
    zero = cpu.opt_state()
    want = cpu.step(batch)
    card = Trainer(cfg, tc, params_from_numpy(flat, "cuda"))
    card.steps([batch] * GRAPH_WARMUP_STEPS)
    card.install_state(params_from_numpy(flat, "cpu"), zero)
    card.set_step(0)
    got = card.steps([batch])[0]          # the capture and its replay
    rel = {k: abs(float(got[k]) - float(want[k])) / max(abs(float(want[k])),
                                                      1e-12) for k in want}
    grad_err, param_err = {}, {}
    flat_cpu, flat_card = flatten(cpu.params), flatten(card.params)
    for k, p, q in zip(flat_cpu, tree_leaves(cpu.params),
                       tree_leaves(card.params)):
        g, h = p.grad, q.grad.cpu()
        grad_err[k] = float((g - h).abs().max()) / max(
            1.0, float(g.abs().max()))
        moved = g.abs().numpy() > 1e-6
        param_err[k] = float(np.abs(flat_cpu[k] - flat_card[k])[moved].max(
            initial=0.0))
    rec = {"phase": "train_graphs_accum_cpu", "shape": [6, 6, 48],
           "accum_steps": 2, "losses_card": {k: float(v)
                                             for k, v in got.items()},
           "loss_rel_diff": rel, "grad_max_rel_err": max(grad_err.values()),
           "param_max_abs_err_moved": max(param_err.values())}
    emit(rec)
    check(all(r <= CPU_LOSS_RTOL for r in rel.values()),
          f"accum card vs CPU losses differ: {rel}")
    check(rec["grad_max_rel_err"] <= SR_F32_RTOL,
          f"accum card vs CPU gradients differ: {grad_err}")
    check(rec["param_max_abs_err_moved"]
          <= ONE_STEP_PARAM_ATOL_LR * tc.lr,
          f"accum card vs CPU parameters differ: {param_err}")
    return rec


def opt_state_trip(batches):
    """Three graphed steps (bf16, dropout 0.1), then ``save_params`` and
    ``save_opt_state``; a fresh trainer on other weights, with a graph of
    its own, loads both in place and ``set_step(3)``; its fourth step
    (a replay) has the bits of the uninterrupted run's fourth step."""
    cfg, tc = train_configs("bfloat16")
    run = Trainer.build(cfg, tc, V, seed=SEED)
    run.steps(batches[:3])
    with tempfile.TemporaryDirectory() as tmp:
        save_params(f"{tmp}/model.npz", run.params)
        save_opt_state(f"{tmp}/model.opt.pkl", run.opt_state())
        want = run.steps(batches[3:4])[0]
        fresh = Trainer.build(cfg, tc, V, seed=SEED + 9)
        fresh.steps(batches[:1] * (GRAPH_WARMUP_STEPS + 1))
        params, missing = load_params(f"{tmp}/model.npz", fresh.params)
        fresh.install_state(params, load_opt_state(f"{tmp}/model.opt.pkl"))
    fresh.set_step(3)
    got = fresh.steps(batches[3:4])[0]
    _, pbits = params_diff(fresh, run)
    rec = {"phase": "train_graphs_opt_state_trip", "dtype": "bfloat16",
           "missing": missing, "losses_equal_bits": all(
               torch.equal(got[k], want[k]) for k in want),
           "params_equal_bits": pbits}
    emit(rec)
    check(not missing and rec["losses_equal_bits"] and pbits,
          "resumed 4th step differs from the uninterrupted one")
    del run, fresh
    torch.cuda.empty_cache()
    return rec


def failed_capture_raises(rs):
    """A step that syncs with the host cannot be captured: ``steps``
    raises, and no eager step runs in its place (the parameters and
    Adam's count stay as they were).  The next call captures."""
    small = dict(b=6, n=6, v=100, k=7, regions=5, feats=32)
    cfg, tc = train_configs("float32", attn_dropout=0.0, size=48,
                            input_size=64, n_regions=5, obj_feat_size=32)
    tc = dataclasses.replace(tc, k_neg=7)
    tr = Trainer.build(cfg, tc, 100, seed=SEED + 4)
    batch = train_batch(rs, **small)
    tr.steps([batch] * GRAPH_WARMUP_STEPS)
    before = flatten(tr.params)
    clip = trainer_mod.clip_by_global_norm

    def syncing_clip(grads, max_norm):
        clipped, norm = clip(grads, max_norm)
        float(norm)                   # a host sync: no graph can hold it
        return clipped, norm

    trainer_mod.clip_by_global_norm = syncing_clip
    error = None
    stream = torch.cuda.current_stream()
    try:
        tr.steps([batch])
    except RuntimeError as err:
        error = str(err)
    finally:
        trainer_mod.clip_by_global_norm = clip
    # the failed capture leaves neither its stream current nor the
    # allocator routing to its pool: memory freed after it goes back to
    # the device on empty_cache
    same_stream = torch.cuda.current_stream() == stream
    torch.empty(1 << 30, dtype=torch.uint8, device="cuda")
    cached = torch.cuda.memory_reserved()
    torch.cuda.empty_cache()
    released = cached - torch.cuda.memory_reserved()
    after = flatten(tr.params)
    count = tr.opt_state()["count"]
    unchanged = all(np.array_equal(before[k], after[k]) for k in before)
    retry = tr.steps([batch])
    rec = {"phase": "train_graphs_failed_capture", "raised": error is not None,
           "error": (error or "")[:200], "params_unchanged": unchanged,
           "adam_count_after": count, "retry_finite": finite_losses(retry),
           "adam_count_after_retry": tr.opt_state()["count"],
           "caller_stream_restored": same_stream,
           "bytes_released_by_empty_cache": released}
    emit(rec)
    check(error is not None and unchanged and count == GRAPH_WARMUP_STEPS,
          "a failed capture did not raise, or a step ran in its place")
    check(same_stream and released >= 1 << 30,
          f"after a failed capture: caller's stream {same_stream}, "
          f"empty_cache released {released} bytes of a freed GiB")
    check(rec["retry_finite"]
          and rec["adam_count_after_retry"] == GRAPH_WARMUP_STEPS + 1,
          "the capture after a failed one did not step")
    return rec


def train_graphs_path(rs, batch, eager):
    """The graphed train path (the bench configuration in bf16 and f32,
    counters zeroed before and read after), then its checks: graphed
    against eager, ``accum_steps=2`` at full width and against the CPU,
    the optimizer-state trip, a failed capture.  Returns the summaries
    and the kernel counters of the graphed runs."""
    t_phase = time.perf_counter()
    for k in span_region.launches:
        span_region.launches[k] = 0
    graphs = {dtype: graphed_train(dtype, batch, eager[dtype])
              for dtype in ("bfloat16", "float32")}
    path_launches = dict(span_region.launches)
    check(all(v >= 1 for v in path_launches.values()),
          f"the graphed train path skipped a span_region kernel: "
          f"{path_launches}")
    base = Trainer.build(*train_configs("float32"), V, seed=SEED + 5,
                         device="cpu")
    flat = perturbed(base.params, rs)
    del base
    batches = [{k: torch.as_tensor(v).to("cuda") for k, v in
                train_batch(rs, B, N, V, K_NEG, R, F).items()}
               for _ in range(4)]
    graphed_vs_eager(flat, batches[:3])
    graphed_two_keys(rs)
    graphed_accum(batch)
    graphed_accum_vs_cpu(rs)
    opt_state_trip(batches)
    failed_capture_raises(rs)
    emit({"phase": "train_graphs_summary", "launches": path_launches,
          "wall_seconds": time.perf_counter() - t_phase})
    return graphs, path_launches


def span_region_timing(span, obj, g, am):
    """Each of K2-K4 against its plain version on the same inputs: plain,
    kernel, kernel, plain; and its CUDA launches per call, segment_reduce
    included (K3 and K4 with the segment count they took)."""
    dt = span.dtype
    A, M, Dd = span.shape
    C, Rr, _ = obj.shape
    segments = {"span_region_dspan": span_region.dspan_segments(A * M, C, Dd),
                "span_region_dobj": span_region.dobj_segments(
                    A * M, C, Rr, Dd, dt == torch.bfloat16)}
    calls = {
        "span_region_fwd": (
            lambda: span_region.span_region_fwd(span, obj),
            lambda: span_region.span_region_fwd_plain(span, obj)),
        "span_region_dspan": (
            lambda: span_region.span_region_dspan(obj, am, g, dt),
            lambda: span_region.span_region_dspan_plain(obj, am, g, dt)),
        "span_region_dobj": (
            lambda: span_region.span_region_dobj(span, am, g, Rr,
                                                 torch.float32),
            lambda: span_region.span_region_dobj_plain(span, am, g, Rr,
                                                       torch.float32)),
    }
    out = {}
    for name, (kern, plain) in calls.items():
        p1, k1, k2, p2 = (cuda_ms(plain), cuda_ms(kern), cuda_ms(kern),
                          cuda_ms(plain))
        by_kernel = profile_kernels(kern, reps=5)
        out[name] = {"ms": statistics.median(k1 + k2),
                     "plain_ms": statistics.median(p1 + p2),
                     **sr_bound(name, span, obj), "library_ms": None,
                     "kernel_runs_ms": k1 + k2, "plain_runs_ms": p1 + p2,
                     "cuda_launches_per_call": own_launches(
                         by_kernel, name, "segment_reduce"),
                     "profiled_device_ms": by_kernel}
        if name in segments:
            out[name]["segments"] = segments[name]
        emit({"phase": "timing", "name": name, "dtype": str(dt),
              "span": list(span.shape), "obj": list(obj.shape),
              **out[name]})
    return out


def redesign_timing(span, obj, g):
    """What the kernels redesigned for Hopper (K2, K3, K4) are held to, at
    the bf16 contrastive call: K2's and K4's ``gemm_yardstick_ms``, a
    ``torch.matmul`` of the same bf16 operands timed for the product alone
    (K2: span x obj^T, no max; K4: a dense bf16 W, built outside the timed
    region, x span, one g term); K3 and K4 on the all-ties argmax of a zero
    obj against random argmax, in turns; K4's dense-formulation bound."""
    A, M, Dd = span.shape
    C, Rr, _ = obj.shape
    dev = span.device
    s2 = span.reshape(A * M, Dd)
    o2 = obj.to(torch.bfloat16).reshape(C * Rr, Dd)
    _, am = span_region.span_region_fwd(span, obj)
    _, am0 = span_region.span_region_fwd(span, torch.zeros_like(obj))
    w = torch.zeros(C * Rr, A * M, dtype=torch.bfloat16, device=dev)
    row = torch.arange(C, device=dev)[None, :, None] * Rr + am.long()
    col = (torch.arange(A, device=dev)[:, None, None] * M
           + torch.arange(M, device=dev)[None, None, :]).expand(A, C, M)
    w[row.reshape(-1), col.reshape(-1)] = g.reshape(-1).to(torch.bfloat16)
    k2_yard = cuda_ms(lambda: torch.matmul(s2, o2.t()))
    k4_yard = cuda_ms(lambda: torch.matmul(w, s2))
    del w

    def k4(a):
        return lambda: span_region.span_region_dobj(span, a, g, Rr,
                                                    torch.float32)

    def k3(a):
        return lambda: span_region.span_region_dspan(obj, a, g, span.dtype)

    def ties_vs_random(kern):
        r1, t1, t2, r2 = (cuda_ms(kern(am)), cuda_ms(kern(am0)),
                          cuda_ms(kern(am0)), cuda_ms(kern(am)))
        return statistics.median(r1 + r2), statistics.median(t1 + t2)

    rand_ms, ties_ms = ties_vs_random(k4)
    k3_rand_ms, k3_ties_ms = ties_vs_random(k3)
    dense = 2 * (2 * C * Rr * A * M * Dd)     # two bf16 terms of g
    out = {
        "span_region_fwd": {
            "gemm_yardstick_ms": statistics.median(k2_yard),
            "gemm_yardstick": "torch.matmul(span (A*M, D) bf16, obj "
                              "(C*R, D) bf16 transposed): the product "
                              "alone, no max"},
        "span_region_dobj": {
            "gemm_yardstick_ms": statistics.median(k4_yard),
            "gemm_yardstick": "torch.matmul(dense W (C*R, A*M) bf16 built "
                              "outside the timed region, span (A*M, D) "
                              "bf16): the product alone, one g term",
            "random_argmax_ms": rand_ms, "all_ties_ms": ties_ms,
            "all_ties_over_random": ties_ms / rand_ms,
            "g_terms": 2, "flop_dense_formulation": dense,
            "bound_ms_dense_formulation": dense / PEAK_FLOPS["bfloat16"]
            * 1e3},
        "span_region_dspan": {
            "random_argmax_ms": k3_rand_ms, "all_ties_ms": k3_ties_ms,
            "all_ties_over_random": k3_ties_ms / k3_rand_ms},
    }
    for name, rec in out.items():
        emit({"phase": "redesign_timing", "name": name, **rec})
    return out


def f32_redesign_timing(span, obj, g):
    """What the f32 routes of K2 and K4 are held to at a call with f32
    spans: K2's ``gemm_yardstick_ms``, a ``torch.matmul`` of the same f32
    operands with TF32 off (span x obj^T, the product alone, no max), and
    K4 on the all-ties argmax of a zero obj against random argmax, in
    turns."""
    A, M, Dd = span.shape
    C, Rr, _ = obj.shape
    check(not torch.backends.cuda.matmul.allow_tf32,
          "the f32 yardstick must run without TF32")
    s2, o2 = span.reshape(A * M, Dd), obj.reshape(C * Rr, Dd)
    _, am = span_region.span_region_fwd(span, obj)
    _, am0 = span_region.span_region_fwd(span, torch.zeros_like(obj))

    def k4(a):
        return lambda: span_region.span_region_dobj(span, a, g, Rr,
                                                    torch.float32)

    r1, t1, t2, r2 = (cuda_ms(k4(am)), cuda_ms(k4(am0)), cuda_ms(k4(am0)),
                      cuda_ms(k4(am)))
    rand_ms, ties_ms = statistics.median(r1 + r2), statistics.median(t1 + t2)
    return {
        "span_region_fwd": {
            "gemm_yardstick_ms": statistics.median(
                cuda_ms(lambda: torch.matmul(s2, o2.t()))),
            "gemm_yardstick": "torch.matmul(span (A*M, D) f32, obj (C*R, D) "
                              "f32 transposed), TF32 off: the product "
                              "alone, no max"},
        "span_region_dobj": {
            "random_argmax_ms": rand_ms, "all_ties_ms": ties_ms,
            "all_ties_over_random": ties_ms / rand_ms,
            "random_runs_ms": r1 + r2, "all_ties_runs_ms": t1 + t2},
    }


def k3_staging_timing(span, obj, g):
    """K3's two ways of staging argmax and g, in turns on the same inputs:
    8-byte copies of two rows (M even and both 8-byte aligned, as the
    step's tensors are) and 4-byte copies of one row, taken here by
    handing the wrapper copies of argmax and g that start 4 bytes past an
    8-byte boundary.  Both must give the same bits."""
    M = span.shape[1]
    _, am = span_region.span_region_fwd(span, obj)

    def offset4(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        return buf[1:].view(t.shape).copy_(t)

    am4, g4 = offset4(am), offset4(g)
    check(am.data_ptr() % 8 == 0 and g.data_ptr() % 8 == 0
          and am4.data_ptr() % 8 == 4 and g4.data_ptr() % 8 == 4,
          "K3 staging: argmax and g not at the alignments to compare")

    def k3(a, gg):
        return lambda: span_region.span_region_dspan(obj, a, gg, span.dtype)

    e1, f1, f2, e2 = (cuda_ms(k3(am, g)), cuda_ms(k3(am4, g4)),
                      cuda_ms(k3(am4, g4)), cuda_ms(k3(am, g)))
    rec = {"m_even": M % 2 == 0,
           "copies_8byte_ms": statistics.median(e1 + e2),
           "copies_4byte_ms": statistics.median(f1 + f2),
           "copies_8byte_runs_ms": e1 + e2, "copies_4byte_runs_ms": f1 + f2,
           "equal_bits": bool(torch.equal(k3(am, g)(), k3(am4, g4)()))}
    rec["copies_4byte_over_8byte"] = (rec["copies_4byte_ms"]
                                      / rec["copies_8byte_ms"])
    emit({"phase": "k3_staging_timing", "name": "span_region_dspan",
          "dtype": str(span.dtype), "span": list(span.shape), **rec})
    check(rec["equal_bits"], "K3: its two staging paths disagree")
    return rec


def f32_split_timing(span, obj, g):
    """K4 on f32 spans: its f32 route (``k4_dobj_regs`` at R = 36) against
    the split formulation -- span = bf16 hi + bf16 lo, each through the
    bf16 one-hot GEMM, summed -- on the same inputs, in turns, with each
    one's error against the plain version: elementwise (as a fraction of
    the largest magnitude), and of the sum over all C*R region rows (as a
    fraction of that sum's largest magnitude), the reduction a bias shared
    by every region's embedding takes of dobj."""
    Rr = obj.shape[1]
    _, am = span_region.span_region_fwd(span, obj)

    def f32_route():
        return span_region.span_region_dobj(span, am, g, Rr, torch.float32)

    def split():
        hi = span.to(torch.bfloat16)
        lo = (span - hi.float()).to(torch.bfloat16)
        return (span_region.span_region_dobj(hi, am, g, Rr, torch.float32)
                + span_region.span_region_dobj(lo, am, g, Rr, torch.float32))

    want = span_region.span_region_dobj_plain(span, am, g, Rr, torch.float32)
    scale = max(1.0, want.abs().max().item())
    want_sum = want.sum((0, 1))
    sum_scale = want_sum.abs().max().item()
    got = {"split": split(), "f32": f32_route()}
    err = {k: (v - want).abs().max().item() for k, v in got.items()}
    sum_err = {k: (v.sum((0, 1)) - want_sum).abs().max().item() / sum_scale
               for k, v in got.items()}
    s1, k1, k2, s2 = cuda_ms(f32_route), cuda_ms(split), cuda_ms(split), \
        cuda_ms(f32_route)
    rec = {"ms": statistics.median(k1 + k2),
           "f32_route_ms": statistics.median(s1 + s2),
           "max_abs_err": err["split"], "f32_route_max_abs_err": err["f32"],
           "scale": scale, "within_rtol": err["split"] <= SR_F32_RTOL * scale,
           "region_sum_rel_err": sum_err["split"],
           "f32_route_region_sum_rel_err": sum_err["f32"]}
    emit({"phase": "f32_split_timing", "name": "span_region_dobj",
          "span": list(span.shape), **rec})
    return rec


def train_path(rs):
    """K2-K4 against their plain versions, the train steps, the route and
    CPU comparisons, timing.  Returns the K2-K4 entries of the kernels
    line."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    # the two calls of a step: VG (x_word x obj_word, f32) and contrastive
    # ((inside_h + outside_h) x obj_span, bf16 charts in the bf16 step, f32
    # in the f32 step); an odd shape; the edges of the Hopper tiles: R=144
    # (one image a K2 column tile), D=16 (one k tile; K4 boxes outside D),
    # a D tail inside a 64-deep k tile, C*R not a multiple of 128 with many
    # K4 row segments
    shapes = {"vg": (B, N, B, R, D, "float32"),
              "contrastive": (B, ncells(N), B, R, D, "bfloat16"),
              "contrastive_f32": (B, ncells(N), B, R, D, "float32"),
              "odd": (37, 13, 37, R, D, None),
              "edge_r144": (5, 7, 3, 144, D, None),
              "edge_d16": (4, 9, 6, R, 16, None),
              "edge_ktail": (3, 50, 5, R, 72, None),
              "edge_segments": (64, 100, 16, R, D, None),
              # the widest D supports() takes: 32 K3 slices
              "edge_d1024": (6, 30, 9, R, 1024, None)}
    checked, inputs = {}, {}
    for tag, (a, m, c, r, d, only) in shapes.items():
        for dtype in ((only,) if only else ("float32", "bfloat16")):
            tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
            span = randn(a, m, d).to(tdt)
            obj, g = randn(c, r, d), randn(a, c, m)
            rec = span_region_vs_plain(span, obj, g)
            emit({"phase": "kernel", "name": "span_region", "case": tag,
                  "dtype": dtype, "span": [a, m, d], "obj": [c, r, d], **rec})
            check_span_region(rec, f"span_region {tag} {dtype}",
                              dtype == "bfloat16")
            checked[(tag, dtype)] = rec
            if only:
                inputs[tag] = (span, obj, g)
    torch.cuda.empty_cache()

    # -- the main path: full-width CLIORA train steps through Trainer.step,
    # on a batch kept on the card as bench.py keeps it (a prefetching
    # pipeline uploads the next batch while a step runs)
    batch = {k: torch.as_tensor(v).to(dev)
             for k, v in train_batch(rs, B, N, V, K_NEG, R, F).items()}
    for k in span_region.launches:
        span_region.launches[k] = 0
    train = {dtype: train_steps(dtype, batch)
             for dtype in ("bfloat16", "float32")}
    path_launches = dict(span_region.launches)
    check(all(v >= 2 * TRAIN_STEPS for v in path_launches.values()),
          f"the train path skipped a span_region kernel: {path_launches}")

    route_vs_chunked(rs)
    train_cpu_reference(rs)
    # the graphed path draws from its own stream: the inputs above stay
    graphs, graph_launches = train_graphs_path(
        np.random.RandomState(SEED + 2), batch, train)

    # -- timing at the main path's shapes
    timing = {}
    for tag in ("contrastive", "contrastive_f32", "vg"):
        span, obj, g = inputs[tag]
        _, am = span_region.span_region_fwd(span, obj)
        timing[tag] = span_region_timing(span, obj, g, am)
    redesign = redesign_timing(*inputs["contrastive"])
    f32_redesign = {}
    for tag in ("vg", "contrastive_f32"):
        f32_redesign[tag] = f32_redesign_timing(*inputs[tag])
        for name, rec in f32_redesign[tag].items():
            emit({"phase": "redesign_timing", "name": name, "call": tag,
                  "dtype": "float32", **rec})
    for tag in ("contrastive", "contrastive_f32"):
        k3_staging_timing(*inputs[tag])
    split = f32_split_timing(*inputs["contrastive_f32"])
    err_keys = {"span_region_fwd": "fwd_max_abs_err",
                "span_region_dspan": "dspan_max_abs_err",
                "span_region_dobj": "dobj_max_abs_err"}
    entries = []
    for name in SR_KERNELS:
        main = timing["contrastive"][name]
        err_key = err_keys[name]
        entry = {
            "name": name, **KERNELS[name],
            "launches": path_launches[name],
            "max_abs_err": checked[("contrastive", "bfloat16")][err_key],
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": None, "dtype": "bfloat16",
            "span": [B, ncells(N), D], "obj": [B, R, D],
            "cuda_launches_per_call": main["cuda_launches_per_call"],
            "launches_per_step_profiled": {
                dt: train[dt]["launches_per_step_profiled"][name]
                for dt in train},
            # Trainer.steps: the wrapper counts the warm-up steps' and the
            # capture's launches; a replayed step's come from the profile
            "graphed": {
                "launches": graph_launches[name],
                "launches_per_replayed_step_profiled": {
                    dt: graphs[dt]["launches_per_replayed_step_profiled"][
                        name] for dt in graphs}},
        }
        extra = ("segments", "smem_floor_ms", "sm_clock_max_hz")
        entry.update({k: main[k] for k in extra if k in main})
        for tag in ("contrastive_f32", "vg"):
            t = timing[tag][name]
            entry[tag] = ({k: t[k] for k in ("ms", "plain_ms", "bound_ms",
                                              "bound_by") + extra if k in t}
                          | {"max_abs_err": checked[(tag, "float32")][err_key],
                             "span": list(inputs[tag][0].shape),
                             "cuda_launches_per_call":
                                 t["cuda_launches_per_call"]}
                          | SR_F32_ROUTES[name]
                          | f32_redesign[tag].get(name, {}))
        entry.update(redesign.get(name, {}))
        if name == "span_region_dobj":
            entry["contrastive_f32"]["split_bf16"] = split
        entries.append(entry)
    return entries


# -- phase cli: the port's train and parse CLIs end to end --------------------

def synthetic_flickr(out_dir, n_train, n_test):
    """The grounded corpus of tools/make_synthetic_flickr.py in the Flickr
    layout.  Where ``h5py`` imports, the tool runs in a subprocess and
    writes every file; where it does not, this function writes the text,
    pickle and json files itself (the tool's ``make_split``, the same
    generator, seeds and draws) and returns each mode's region arrays
    ``(features, bboxes, pos_bboxes)`` for ``FlickrDataset`` in place of
    its HDF5 file.  Returns ``(arrays by mode or None, route)``."""
    if importlib.util.find_spec("h5py") is not None:
        tool = os.path.join(ROOT, "tools", "make_synthetic_flickr.py")
        subprocess.run([sys.executable, tool, out_dir, str(n_train),
                        str(n_test)],
                       check=True, capture_output=True, text=True,
                       timeout=600)
        return None, "hdf5"
    return write_synthetic_flickr(out_dir, n_train, n_test), "in_memory"


def write_synthetic_flickr(out_dir, n_train, n_test):
    """tools/make_synthetic_flickr.py without ``h5py``: its files but the
    HDF5 features, whose arrays are returned by mode."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from make_synthetic_ptb import (make_vocab, sample_tree, tree_leaves,
                                    tree_spans, write_embeddings)
    feat_dim, max_regions, vis_noise = 2048, 12, 0.1
    os.makedirs(out_dir, exist_ok=True)
    classes = make_vocab()
    nouns = classes["n"]
    word2idx = {"_PAD": 0, "<unk>": 1}
    for cls in classes.values():
        for word in cls:
            word2idx[word] = len(word2idx)
    with open(os.path.join(out_dir, "flickr.dic.json"), "w") as f:
        json.dump(word2idx, f)
    write_embeddings(os.path.join(out_dir, "glove.txt"), classes)
    vis_rng = np.random.RandomState(99)
    centroids = {w: vis_rng.randn(feat_dim) for w in nouns}
    with open(os.path.join(out_dir, "objects_vocab.txt"), "w") as f:
        f.write("\n".join(nouns) + "\n")

    def box_of(slot):
        x = 20.0 * slot
        return [x, 0.0, x + 10.0, 10.0]

    next_img_id = {"train": 10000, "test": 50000}
    arrays = {}
    for split, n, seed in (("train", n_train, 21), ("test", n_test, 22)):
        mode = split
        rng = np.random.RandomState(seed)
        lines, id_lines, anno = [], [], {}
        feats, bboxes, pos = [], [], []
        imgid2idx, det = {}, {}
        while len(lines) < n:
            tree = sample_tree(rng, classes)
            leaves = tree_leaves(tree)
            if not 4 <= len(leaves) <= 16:
                continue
            img_id = next_img_id[mode]
            next_img_id[mode] += 1
            noun_pos = [i for i, w in enumerate(leaves) if w in centroids]
            sent_nouns = []
            for i in noun_pos:
                if leaves[i] not in sent_nouns \
                        and len(sent_nouns) < max_regions:
                    sent_nouns.append(leaves[i])
            n_distract = min(max_regions - len(sent_nouns),
                             rng.randint(2, 6))
            others = [w for w in nouns if w not in sent_nouns]
            region_words = sent_nouns + list(
                rng.choice(others, n_distract, replace=False))
            rng.shuffle(region_words)
            phrases = {
                f"phr{i}": (i, i + 1, box_of(region_words.index(leaves[i])))
                for i in noun_pos if leaves[i] in region_words}
            start = len(feats)
            for w in region_words:
                feats.append(centroids[w] + vis_noise * rng.randn(feat_dim))
            bboxes += [box_of(k) for k in range(len(region_words))]
            pos.append([start, start + len(region_words)])
            imgid2idx[img_id] = len(imgid2idx)
            det[str(img_id)] = {"classes": list(region_words)}
            lines.append([" ".join(leaves),
                          [(a, b) for a, b in tree_spans(tree)]])
            id_lines.append(f"{img_id}\t0")
            if mode == "test":
                anno[f"{img_id}_0"] = [phrases, [1, 1]]
        with open(os.path.join(out_dir, f"flickr_{split}.json"), "w") as f:
            for ln in lines:
                f.write(json.dumps(ln) + "\n")
        with open(os.path.join(out_dir, f"{split}.txt"), "w") as f:
            f.write("\n".join(id_lines) + "\n")
        if mode == "test":
            with open(os.path.join(out_dir, f"gt_anno_{split}.pkl"),
                      "wb") as f:
                pickle.dump(anno, f)
        arrays[mode] = (np.asarray(feats, np.float32),
                        np.asarray(bboxes, np.float32),
                        np.asarray(pos, np.int64))
        with open(os.path.join(out_dir, f"{mode}_imgid2idx.pkl"), "wb") as f:
            pickle.dump(imgid2idx, f)
        with open(os.path.join(out_dir, f"{mode}_detection_dict.json"),
                  "w") as f:
            json.dump(det, f)
    return arrays


def cli_eval_batches(args, region_features=None):
    """Validation batches the CLI's eval parses (length above 2), from the
    port's own option parsing and iterator factory."""
    options = cli_flags.parse_args(cli_flags.argument_parser(), args)
    dataset = cli_common.get_validation_dataset(options)
    it = cli_common.get_validation_iterator(options, dataset,
                                            region_features=region_features)
    return sum(1 for bm in it.get_iterator(random_seed=options.seed)
               if bm["length"] > 2)


def cli_log_lines(experiment_path, *marks):
    with open(os.path.join(experiment_path, "experiment.log")) as f:
        return [line.strip() for line in f if any(m in line for m in marks)]


def run_cli(stage, main_fn, args, region_features):
    """One CLI ``main(args)`` in this process, its console log kept out of
    this script's output (the experiment log keeps it): the kernel
    counters zeroed just before and read just after, peak memory, wall
    seconds.  Returns ``(main's result, record)``."""
    zero_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    kwargs = ({} if region_features is None
              else {"region_features": region_features})
    with contextlib.redirect_stdout(io.StringIO()):
        out = main_fn(args, **kwargs)
    torch.cuda.synchronize()
    rec = {"phase": "cli_stage", "stage": stage,
           "wall_seconds": time.perf_counter() - t0,
           "launches": kernel_counts(),
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
    return out, rec


def cli_train_record(rec, trainer, records, experiment_path):
    """The train CLI's epochs (its own sents/s line, wall and eval wall
    seconds, eval metrics) and its graphs: shape keys captured, capture
    seconds, warm-up steps, pools."""
    rec.update({
        "epochs": records,
        "epoch_log": cli_log_lines(experiment_path, "EPOCH-END",
                                   "corpus_f1="),
        "graphs": len(trainer._graphs),
        "graph_pools": int(trainer._graph_pool is not None),
        "shape_keys_captured": [list(k) for k in trainer._graphs],
        "capture_seconds_total": sum(trainer.capture_seconds.values()),
        "capture_seconds_max": max(trainer.capture_seconds.values(),
                                   default=None),
        # warm-up steps and captures together: the first epoch's wall
        # seconds over a later one's (the same batches, all shapes warm)
        "first_epoch_extra_seconds": (records[0]["wall_s"]
                                      - records[1]["wall_s"]
                                      if len(records) > 1
                                      and records[0]["epoch"] == 0
                                      else None),
        "warmup_steps": sum(trainer._warmed.values()),
        "host_step": trainer._host_step,
    })
    check(all(bool(torch.isfinite(p).all())
              for p in tree_leaves(trainer.params)),
          f"cli {rec['stage']}: non-finite parameters")
    for r in records:
        base = os.path.join(experiment_path, f"model.epoch_{r['epoch']}")
        for path in (base + ".npz", base + ".pt", base + ".opt.pkl",
                     os.path.join(experiment_path,
                                  f"experiment.epoch_{r['epoch']}.json")):
            check(os.path.exists(path), f"cli {rec['stage']}: no {path}")
        check(all(math.isfinite(v) for v in r["metrics"].values()),
              f"cli {rec['stage']}: eval metrics {r['metrics']}")
    return rec


def cli_replay_profile(trainer, args, region_features):
    """A profiled replay of one captured shape (a train batch of the
    corpus): K2-K4 by name, graph launches, finite losses."""
    options = cli_flags.parse_args(cli_flags.argument_parser(), args)
    train = cli_common.get_train_dataset(options)
    it = cli_common.get_train_iterator(
        options, train, region_features=region_features.get("train")
        if region_features else None)
    for bm in it.get_iterator(random_seed=0):
        key = trainer._graph_key(trainer._place_batch(bm))
        if key in trainer._graphs:
            break
    else:
        check(False, "cli: no captured shape among the train batches")
    calls, res = {}, []
    by_kernel = profile_kernels(lambda: res.extend(trainer.steps([bm])),
                                calls=calls)
    in_step = {k: own_launches(by_kernel, k) for k in SR_KERNELS}
    check(finite_losses(res), "cli: non-finite loss in a replayed step")
    return {"shape_key": list(key), "launches_profiled": in_step,
            "graph_launches": calls.get("cudaGraphLaunch", 0),
            "device_busy_ms": sum(r["ms"] for r in by_kernel.values()),
            "losses": {k: float(v) for k, v in res[0].items()}}, bm


UPLOAD_BATCHES = 8


def upload_timing(obj):
    """A CLIORA batch's regions uploaded the old way (a pageable
    ``torch.as_tensor`` to the card) against the prefetcher's way (a
    pinned host buffer copied ``non_blocking`` on its side stream): the
    copy's device ms by CUDA events (median of 5 after one warm-up), and
    the host ms a batch over UPLOAD_BATCHES batches in a row to one sync,
    as a training loop feeds them (median of 3), the prefetcher's staging
    into pinned memory included."""
    dev = torch.device("cuda")
    pinned = torch.empty(obj.shape, dtype=torch.float32, pin_memory=True)
    pinned.numpy()[...] = obj
    copies = {"pageable": lambda: torch.as_tensor(obj, device=dev),
              "pinned": lambda: pinned.to(dev, non_blocking=True)}

    def pageable_stream():
        for _ in range(UPLOAD_BATCHES):
            torch.as_tensor(obj, device=dev)

    def pinned_stream():
        batches = iter([{"obj_feats": obj}] * UPLOAD_BATCHES)
        for _ in device_prefetch(batches, dev):
            pass

    streams = {"pageable": pageable_stream, "pinned": pinned_stream}
    out = {"bytes": int(obj.nbytes), "batches_in_a_row": UPLOAD_BATCHES}
    for name in copies:
        device_ms, host_ms = [], []
        for _ in range(6):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            copies[name]()
            end.record()
            torch.cuda.synchronize()
            device_ms.append(start.elapsed_time(end))
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            streams[name]()
            torch.cuda.synchronize()
            host_ms.append((time.perf_counter() - t0) * 1e3
                           / UPLOAD_BATCHES)
        out[name] = {"copy_device_ms": statistics.median(device_ms[1:]),
                     "host_ms_a_batch": statistics.median(host_ms[1:])}
    return out


def step_peak(cfg, tc, batch, vocab=V):
    """Peak memory of one eager train step above what the trainer
    holds."""
    tr = Trainer.build(cfg, tc, vocab, seed=SEED)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    check(finite_losses([tr.step(batch)]),
          f"step of {tuple(batch['sentences'].shape)}: non-finite loss")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del tr
    free_card()
    return peak


def diora_step_peak(n, vocab):
    """Peak memory of one eager DIORA train step at the DIORA stage's
    configuration (B=32, D=400, E=1024, k_neg=100, f32) on sentences of
    length ``n``, above what the trainer holds."""
    rs = np.random.RandomState(n)
    return step_peak(ModelConfig(size=400, input_size=1024),
                     TrainConfig(lr=5e-4, k_neg=100, emb_trainable=True),
                     {"sentences": rs.randint(2, vocab, (32, n)),
                      "neg_samples": rs.choice(vocab, 100, replace=False)},
                     vocab)


def equal_files(a, b):
    """``.npz`` or ``.opt.pkl`` files of two runs: equal bits, and the
    largest absolute difference."""
    if a.endswith(".npz"):
        with np.load(a) as za, np.load(b) as zb:
            fa, fb = {k: za[k] for k in za.files}, {k: zb[k] for k in zb.files}
    else:
        oa, ob = load_opt_state(a), load_opt_state(b)
        fa = {f"{p}/{k}": v for p in ("mu", "nu") for k, v in oa[p].items()}
        fb = {f"{p}/{k}": v for p in ("mu", "nu") for k, v in ob[p].items()}
        fa["count"], fb["count"] = np.asarray(oa["count"]), np.asarray(
            ob["count"])
    check(sorted(fa) == sorted(fb), f"{a} and {b} hold other keys")
    return (all(np.array_equal(fa[k], fb[k]) for k in fa),
            max(float(np.abs(fa[k].astype(np.float64) - fb[k]).max())
                for k in fa))


def cli_path():
    """Phase ``cli``: the port's CLIs through their ``main(args)`` in this
    process, as scripts/train_diora.sh -> scripts/train_cliora.sh ->
    scripts/test_diora.sh / test_cliora.sh run them, on a synthetic
    grounded corpus of CLI_TRAIN + CLI_TEST captions.  Returns the kernel
    counters of each stage."""
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        corpus = os.path.join(work, "corpus")
        t0 = time.perf_counter()
        arrays, route = synthetic_flickr(corpus, CLI_TRAIN, CLI_TEST)
        with open(os.path.join(corpus, "flickr.dic.json")) as f:
            vocab = len(json.load(f))
        emit({"phase": "cli_corpus", "route": route,
              "h5py": route == "hdf5", "train": CLI_TRAIN,
              "test": CLI_TEST, "vocab": vocab,
              "regions": {m: int(a[0].shape[0]) for m, a in
                          (arrays or {}).items()},
              "seconds": time.perf_counter() - t0})
        data = ["--data_type", "flickr",
                "--train_path", os.path.join(corpus, "flickr_train.json"),
                "--validation_path", os.path.join(corpus, "flickr_test.json"),
                "--data_path", corpus + "/"]
        exp = {name: os.path.join(work, name) for name in (
            "diora", "cliora", "cliora_full", "parse_diora", "parse")}
        launches = {}

        # DIORA pretraining (scripts/train_diora.sh), 2 epochs
        args = (DIORA_FLAGS + data + CLI_RUN_FLAGS
                + ["--max_epoch", "2", "--experiment_path", exp["diora"]])
        n_eval = cli_eval_batches(args)
        (tr, records), rec = run_cli("diora", cli_train.main, args, None)
        emit(cli_train_record(rec, tr, records, exp["diora"]))
        launches["diora"] = rec["launches"]
        check(rec["launches"]["inside_cky"] == 2 * n_eval,
              f"cli diora: K1 launched {rec['launches']['inside_cky']} "
              f"times, expected one per eval batch ({n_eval}) in each of "
              f"2 epochs")
        del tr
        torch.cuda.empty_cache()

        # CLIORA finetuning (scripts/train_cliora.sh) from the DIORA
        # checkpoint, 1 epoch; then --resume auto to 2 epochs, against an
        # uninterrupted 2-epoch run
        cl = (CLIORA_FLAGS + data + CLI_RUN_FLAGS
              + ["--attn_impl", "cuda", "--load_model_path",
                 os.path.join(exp["diora"], "model.epoch_1.npz")])
        stages = (("cliora", exp["cliora"], "1", []),
                  ("cliora_resume", exp["cliora"], "2", ["--resume", "auto"]),
                  ("cliora_uninterrupted", exp["cliora_full"], "2", []))
        for stage, path, epochs, extra in stages:
            args = cl + ["--max_epoch", epochs, "--experiment_path", path]
            if stage == "cliora_resume":
                epoch0 = os.path.getmtime(
                    os.path.join(path, "model.epoch_0.npz"))
            (tr, records), rec = run_cli(stage, cli_train.main,
                                         args + extra, arrays)
            rec = cli_train_record(rec, tr, records, path)
            launches[stage] = rec["launches"]
            want = 2 * (rec["warmup_steps"] + rec["graphs"])
            check(all(rec["launches"][k] == want for k in SR_KERNELS)
                  and rec["launches"]["inside_cky"] == 0,
                  f"cli {stage}: kernel launches {rec['launches']}, "
                  f"expected {want} of each of K2-K4 (2 a warm-up step "
                  f"and 2 a capture) and no K1")
            if stage == "cliora":
                rec["replay"], batch = cli_replay_profile(tr, args, arrays)
                check(all(v == 2 for v in
                          rec["replay"]["launches_profiled"].values()),
                      f"cli: K2-K4 in a replayed step "
                      f"{rec['replay']['launches_profiled']}, expected 2 "
                      f"each")
            if stage == "cliora_resume":
                check([r["epoch"] for r in records] == [1],
                      f"cli resume trained epochs "
                      f"{[r['epoch'] for r in records]}, expected [1]")
                check(os.path.getmtime(os.path.join(
                    path, "model.epoch_0.npz")) == epoch0,
                    "cli resume rewrote epoch 0")
            emit(rec)
            del tr
            torch.cuda.empty_cache()
        resume = {}
        for suffix in (".npz", ".opt.pkl"):
            bits, diff = equal_files(
                os.path.join(exp["cliora"], "model.epoch_1" + suffix),
                os.path.join(exp["cliora_full"], "model.epoch_1" + suffix))
            resume[suffix] = {"equal_bits": bits, "max_abs_diff": diff}
        emit({"phase": "cli_resume", "train": CLI_TRAIN,
              "resumed_vs_uninterrupted": resume})

        # the parse scripts (scripts/test_diora.sh, test_cliora.sh)
        args = (["--batch_size", "64", "--emb", "none", "--hidden_dim",
                 "400", "--postprocess", "--load_model_path",
                 os.path.join(exp["diora"], "model.epoch_1.npz"),
                 "--experiment_path", exp["parse_diora"]] + data)
        n_eval = cli_eval_batches(args)
        metrics, rec = run_cli("parse_diora", cli_parse_diora.main, args,
                               None)
        rows = cli_rows(exp["parse_diora"])
        rec.update({"metrics": metrics, "rows": len(rows),
                    "parse_impl": sorted({r["parse_impl"] for r in rows})})
        emit(rec)
        launches["parse_diora"] = rec["launches"]
        check(rec["launches"]["inside_cky"] == n_eval and len(rows) ==
              CLI_TEST and rec["parse_impl"] == ["cuda"],
              f"cli parse_diora: K1 {rec['launches']['inside_cky']} of "
              f"{n_eval} batches, {len(rows)} rows, routes "
              f"{rec['parse_impl']}")
        args = (["--batch_size", "64", "--emb", "none", "--hidden_dim",
                 "400", "--obj_feats", "--postprocess", "--load_model_path",
                 os.path.join(exp["cliora"], "model.epoch_1.npz"),
                 "--experiment_path", exp["parse"]] + data)
        metrics, rec = run_cli("parse", cli_parse.main, args,
                               arrays and arrays["test"])
        rows = cli_rows(exp["parse"])
        rec.update({"metrics": metrics, "rows": len(rows),
                    "rows_with_boxes": sum(bool(r["pred_boxes"])
                                           for r in rows),
                    "parse_impl": sorted({r["parse_impl"] for r in rows})})
        emit(rec)
        launches["parse"] = rec["launches"]
        check(len(rows) == CLI_TEST and all(
            math.isfinite(v) for v in metrics.values()),
            f"cli parse: {len(rows)} rows, metrics {metrics}")

        # memory: one DIORA step at the corpus's longest length and at
        # train_diora.sh's filter length, and the pinned upload
        peaks = {n: diora_step_peak(n, vocab) for n in (16, 40)}
        obj = np.asarray(batch["obj_feats"])
        emit({"phase": "cli_memory_and_upload",
              "diora_step_peak_bytes_by_length": peaks,
              "upload_cliora_batch": upload_timing(obj),
              "upload_bench_batch": upload_timing(
                  np.concatenate([obj] * (B // obj.shape[0]), 0))})
    emit({"phase": "cli_summary", "launches": launches,
          "wall_seconds": time.perf_counter() - t_phase})
    return launches


def cli_rows(experiment_path):
    with open(os.path.join(experiment_path, "parse.jsonl")) as f:
        return [json.loads(line) for line in f]


# -- phases treelstm, remat, word, cli_archs: every model the JAX package
# builds -------------------------------------------------------------------

# the long-sentence envelope of the JAX package's remat (BASELINE.md:111-122)
REMAT_N = 40
# remat variants of the remat phase: (policy, remat_frac), None = unremated
REMAT_VARIANTS = (None, ("full", 0.0), ("full", 0.85), ("dots", 0.0),
                  ("gathers", 0.0))
# a remat step against the unremated one: the JAX test's limits
# (tests/test_chart_pass.py:189-195)
REMAT_GRAD_RTOL, REMAT_GRAD_ATOL = 1e-4, 2e-6
# scripts/train_cliora.sh's learning rate: with the bench's 5e-4 the
# N(0, 1)-init model diverges at L=40 on a fixed batch (the unremated
# run stops on a non-finite loss within its first steps)
REMAT_LR = 1e-5
# unremated peaks that calibrate the auto-remat copy factor, (B, n)
REMAT_CALIBRATION = ((128, 20), (64, 40), (128, 40))
ARCH_STEPS = 10
ARCH_REQUESTS = 5
CLI_ARCHS_TRAIN, CLI_ARCHS_TEST = 1024, 128


def free_card():
    """Collect unreachable trainers (a reference cycle can keep one, and
    with it its CUDA graphs' memory pool, alive) and return the cached
    blocks to the device."""
    gc.collect()
    torch.cuda.empty_cache()


def zero_counts():
    for k in span_region.launches:
        span_region.launches[k] = 0
    inside_cky.launches = 0


def arch_graphed(tag, cfg, tc, batch, eager_steps=2):
    """``eager_steps`` ``Trainer.step`` calls, then ``Trainer.steps`` over
    ARCH_STEPS batches (the warm-up steps, the cache emptied, the capture,
    replays), a timed run of ARCH_STEPS replays with one sync and a
    profiled replay: step ms eager and graphed, device-busy ms, idle
    share, K2-K4 by name in a replay, peak memory.  The counters are read
    by the caller."""
    tr = Trainer.build(cfg, tc, V, seed=SEED)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    eager_ms, losses = [], []
    for _ in range(eager_steps):
        t0 = time.perf_counter()
        metrics = tr.step(batch)
        losses.append(float(metrics["total_loss"]))          # syncs
        eager_ms.append((time.perf_counter() - t0) * 1e3)
    warm = tr.steps([batch] * GRAPH_WARMUP_STEPS)
    torch.cuda.synchronize()
    # the warm-up steps' blocks go back to the device before the capture
    # takes its own pool
    free_card()
    t0 = time.perf_counter()
    first = tr.steps([batch] * (ARCH_STEPS - GRAPH_WARMUP_STEPS))
    check(finite_losses(warm + first), f"{tag}: non-finite loss")   # syncs
    capture_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    metrics = tr.steps([batch] * ARCH_STEPS)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / ARCH_STEPS
    check(finite_losses(metrics), f"{tag}: non-finite graphed loss")
    peak = torch.cuda.max_memory_allocated()
    calls = {}
    by_kernel = profile_kernels(lambda: tr.steps([batch]), reps=3,
                                calls=calls)
    busy = sum(r["ms"] for r in by_kernel.values())
    losses += [float(m["total_loss"]) for m in warm + first + metrics]
    rec = {"eager_step_ms": eager_ms,
           "capture_and_replays_ms": capture_ms,
           "graphed_step_ms": step_ms,
           "graphed_sentences_per_s": batch["sentences"].shape[0]
           / step_ms * 1e3,
           "replayed_step_device_busy_ms": (busy if by_kernel
                                            else "not measured"),
           "idle_share": 1 - busy / step_ms if by_kernel else "not measured",
           "device_kernels_per_step": sum(r["count"]
                                          for r in by_kernel.values()),
           "graph_launches_per_step": calls.get("cudaGraphLaunch", 0),
           "launches_per_replayed_step_profiled": {
               k: own_launches(by_kernel, k)
               for k in SR_KERNELS + ("segment_reduce", "inside_cky")},
           "max_memory_allocated_bytes": peak,
           "peak_above_trainer_bytes": peak - base,
           "capture_seconds": list(tr.capture_seconds.values()),
           "total_loss_first": losses[0], "total_loss_last": losses[-1],
           "top_kernels": dict(sorted(by_kernel.items(),
                                      key=lambda kv: -kv[1]["ms"])[:6])}
    del tr
    free_card()
    return rec


def arch_vs_eager(tag, cfg, tc, flat, batches):
    """From one set of weights, the batches twice: eager ``step`` calls
    against ``steps`` (warm-up steps, the capture, replays).  Checks
    equal bits of every loss and parameter."""
    seq = batches + batches
    eager = Trainer(cfg, tc, params_from_numpy(flat, "cuda"))
    want = [eager.step(b) for b in seq]
    free_card()
    graphed = Trainer(cfg, tc, params_from_numpy(flat, "cuda"))
    got = graphed.steps(seq)
    pdiff, pbits = params_diff(graphed, eager)
    rec = {"phase": tag + "_vs_eager", "dtype": cfg.compute_dtype,
           "attn_dropout": cfg.attn_dropout, "steps": len(seq),
           "replayed_steps": len(seq) - GRAPH_WARMUP_STEPS,
           "loss_max_rel_diff": max_rel(got, want),
           "losses_equal_bits": all(torch.equal(g[k], w[k])
                                    for g, w in zip(got, want) for k in w),
           "param_max_abs_diff": pdiff, "params_equal_bits": pbits}
    emit(rec)
    check(rec["losses_equal_bits"] and pbits,
          f"{tag} {cfg.compute_dtype}: graphed steps differ from eager "
          f"steps (losses {rec['loss_max_rel_diff']}, params {pdiff})")
    del eager, graphed
    free_card()
    return rec


def card_vs_cpu(tag, cfg, tc, rs):
    """A small f32 step's losses and gradients and a parse's backpointers,
    card against CPU (B=6, L=6, D=48)."""
    small = dict(b=6, n=6, v=100, k=7, regions=5, feats=32)
    base = Trainer.build(cfg, tc, 100, seed=SEED + 6, device="cpu")
    flat = perturbed(base.params, rs)
    batch = train_batch(rs, **small)
    on = {}
    for device in ("cuda", "cpu"):
        metrics, grads = step_grads(cfg, tc, flat, batch, device)
        res, _ = Trainer(cfg, tc, params_from_numpy(flat, device),
                         device=device).parse(batch)
        on[device] = (metrics, {k: g.cpu() for k, g in grads.items()}, res)
    (m_card, g_card, r_card), (m_cpu, g_cpu, r_cpu) = on["cuda"], on["cpu"]
    rel = {k: abs(m_card[k] - m_cpu[k]) / max(abs(m_cpu[k]), 1e-12)
           for k in m_cpu}
    grad_err = {k: float((g_card[k] - g).abs().max())
                / max(1.0, float(g.abs().max())) for k, g in g_cpu.items()}
    rec = {"phase": "cpu_reference", "path": tag, "shape": [6, 6, 48],
           "losses_card": m_card, "loss_rel_diff": rel,
           "grad_max_rel_err": max(grad_err.values()),
           "cky_bp_equal": "cky_bp" not in r_cpu
           or bool(np.array_equal(r_card["cky_bp"], r_cpu["cky_bp"]))}
    emit(rec)
    check(rec["cky_bp_equal"]
          and all(r <= CPU_LOSS_RTOL for r in rel.values())
          and rec["grad_max_rel_err"] <= SR_F32_RTOL,
          f"{tag}: card and CPU differ: {rec}")
    return rec


def treelstm_path(rs):
    """Phase ``treelstm``: the bench configuration with the TreeLSTM
    compose, bf16 and f32, through ``Trainer.step`` and ``Trainer.steps``
    (the main path: K2-K4 twice a step, no K1), graphed against eager
    bits, a TreeLSTM DIORA parse (plain route) and the card against the
    CPU.  Returns the main path's counters."""
    t_phase = time.perf_counter()
    batch = {k: torch.as_tensor(v).to("cuda")
             for k, v in train_batch(rs, B, N, V, K_NEG, R, F).items()}
    zero_counts()
    runs = {}
    for dtype in ("bfloat16", "float32"):
        cfg, tc = train_configs(dtype, arch="treelstm")
        before = kernel_counts()
        runs[dtype] = arch_graphed(f"treelstm {dtype}", cfg, tc, batch)
        after = kernel_counts()
        runs[dtype]["launches"] = {k: after[k] - before[k] for k in after}
    launches = kernel_counts()
    for dtype, rec in runs.items():
        emit({"phase": "treelstm", "dtype": dtype, "batch": B, "n": N,
              **rec})
        in_step = rec["launches_per_replayed_step_profiled"]
        # 2 eager steps, 2 warm-up steps and the capture: 2 each a step
        check(all(rec["launches"][k] == 10 for k in SR_KERNELS)
              and rec["launches"]["inside_cky"] == 0,
              f"treelstm {dtype}: counters {rec['launches']}, expected 10 "
              f"of each of K2-K4 and no K1")
        check(all(in_step[k] == 2 for k in SR_KERNELS),
              f"treelstm {dtype}: K2-K4 in a replay {in_step}")
        check(rec["total_loss_last"] < rec["total_loss_first"],
              f"treelstm {dtype}: loss did not descend")

    for dtype in ("bfloat16", "float32"):
        cfg, tc = train_configs(dtype, arch="treelstm")
        base = Trainer.build(cfg, tc, V, seed=SEED + 7, device="cpu")
        flat = perturbed(base.params, rs)
        del base
        arch_vs_eager("treelstm", cfg, tc, flat, [
            {k: torch.as_tensor(v).to("cuda") for k, v in
             train_batch(rs, B, N, V, K_NEG, R, F).items()}
            for _ in range(3)])

    # a TreeLSTM DIORA parse: the plain route, K1 untouched
    cfg = ModelConfig(size=D, input_size=E, arch="treelstm")
    tr = Trainer.build(cfg, TrainConfig(), V, seed=SEED)
    before = kernel_counts()
    ms, routes = [], set()
    for _ in range(ARCH_REQUESTS):
        req = {"sentences": rs.randint(0, V, (B, N))}
        t0 = time.perf_counter()
        res, _ = tr.parse(req)
        decoded = trees.decode_batch(res["cky_bp"], N)
        ms.append((time.perf_counter() - t0) * 1e3)
        routes.add(res["parse_impl"])
        check(all(covers(t, s, N) for t, s in decoded),
              "treelstm parse: a tree does not cover its sentence")
    emit({"phase": "treelstm_parse", "dtype": "float32", "batch": B,
          "n": N, "request_ms": ms,
          "request_ms_median_warm": statistics.median(ms[1:]),
          "parse_impl": sorted(routes),
          "launches": {k: kernel_counts()[k] - before[k] for k in before}})
    check(routes == {"plain"} and kernel_counts() == before,
          f"treelstm parse: routes {routes}, counters moved")
    del tr
    free_card()

    cfg, tc = train_configs("float32", attn_impl="chunked", attn_dropout=0.0,
                            arch="treelstm", size=48, input_size=64,
                            n_regions=5, obj_feat_size=32)
    card_vs_cpu("treelstm", cfg, dataclasses.replace(tc, k_neg=7), rs)
    emit({"phase": "treelstm_summary", "launches": launches,
          "wall_seconds": time.perf_counter() - t_phase})
    return launches


def remat_grads(cfg, tc, flat, batch):
    """Loss and gradients of one train step's loss on the card at the
    step's dropout (a fixed generator seed)."""
    tr = Trainer(cfg, tc, params_from_numpy(flat, "cuda"))
    tokens, neg, obj, _ = tr._place_batch(batch)
    total, _ = compute_losses(cfg, tc, tr.params, tokens, neg, obj_feats=obj,
                              generator=tr.dropout_generator(0), train=True)
    total.backward()
    grads = {k: p.grad for k, p in zip(flatten(tr.params),
                                       tree_leaves(tr.params))
             if p.grad is not None}
    return total.detach(), grads


def remat_path(rs):
    """Phase ``remat``: the bench configuration (mlp, bf16, dropout 0.1,
    ``attn_impl='cuda'``) at the JAX package's long-sentence envelope
    B=128, L=40, unremated and under each remat variant, graphed (the
    main path: counters zeroed before, read after); each variant's loss
    and gradients against the unremated step; graphed remat against
    eager remat bits; the unremated peaks that calibrate the auto-remat
    copy factor.  Returns the main path's counters."""
    t_phase = time.perf_counter()
    reserved = torch.cuda.memory_reserved()
    batch = {k: torch.as_tensor(v).to("cuda")
             for k, v in train_batch(rs, B, REMAT_N, V, K_NEG, R, F).items()}

    def configs(variant):
        kw = ({} if variant is None else
              dict(remat=True, remat_policy=variant[0],
                   remat_frac=variant[1]))
        cfg, tc = train_configs("bfloat16", **kw)
        return cfg, dataclasses.replace(tc, lr=REMAT_LR)

    zero_counts()
    runs = {}
    for variant in REMAT_VARIANTS:
        name = "off" if variant is None else f"{variant[0]}@{variant[1]}"
        before = kernel_counts()
        try:
            runs[name] = arch_graphed(f"remat {name}", *configs(variant),
                                      batch)
            runs[name]["captured"] = True
        except RuntimeError as err:
            # a policy that cannot be captured must raise at the capture
            check(variant is not None and "capture of the train step "
                  "failed" in str(err) and not isinstance(
                      err.__cause__, torch.cuda.OutOfMemoryError),
                  f"remat {name}: {err!r} from {err.__cause__!r}")
            runs[name] = {"captured": False, "error": repr(err.__cause__)}
            free_card()
        runs[name]["launches"] = {k: kernel_counts()[k] - before[k]
                                  for k in before}
    launches = kernel_counts()
    off = runs["off"]
    check(runs["full@0.0"]["captured"] and runs["full@0.85"]["captured"],
          "remat: the full policy did not capture")
    for name, rec in runs.items():
        if not rec["captured"]:
            emit({"phase": "remat", "variant": name, "dtype": "bfloat16",
                  "batch": B, "n": REMAT_N, **rec})
            continue
        rec["peak_over_unremated"] = (rec["peak_above_trainer_bytes"]
                                      / off["peak_above_trainer_bytes"])
        rec["step_ms_over_unremated"] = (rec["graphed_step_ms"]
                                         / off["graphed_step_ms"])
        emit({"phase": "remat", "variant": name, "dtype": "bfloat16",
              "batch": B, "n": REMAT_N, **rec})
        check(rec["total_loss_first"] == off["total_loss_first"],
              f"remat {name}: first loss {rec['total_loss_first']} != "
              f"unremated {off['total_loss_first']}")
        check(all(rec["launches"][k] == 10 for k in SR_KERNELS)
              and all(rec["launches_per_replayed_step_profiled"][k] == 2
                      for k in SR_KERNELS)
              and rec["launches"]["inside_cky"] == 0,
              f"remat {name}: K2-K4 counters {rec['launches']}, replay "
              f"{rec['launches_per_replayed_step_profiled']}")

    # each remat variant against the unremated step, dropout 0.1, one seed;
    # the image encoder moved off zero (so that the dropped attention
    # matters) at 1e-3: at 1e-2 the L=40 chart's scores push the loss
    # to ~1e22
    base = Trainer.build(*configs(None), V, seed=SEED + 8, device="cpu")
    flat = perturbed(base.params, rs, scale=1e-3)
    del base
    want_loss, want = remat_grads(*configs(None), flat, batch)
    for variant in REMAT_VARIANTS[1:]:
        loss, got = remat_grads(*configs(variant), flat, batch)
        err = {k: float(((got[k] - w).abs() - REMAT_GRAD_RTOL * w.abs())
                        .max()) for k, w in want.items()}
        rec = {"phase": "remat_vs_unremated", "variant": list(variant),
               "attn_dropout": 0.1, "loss": float(loss),
               "loss_equal_bits": bool(torch.equal(loss, want_loss)),
               "grads": len(want),
               "grads_equal_bits": sum(torch.equal(got[k], w)
                                       for k, w in want.items()),
               "max_abs_err_over_rtol_term": max(err.values())}
        emit(rec)
        check(rec["loss_equal_bits"] and set(got) == set(want)
              and math.isfinite(rec["loss"])
              and all(bool(torch.isfinite(w).all()) for w in want.values())
              and rec["max_abs_err_over_rtol_term"] <= REMAT_GRAD_ATOL,
              f"remat {variant}: differs from the unremated step: {rec}")
        del got
        free_card()
    del want
    free_card()

    # graphed remat against eager remat, at the envelope's selective remat
    arch_vs_eager("remat", *configs(("full", 0.85)), flat, [
        {k: torch.as_tensor(v).to("cuda") for k, v in
         train_batch(rs, B, REMAT_N, V, K_NEG, R, F).items()}
        for _ in range(3)])

    # the calibration: unremated eager peaks at three shapes
    cfg, tc = configs(None)
    auto = dataclasses.replace(cfg, remat="auto")
    calib = []
    for b, n in REMAT_CALIBRATION:
        peak = step_peak(cfg, tc, {
            k: torch.as_tensor(v).to("cuda")
            for k, v in train_batch(rs, b, n, V, K_NEG, R, F).items()})
        rows = (n ** 3 - n) // 2
        unit = b * D * rows * 2                  # bf16 chart bytes
        calib.append({"batch": b, "n": n, "peak_bytes": peak,
                      "chart_rows": rows, "copy_factor": peak / unit,
                      "auto_remat_at_10gb": chart_pass.remat_enabled(
                          auto, b, n, D)})
    emit({"phase": "remat_calibration", "dtype": "bfloat16",
          "port_copy_factor": chart_pass._ACT_COPY_FACTOR,
          "budget_gb": auto.remat_budget_gb, "points": calib,
          "max_copy_factor": max(c["copy_factor"] for c in calib)})
    emit({"phase": "remat_summary", "launches": launches,
          "reserved_bytes_at_start": reserved,
          "wall_seconds": time.perf_counter() - t_phase})
    return launches


def word_path(rs):
    """Phase ``word``: the chart-free word baseline at B=128, L=20, 36 x
    2048-d regions, bf16, VG loss: graphed steps (the main path), graphed
    against eager bits, the parse (grounding scores, no trees), run_eval
    over one batch.  None of K1-K4 moves.  Returns the main path's
    counters."""
    t_phase = time.perf_counter()
    cfg, tc = train_configs("bfloat16", arch="word")
    tc = dataclasses.replace(tc, use_contr=False)
    batch = {k: torch.as_tensor(v).to("cuda")
             for k, v in train_batch(rs, B, N, V, K_NEG, R, F).items()}
    zero_counts()
    rec = arch_graphed("word", cfg, tc, batch)
    launches = kernel_counts()
    emit({"phase": "word", "dtype": "bfloat16", "batch": B, "n": N,
          "launches": launches, **rec})
    base = Trainer.build(cfg, tc, V, seed=SEED + 9, device="cpu")
    flat = perturbed(base.params, rs)
    del base
    arch_vs_eager("word", cfg, tc, flat, [
        {k: torch.as_tensor(v).to("cuda") for k, v in
         train_batch(rs, B, N, V, K_NEG, R, F).items()} for _ in range(3)])
    tr = Trainer(cfg, tc, params_from_numpy(flat, "cuda"))
    ev = eval_batch(rs, B, N, V, K_NEG, R, F)
    t0 = time.perf_counter()
    res, metrics = tr.parse(ev, compute_loss=True)
    parse_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    ev_metrics = run_eval(tr, BatchList([ev]), seed=SEED, use_obj=True)
    eval_s = time.perf_counter() - t0
    emit({"phase": "word_parse", "keys": sorted(res),
          "atten_score_shape": list(res["atten_score"].shape),
          "parse_ms": parse_ms, "metrics": metrics,
          "run_eval": ev_metrics, "run_eval_seconds": eval_s})
    check("cky_bp" not in res
          and res["atten_score"].shape == (B, N, R)
          and np.isfinite(res["atten_score"]).all()
          and 0.0 < ev_metrics["grounding_acc"] <= 1.0,
          f"word parse: {sorted(res)} {res['atten_score'].shape} "
          f"{ev_metrics}")
    check(all(v == 0 for v in launches.values())
          and kernel_counts() == launches,
          f"word: a hand kernel launched: {kernel_counts()}")
    del tr
    free_card()
    emit({"phase": "word_summary", "launches": kernel_counts(),
          "wall_seconds": time.perf_counter() - t_phase})
    return launches


def with_flag(flags, name, value=None, drop=()):
    """``flags`` with ``name``'s value set (or the flag added) and the
    flags in ``drop`` (with their values) left out."""
    out, i = [], 0
    while i < len(flags):
        has_value = i + 1 < len(flags) and not flags[i + 1].startswith("--")
        if flags[i] not in drop:
            out += flags[i:i + 1 + has_value]
        i += 1 + has_value
    if name in out:
        out[out.index(name) + 1] = value
    else:
        out += [name] + ([] if value is None else [value])
    return out


def cli_archs_path():
    """Phase ``cli_archs``: the train CLI for one epoch each with
    ``--arch treelstm`` (train_diora.sh's flags), ``--arch word
    --obj_feats --vg_loss`` and ``--remat --remat_frac 0.85`` (on
    train_cliora.sh's flags), on a synthetic grounded corpus of
    CLI_ARCHS_TRAIN + CLI_ARCHS_TEST captions.  Returns each stage's
    counters."""
    t_phase = time.perf_counter()
    launches = {}
    with tempfile.TemporaryDirectory() as work:
        corpus = os.path.join(work, "corpus")
        arrays, route = synthetic_flickr(corpus, CLI_ARCHS_TRAIN,
                                         CLI_ARCHS_TEST)
        data = ["--data_type", "flickr",
                "--train_path", os.path.join(corpus, "flickr_train.json"),
                "--validation_path", os.path.join(corpus, "flickr_test.json"),
                "--data_path", corpus + "/", "--max_epoch", "1"]
        stages = {
            "treelstm": (with_flag(DIORA_FLAGS, "--arch", "treelstm"), None),
            "word": (with_flag(with_flag(CLIORA_FLAGS, "--arch", "word",
                                         drop=("--use_contr",
                                               "--alpha_contr")),
                               "--attn_impl", "cuda"), arrays),
            "remat": (CLIORA_FLAGS + ["--remat", "--remat_frac", "0.85",
                                      "--attn_impl", "cuda"], arrays)}
        for stage, (flags, regions) in stages.items():
            path = os.path.join(work, stage)
            args = flags + data + CLI_RUN_FLAGS + ["--experiment_path", path]
            (tr, records), rec = run_cli("cli_archs_" + stage,
                                         cli_train.main, args, regions)
            rec = cli_train_record(rec, tr, records, path)
            rec.update({"arch": tr.cfg.arch, "remat": tr.cfg.remat,
                        "remat_frac": tr.cfg.remat_frac,
                        "corpus_route": route})
            emit(rec)
            launches[stage] = rec["launches"]
            want = (2 * (rec["warmup_steps"] + rec["graphs"])
                    if stage == "remat" else 0)
            check(any("EPOCH-END" in line for line in rec["epoch_log"])
                  and all(rec["launches"][k] == want for k in SR_KERNELS)
                  and rec["launches"]["inside_cky"] == 0,
                  f"cli_archs {stage}: {rec['epoch_log']} launches "
                  f"{rec['launches']}, expected {want} of each of K2-K4 "
                  f"and no K1")
            del tr
            free_card()
    emit({"phase": "cli_archs_summary", "launches": launches,
          "wall_seconds": time.perf_counter() - t_phase})
    return launches


# -- phase serve: bundles, CUDA graphs per shape, the micro-batched server ----

# the README quick-start DIORA model's bundle (export_model's default
# buckets), warmed to SERVE_MAX_BATCH rows: 3 buckets x 7 row counts
SERVE_BUCKETS = (10, 20, 40)
SERVE_MAX_BATCH = 64
SERVE_SHAPES = len(SERVE_BUCKETS) * 7
# traffic: sentences of lengths uniform in 2..40 with ids uniform over the
# vocab; the HTTP clients, each sending one-sentence requests in turn
SERVE_SENTENCES = 512
SERVE_CLIENTS, SERVE_CLIENT_REQUESTS = 16, 16
SERVE_TIMED_CALLS = 5
# the CLIORA bundle: the train step's model at its sentence length
SERVE_OBJ_BUCKETS = (20,)
SERVE_OBJ_SENTENCES = 128


def write_vocab_corpus(path, vocab):
    """A text corpus whose first-seen vocab is ``w0`` .. ``w{vocab-1}``,
    40 words a line."""
    with open(path, "w") as f:
        for i in range(0, vocab, 40):
            f.write(" ".join(f"w{j}" for j in range(i, min(i + 40, vocab)))
                    + "\n")


def export_cliora_main(flat_npz, bundle, in_args):
    """Child process of :func:`start_exports`: the CLIORA bundle of the
    weights in ``flat_npz``, one bucket at a time; prints each bucket's
    export seconds and MB as one JSON line."""
    cfg, _ = train_configs("float32")
    with np.load(flat_npz) as z:
        params = params_from_numpy({k: z[k] for k in z.files}, "cuda")
    in_args = in_args == "args"
    arts, timings = {}, {}
    for L in SERVE_OBJ_BUCKETS:
        t0 = time.perf_counter()
        arts.update(serving.export_parser(cfg, params, [L],
                                          params_in_args=in_args))
        timings[L] = {"seconds": time.perf_counter() - t0,
                      "mb": len(arts[L]) / 1e6}
    serving.save_bundle(bundle, cfg, arts, params=params if in_args else None)
    print(json.dumps(timings), flush=True)


def text_export_flags(corpus, exp):
    """export_model's flags for the README quick-start model over the
    vocab corpus, random weights from SEED."""
    return ["--data_type", "txt", "--emb", "none",
            "--validation_path", corpus, "--experiment_path", exp,
            "--hidden_dim", str(D), "--seed", str(SEED),
            "--export_lengths", ",".join(map(str, SERVE_BUCKETS))]


def start_exports(work, corpus, flat_npz):
    """The phase's four bundles, each exported by a process of its own,
    all started together (an export traces the parse on one CPU core):
    the text bundle through ``python -m cliora_tpu_torch.scripts.
    export_model`` with and without ``--export_baked_params``, the CLIORA
    bundle through :func:`export_cliora_main` in both weight modes.
    Returns ``{(kind, mode): (process, bundle path, log path)}``."""
    jobs = {}
    for mode in ("args", "baked"):
        exp = os.path.join(work, f"text_{mode}")
        cmd = [sys.executable, "-m", "cliora_tpu_torch.scripts.export_model",
               *text_export_flags(corpus, exp)]
        if mode == "baked":
            cmd.append("--export_baked_params")
        jobs["text", mode] = (cmd, os.path.join(exp, "bundle"),
                              os.path.join(work, f"text_{mode}.log"))
        bundle = os.path.join(work, f"cliora_{mode}")
        jobs["cliora", mode] = (
            [sys.executable, "-c", "import sys, chip_smoke; "
             "chip_smoke.export_cliora_main(*sys.argv[1:])", flat_npz,
             bundle, mode],
            bundle, os.path.join(work, f"cliora_{mode}.log"))
    out = {}
    for key, (cmd, bundle, log) in jobs.items():
        with open(log, "w") as f:
            out[key] = (subprocess.Popen(cmd, cwd=ROOT, stdout=f,
                                         stderr=subprocess.STDOUT),
                        bundle, log)
    return out


def finish_exports(jobs, timeout):
    """Wait for the export processes (killing any left at the end);
    returns each one's per-bucket seconds and MB."""
    deadline = time.perf_counter() + timeout
    try:
        for proc, _, _ in jobs.values():
            proc.wait(timeout=max(1.0, deadline - time.perf_counter()))
    finally:
        for proc, _, _ in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    timings = {}
    for (kind, mode), (proc, _, log) in jobs.items():
        with open(log) as f:
            text = f.read()
        check(proc.returncode == 0,
              f"serve: the {kind} {mode} export exited {proc.returncode}: "
              f"{text[-2000:]}")
        if kind == "text":
            timings[kind, mode] = {
                int(L): {"mb": float(mb), "seconds": float(s)}
                for L, mb, s in re.findall(
                    r"exported bucket L=(\d+): ([\d.]+) MB in ([\d.]+) s",
                    text)}
        else:
            timings[kind, mode] = json.loads(text.strip().splitlines()[-1])
    return timings


def record_calls(parser):
    """Wrap ``parser._call``: each program call's host inputs and outputs
    and its ms, in call order."""
    calls = []
    real = parser._call

    def call(L, host):
        t0 = time.perf_counter()
        out = real(L, host)
        calls.append({"L": L, "host": [a.copy() for a in host], "out": out,
                      "ms": (time.perf_counter() - t0) * 1e3})
        return out
    parser._call = call
    return calls


def served_vs_plain(trainer, calls, what):
    """Each recorded program call against ``Trainer.parse(impl="plain")``
    on the same padded rows with ``lengths``: equal bits."""
    differ = 0
    for c in calls:
        bm = {"sentences": c["host"][0], "lengths": c["host"][1]}
        if len(c["host"]) == 3:
            bm["obj_feats"] = c["host"][2]
        want, _ = trainer.parse(bm, impl="plain")
        check(want["parse_impl"] == "plain", f"{what}: plain route not taken")
        differ += sum(not np.array_equal(want[k], c["out"][k])
                      for k in c["out"])
    return differ


def replay_vs_eager(parser, rs, vocab):
    """Every captured shape: a replay against the exported program called
    eagerly on the same inputs (equal bits), and the ms of each with its
    outputs on the host."""
    out = {}
    for (L, b) in sorted(parser._graphs):
        host = parser._host_inputs(L, b)
        host[1] = rs.randint(1, L + 1, b).astype(np.int64)
        host[0] = rs.randint(0, vocab, (b, L)).astype(np.int64)
        if len(host) == 3:
            host[2] = rs.randn(*host[2].shape).astype(np.float32)
        got = parser._call(L, host)

        def eager():
            with torch.no_grad():
                res = parser._fns[L](*parser._params, *(
                    torch.from_numpy(a).to(parser.device) for a in host))
            return {k: v.cpu().numpy() for k, v in res.items()}

        want = eager()
        rec = {"equal_bits": all(np.array_equal(got[k], want[k])
                                 for k in want)}
        for name, fn in (("graph_ms", lambda: parser._call(L, host)),
                         ("eager_ms", eager)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(SERVE_TIMED_CALLS):
                fn()
            rec[name] = (time.perf_counter() - t0) * 1e3 / SERVE_TIMED_CALLS
        out[f"{L}x{b}"] = rec
    return out


def profiled_replay(parser, L, b, graph_ms):
    """One profiled replay of shape (L, b): device-busy ms, and the idle
    share against the host time of that same call (the profiler stretches
    each of a replay's kernels a little, so the unprofiled ``graph_ms``
    is no denominator for its busy time); host launch calls and device
    kernels."""
    host = parser._host_inputs(L, b)
    calls, wall = {}, []

    def replay():
        t0 = time.perf_counter()
        parser._call(L, host)
        wall.append((time.perf_counter() - t0) * 1e3)

    by_kernel = profile_kernels(replay, calls=calls)
    busy = sum(r["ms"] for r in by_kernel.values())
    return {"shape": [L, b], "graph_ms": graph_ms,
            "profiled_call_ms": wall[0],
            "device_busy_ms": busy if by_kernel else "not measured",
            "idle_share": 1 - busy / wall[0] if by_kernel
            else "not measured",
            "host_launch_calls": calls,
            "device_kernels": (sum(r["count"] for r in by_kernel.values())
                               if by_kernel else "not measured")}


def percentile(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(round(q / 100 * (len(xs) - 1))))]


def http_traffic(port, sents, serialize):
    """SERVE_CLIENTS threads, each sending SERVE_CLIENT_REQUESTS
    one-sentence requests in turn; ``serialize`` holds one lock over each
    request, so one is in flight at a time.  Returns the trees by sentence
    index, the latencies (ms) and the wall seconds."""
    import http.client
    import threading

    lock = threading.Lock() if serialize else contextlib.nullcontext()
    barrier = threading.Barrier(SERVE_CLIENTS)
    got, lat, errors = {}, [], []

    def client(c):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        barrier.wait()
        try:
            for r in range(SERVE_CLIENT_REQUESTS):
                i = c * SERVE_CLIENT_REQUESTS + r
                body = json.dumps({"sentences": [sents[i]]})
                # a request's latency includes its wait for the lock
                t0 = time.perf_counter()
                with lock:
                    conn.request("POST", "/parse", body,
                                 {"Content-Type": "application/json"})
                    resp = conn.getresponse()
                    reply = json.loads(resp.read())
                lat.append((time.perf_counter() - t0) * 1e3)
                if resp.status != 200:
                    errors.append(reply)
                    return
                got[i] = reply["trees"][0]
        finally:
            conn.close()

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(SERVE_CLIENTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    wall = time.perf_counter() - t0
    check(not errors, f"serve http: error replies {errors[:2]}")
    return got, lat, wall


def post(port, body):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("POST", "/parse", json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def as_lists(tree):
    return [as_lists(t) for t in tree] if isinstance(tree, tuple) else tree


def serve_http(bundle, sents, direct):
    """The server of ``make_server`` on 127.0.0.1: micro-batched and
    serialized traffic, texts requests and an over-length request."""
    import threading

    log = io.StringIO()     # the server's console line, kept as a record
    with contextlib.redirect_stdout(log):
        srv = cli_serve.make_server(bundle, "127.0.0.1", 0,
                                    max_batch=SERVE_MAX_BATCH,
                                    max_wait_ms=5.0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        port = srv.server_address[1]
        rec = {"phase": "serve_http", "clients": SERVE_CLIENTS,
               "requests": SERVE_CLIENTS * SERVE_CLIENT_REQUESTS,
               "server_log": log.getvalue().splitlines()}
        for mode, serialize in (("micro_batched", False),
                                ("serialized", True)):
            got, lat, wall = http_traffic(port, sents, serialize)
            rec[mode] = {"request_ms_p50": percentile(lat, 50),
                         "request_ms_p99": percentile(lat, 99),
                         "requests_per_s": len(lat) / wall,
                         "trees_equal_direct": all(
                             got[i] == as_lists(direct[i]) for i in got)}
            check(len(got) == rec["requests"]
                  and rec[mode]["trees_equal_direct"],
                  f"serve http {mode}: trees differ from the direct parse")
        texts = [" ".join(f"w{t}" for t in sents[i]) for i in range(4)]
        status, reply = post(port, {"texts": texts})
        rec["texts_ok"] = status == 200 and reply["trees"] == [
            as_lists(trees.replace_leaves(direct[i], texts[i].split()))
            for i in range(4)]
        status, reply = post(port, {"sentences": [[1] * 41]})
        rec["over_length_status"] = status
        rec["over_length_error"] = reply.get("error")
        rec["graph_replays"] = srv.parser.graph_replays
        rec["eager_calls"] = srv.parser.eager_calls
        emit(rec)
        check(rec["texts_ok"], "serve http: texts request")
        check(status == 400 and "exceeds" in rec["over_length_error"],
              f"serve http: over-length request got {status}")
        check(rec["eager_calls"] == 0,
              f"serve http: {rec['eager_calls']} eager program calls after "
              f"warmup")
    finally:
        srv.shutdown()
        srv.batcher.close()
        srv.server_close()
        del srv
        torch.cuda.empty_cache()
    return rec


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def restart_to_warm(bundle, sentence):
    """``python -m cliora_tpu_torch.scripts.serve`` in a new process: the
    seconds to an answered /healthz (load + captures) and to the first
    answer of a parse."""
    import http.client

    port = free_port()
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "cliora_tpu_torch.scripts.serve",
         "--bundle", bundle, "--port", str(port),
         "--max_batch", str(SERVE_MAX_BATCH)],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        healthz = None
        while time.perf_counter() - t0 < 600 and proc.poll() is None:
            try:
                conn = http.client.HTTPConnection("127.0.0.1", port,
                                                  timeout=5)
                conn.request("GET", "/healthz")
                ok = conn.getresponse().status == 200
                conn.close()
                if ok:
                    healthz = time.perf_counter() - t0
                    break
            except OSError:
                time.sleep(0.05)
        check(healthz is not None, "serve restart: /healthz never answered")
        status, reply = post(port, {"sentences": [sentence]})
        first = time.perf_counter() - t0
        check(status == 200, f"serve restart: first parse got {status}")
    finally:
        proc.terminate()
        try:
            out, _ = proc.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
    return {"phase": "serve_restart", "seconds_to_healthz": healthz,
            "seconds_to_first_answer": first,
            "server_log": [line for line in out.splitlines()
                           if line.startswith(("warmup", "serving"))]}


def load_and_warm(bundle):
    """``ExportedParser`` on the card: load seconds, warmup (captures)
    seconds and shapes, and the peak and held device memory of the
    shared graph pool."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    parser = serving.ExportedParser(bundle)
    load_s = time.perf_counter() - t0
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    shapes = parser.warmup(SERVE_MAX_BATCH)
    torch.cuda.synchronize()
    return parser, {
        "load_seconds": load_s, "warmup_seconds": time.perf_counter() - t0,
        "warmed_shapes": shapes, "graphs": len(parser._graphs),
        "capture_seconds": {f"{L}x{b}": s for (L, b), s in
                            parser.capture_seconds.items()},
        "peak_bytes_load_and_warmup": torch.cuda.max_memory_allocated(),
        "graph_pool_bytes_held": torch.cuda.memory_allocated() - base}


def program_calls(calls):
    return [{"shape": f"{c['L']}x{c['host'][0].shape[0]}", "ms": c["ms"]}
            for c in calls]


def serve_text(bundles, timings, sents, trainer, rs):
    """Each weight mode's text bundle loaded and warmed, the traffic
    through ``parse`` in calls of SERVE_MAX_BATCH rows, every program
    call against the plain route and every shape's replay against its
    eager program.  Returns the trees of the traffic."""
    out = {}
    for mode in ("args", "baked"):
        parser, rec = load_and_warm(bundles[mode])
        calls = record_calls(parser)
        per_call, direct = [], []
        t0 = time.perf_counter()
        for c0 in range(0, SERVE_SENTENCES, SERVE_MAX_BATCH):
            t1 = time.perf_counter()
            direct += parser.parse(sents[c0:c0 + SERVE_MAX_BATCH],
                                   max_rows=SERVE_MAX_BATCH)
            per_call.append((time.perf_counter() - t1) * 1e3)
        wall = time.perf_counter() - t0
        traffic = {"replays": parser.graph_replays,
                   "eager_calls": parser.eager_calls}
        del parser._call
        differ = served_vs_plain(trainer, calls, f"serve {mode}")
        by_shape = replay_vs_eager(parser, rs, V)
        big = f"{SERVE_BUCKETS[-1]}x{SERVE_MAX_BATCH}"
        rec = {"phase": "serve_bundle", "weights": mode, "vocab": V,
               "hidden": D, "buckets": list(SERVE_BUCKETS),
               "export": timings[mode], **rec,
               "sentences": SERVE_SENTENCES,
               "sentences_per_s": SERVE_SENTENCES / wall,
               "parse_call_ms": per_call, "program_calls":
                   program_calls(calls),
               **traffic, "plain_arrays_differ": differ,
               "replay_vs_eager": by_shape,
               "profiled_replay": profiled_replay(
                   parser, SERVE_BUCKETS[-1], SERVE_MAX_BATCH,
                   by_shape[big]["graph_ms"]),
               "card": nvidia_smi_line()}
        emit(rec)
        check(rec["warmed_shapes"] == SERVE_SHAPES
              and rec["graphs"] == SERVE_SHAPES,
              f"serve {mode}: {rec['warmed_shapes']} shapes warmed, "
              f"{rec['graphs']} graphs")
        check(traffic["eager_calls"] == 0 and traffic["replays"] == len(calls),
              f"serve {mode}: {traffic} after warmup")
        check(differ == 0, f"serve {mode}: {differ} program outputs differ "
              f"from the plain route")
        check(all(r["equal_bits"] for r in by_shape.values()),
              f"serve {mode}: a replay differs from its eager program")
        out[mode] = direct
        del parser
        torch.cuda.empty_cache()
    check(out["args"] == out["baked"],
          "serve: the two weight modes' trees differ")
    return out["args"]


def warmup_race(parser, trainer, sents, feats, want_trees):
    """``warmup_async`` on the card: the parser's graphs dropped, captured
    again on a daemon thread while this thread parses 16 sentences; the
    parser's lock keeps captures and calls apart.  The raced calls (a
    replay or an eager call, whichever reached the lock first) must equal
    the plain route, and every shape must be captured after the join."""
    parser._graphs.clear()
    parser._pool = None
    replays, eager = parser.graph_replays, parser.eager_calls
    calls = record_calls(parser)
    thread = parser.warmup_async(SERVE_MAX_BATCH)
    raced, _ = parser.parse(sents[:16], obj_feats=feats[:16])
    thread.join(timeout=300)
    del parser._call
    rec = {"phase": "serve_warmup_async", "thread_done": not thread.is_alive(),
           "graphs_after_join": len(parser._graphs),
           "raced_replays": parser.graph_replays - replays,
           "raced_eager_calls": parser.eager_calls - eager,
           "plain_arrays_differ": served_vs_plain(trainer, calls,
                                                  "serve warmup_async"),
           "trees_equal": raced == want_trees[:16]}
    check(rec["thread_done"]
          and rec["graphs_after_join"] == len(SERVE_OBJ_BUCKETS) * 7
          and rec["plain_arrays_differ"] == 0 and rec["trees_equal"],
          f"serve warmup_async: {rec}")
    return rec


def serve_cliora(bundles, timings, trainer, rs):
    """The CLIORA bundle in both weight modes: SERVE_OBJ_SENTENCES
    sentences with their regions through ``ExportedParser`` directly,
    every program call against the plain route."""
    top = max(SERVE_OBJ_BUCKETS)
    sents = [list(map(int, rs.randint(0, V, rs.randint(2, top + 1))))
             for _ in range(SERVE_OBJ_SENTENCES)]
    feats = rs.randn(SERVE_OBJ_SENTENCES, R, F).astype(np.float32)
    got = {}
    for mode in ("args", "baked"):
        parser, rec = load_and_warm(bundles[mode])
        calls = record_calls(parser)
        t0 = time.perf_counter()
        got_trees, got_attn = parser.parse(sents, obj_feats=feats,
                                           max_rows=SERVE_MAX_BATCH)
        wall = time.perf_counter() - t0
        del parser._call
        differ = served_vs_plain(trainer, calls, f"serve cliora {mode}")
        rec = {"phase": "serve_cliora", "weights": mode,
               "buckets": list(SERVE_OBJ_BUCKETS), "regions": [R, F],
               "export": timings[mode], **rec,
               "sentences": len(sents), "sentences_per_s": len(sents) / wall,
               "program_calls": program_calls(calls),
               "graph_replays": parser.graph_replays,
               "eager_calls": parser.eager_calls,
               "plain_arrays_differ": differ}
        emit(rec)
        check(parser.eager_calls == 0 and differ == 0,
              f"serve cliora {mode}: eager calls {parser.eager_calls}, "
              f"{differ} outputs differ from the plain route")
        got[mode] = (got_trees, [a.tolist() for a in got_attn])
        if mode == "args":
            emit(warmup_race(parser, trainer, sents, feats, got_trees))
        del parser
        torch.cuda.empty_cache()
    check(got["args"] == got["baked"],
          "serve cliora: the two weight modes differ")


def k1_agreement(trainer, sents, direct):
    """Not a check: the served trees (plain route, ``lengths``) against K1
    parses of the exact-length rows, which group fc0's sums another way
    (ROADMAP, known deltas)."""
    by_len = {}
    for i, s in enumerate(sents):
        by_len.setdefault(len(s), []).append(i)
    agree = 0
    routes = set()
    for n, rows in by_len.items():
        if n < 2:
            continue
        res, _ = trainer.parse({"sentences": np.asarray([sents[i]
                                                         for i in rows])})
        routes.add(res["parse_impl"])
        for r, (tree, _) in enumerate(trees.decode_batch(res["cky_bp"], n)):
            agree += tree == direct[rows[r]]
    return {"phase": "serve_vs_k1", "sentences": len(sents),
            "trees_equal": agree, "share": agree / len(sents),
            "routes": sorted(routes)}


def serve_path():
    """Phase ``serve``: export (four processes at once) -> load -> CUDA
    graphs -> parse traffic -> the HTTP server -> a restarted server ->
    the CLIORA bundle.  Launches none of K1-K4 (the serving route is the
    plain chart pass with ``lengths``, as under the JAX gating); returns
    the counters' moves."""
    t_phase = time.perf_counter()
    rs = np.random.RandomState(SEED + 2)
    before = kernel_counts()
    with tempfile.TemporaryDirectory() as work:
        corpus = os.path.join(work, "vocab.txt")
        write_vocab_corpus(corpus, V)
        # the CLIORA bundle's weights: the train step's model with its
        # image encoder moved off its zero init
        cfg, tc = train_configs("float32")
        flat = perturbed(Trainer.build(cfg, tc, V, seed=SEED).params, rs)
        flat_npz = os.path.join(work, "cliora_init.npz")
        np.savez(flat_npz, **flat)
        t0 = time.perf_counter()
        jobs = start_exports(work, corpus, flat_npz)
        timings = finish_exports(jobs, timeout=900)
        export_wall = time.perf_counter() - t0
        bundles = {key: bundle for key, (_, bundle, _) in jobs.items()}

        # the text model again: export_model's seed gives the same weights
        options = cli_flags.parse_args(
            cli_export.add_export_flags(cli_flags.argument_parser()),
            text_export_flags(corpus, os.path.join(work, "text_args")))
        text_trainer = cli_common.build_trainer(
            options, cli_common.get_validation_dataset(options)["embeddings"])
        sents = [list(map(int, rs.randint(0, V, rs.randint(2, 41))))
                 for _ in range(SERVE_SENTENCES)]
        direct = serve_text({m: bundles["text", m] for m in ("args", "baked")},
                            {m: timings["text", m] for m in ("args", "baked")},
                            sents, text_trainer, rs)
        http_rec = serve_http(bundles["text", "args"], sents, direct)
        restart = restart_to_warm(bundles["text", "args"], sents[0])
        emit(restart)
        obj_trainer = Trainer(cfg, tc, params_from_numpy(flat, "cuda"))
        serve_cliora({m: bundles["cliora", m] for m in ("args", "baked")},
                     {m: timings["cliora", m] for m in ("args", "baked")},
                     obj_trainer, rs)
        del obj_trainer
        after = kernel_counts()
        moved = {k: after[k] - before[k] for k in after}
        emit({"phase": "serve_summary", "launches": moved,
              "export_wall_seconds_four_processes": export_wall,
              "wall_seconds": time.perf_counter() - t_phase,
              "micro_batched": http_rec["micro_batched"],
              "serialized": http_rec["serialized"],
              "restart_seconds_to_first_answer":
                  restart["seconds_to_first_answer"],
              "card": nvidia_smi_line()})
        check(all(v == 0 for v in moved.values()),
              f"the serve phase launched a hand kernel: {moved}")
        emit(k1_agreement(text_trainer, sents, direct))
    return moved


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

    # -- build every kernel of the paths from this checkout's sources
    t0 = time.perf_counter()
    built = kernels.build(SOURCES, force=True)
    emit({"phase": "build", "sources": list(SOURCES), "parallel": True,
          "wall_seconds": time.perf_counter() - t0})
    for name in SOURCES:
        rec = built[name]
        summary = ptxas_summary(rec["ptxas"])
        emit({"phase": "build", "kernel": name, "seconds": rec["seconds"],
              **summary, "ptxas": rec["ptxas"]})
        for fn, regs in summary["by_function"].items():
            check(not fn.startswith(NO_SPILL) or regs["spill_bytes"] == 0,
                  f"{fn} spills {regs['spill_bytes']} bytes")
    compiled = ptxas_by_function(built["span_region"]["ptxas"])
    for name in NO_SPILL:
        check(any(fn.split("<")[0] == name for fn in compiled),
              f"ptxas reported no entry function {name}")
    # the host decoder builds at first use too: build it here, not inside
    # the first timed request
    t0 = time.perf_counter()
    decoder_mod = native.load()
    emit({"phase": "build", "decoder": "native" if decoder_mod else "python",
          "seconds": time.perf_counter() - t0})

    rs = np.random.RandomState(SEED)
    entries = [parse_path(rs)]
    torch.cuda.empty_cache()
    # the CLIORA parse draws from its own stream: the train path's inputs
    # stay as they were
    cliora_parse_path(np.random.RandomState(SEED + 1))
    entries += train_path(rs)
    torch.cuda.empty_cache()
    free_card()
    cli = cli_path()
    free_card()
    archs = {"treelstm": treelstm_path(np.random.RandomState(SEED + 3))}
    free_card()
    archs["remat"] = remat_path(np.random.RandomState(SEED + 4))
    free_card()
    archs["word"] = word_path(np.random.RandomState(SEED + 5))
    free_card()
    cli_archs = cli_archs_path()
    free_card()
    cli["serve"] = serve_path()
    for entry in entries:
        entry["cli_launches"] = {stage: counts[entry["name"]]
                                 for stage, counts in cli.items()}
        entry["arch_launches"] = {
            **{phase: counts[entry["name"]]
               for phase, counts in archs.items()},
            **{"cli_archs_" + stage: counts[entry["name"]]
               for stage, counts in cli_archs.items()}}
    emit({"kernels": entries})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
