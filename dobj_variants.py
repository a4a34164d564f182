#!/usr/bin/env python3
"""Where kernel K4 (``k4_dobj`` of cliora_tpu_torch/csrc/span_region.cu)
spends its time, on one GPU.

    python3 dobj_variants.py

Builds the source as it is and four variants of it, each with one part
of ``k4_dobj`` taken out or changed, and times each at the bf16
contrastive call of the CLIORA train step (span (128, 210, 400) bf16,
argmax and g (128, 128, 210), 36 regions):

  base      the kernel as committed
  no_rmw    the shared-memory read-modify-write replaced by a register
            sum (wrong results; the time without the dependent chain)
  no_load   the span rows not loaded (wrong results; the time without
            the loads)
  rows8     8 rows' loads in flight instead of 16
  g2        2 images per block instead of 4 (twice the blocks per SM)

Prints one JSON line per variant (ms over 5 runs of 10 calls, CUDA
events; blocks per SM from the occupancy API; the largest difference
from the committed kernel's result) and the card's name and power
limit.  Builds go to cliora_tpu_torch/_build/variants/.  Needs nvcc and
a CUDA card.
"""

import ctypes
import json
import os
import subprocess
import sys

import torch

from cliora_tpu_torch import kernels
from cliora_tpu_torch.ops import span_region

A, M, C, R, D = 128, 210, 128, 36, 400
OUT = os.path.join(kernels.BUILD_DIR, "variants")

OCCUPANCY = '''
extern "C" int k4_occupancy(int R) {
  int n = 0;
  const size_t smem = (size_t)K4_G * R * K4_DS * sizeof(float);
  cudaFuncSetAttribute(k4_dobj<__nv_bfloat16>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, k4_dobj<__nv_bfloat16>,
                                                32 * K4_G, smem);
  return n;
}
'''

# (text in the source, its replacement) per variant
EDITS = {
    "base": [],
    "no_rmw": [
        ("  for (long long base = r0; base < r1; base += 32) {",
         "  float4 tmp = make_float4(0.f, 0.f, 0.f, 0.f);\n"
         "  for (long long base = r0; base < r1; base += 32) {"),
        ("if (base + h + u < r1) acc[r * 32] = fma4(gv, sv[u], acc[r * 32]);",
         "if (base + h + u < r1) tmp = fma4(gv + r, sv[u], tmp);"),
        ("  if (!dok) return;\n  float* o = out",
         "  acc[0] = tmp;\n  if (!dok) return;\n  float* o = out"),
    ],
    "no_load": [
        ("sv[u] = (dok && row < r1) ? load4(span + row * D + d)\n"
         "                                  : make_float4(0.f, 0.f, 0.f, 0.f);",
         "sv[u] = make_float4((float)row, 1.f, 2.f, 3.f);"),
    ],
    "rows8": [("constexpr int K4_ROWS = 16;", "constexpr int K4_ROWS = 8;")],
    "g2": [("constexpr int K4_G = 4;", "constexpr int K4_G = 2;")],
}
GROUP = {"g2": 2}


def source(name):
    with open(os.path.join(kernels.CSRC, "span_region.cu")) as f:
        src = f.read()
    src = src.replace('}  // namespace\n\nextern "C" {',
                      '}  // namespace\n' + OCCUPANCY + '\nextern "C" {')
    for old, new in EDITS[name]:
        if old not in src:
            raise RuntimeError(f"{name}: the source no longer has {old!r}")
        src = src.replace(old, new)
    return src


def build():
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    try:
        for name in EDITS:
            src = os.path.join(OUT, f"{name}.cu")
            with open(src, "w") as f:
                f.write(source(name))
            procs[name] = subprocess.Popen(
                [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o",
                 os.path.join(OUT, f"lib{name}.so"), src],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        libs = {}
        for name, proc in procs.items():
            _, err = proc.communicate(timeout=600)
            if proc.returncode != 0:
                raise RuntimeError(f"{name}: nvcc failed\n{err}")
            lib = ctypes.CDLL(os.path.join(OUT, f"lib{name}.so"))
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            lib.span_region_dobj.argtypes = [ptr] * 5 + [i32] * 7 + [ptr]
            lib.span_region_dobj.restype = i32
            lib.k4_occupancy.argtypes = [i32]
            lib.k4_occupancy.restype = i32
            libs[name] = lib
        return libs
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def segments(group):
    base = -(-C // group) * -(-D // span_region._DOBJ_DSLICE)
    want = -(-span_region._DOBJ_TARGET_BLOCKS // base)
    return max(1, min(want, A * M // span_region._DOBJ_MIN_ROWS))


def main():
    if not torch.cuda.is_available():
        print("dobj_variants: no CUDA device", file=sys.stderr)
        return 1
    libs = build()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    span = torch.randn(A, M, D, generator=gen, device=dev).to(torch.bfloat16)
    am = torch.randint(0, R, (A, C, M), generator=gen, device=dev,
                       dtype=torch.int32)
    g = torch.randn(A, C, M, generator=gen, device=dev)
    results = {}
    for name, lib in libs.items():
        segs = segments(GROUP.get(name, span_region._DOBJ_GROUP))
        dobj = torch.empty(C, R, D, device=dev)
        part = torch.empty(segs, C, R, D, device=dev)
        stream = torch.cuda.current_stream().cuda_stream

        def call():
            err = lib.span_region_dobj(
                span.data_ptr(), am.data_ptr(), g.data_ptr(),
                part.data_ptr(), dobj.data_ptr(), A, M, C, R, D, segs, 1,
                stream)
            if err:
                raise RuntimeError(f"{name}: launch failed ({err})")

        for _ in range(3):
            call()
        torch.cuda.synchronize()
        runs = []
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(10):
                call()
            end.record()
            torch.cuda.synchronize()
            runs.append(start.elapsed_time(end) / 10)
        results[name] = dobj.clone()
        print(json.dumps({
            "variant": name, "segments": segs,
            "blocks_per_sm": lib.k4_occupancy(R),
            "ms": sorted(runs)[len(runs) // 2], "runs_ms": runs,
            "max_abs_diff_vs_base":
                (dobj - results["base"]).abs().max().item()}),
            flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
