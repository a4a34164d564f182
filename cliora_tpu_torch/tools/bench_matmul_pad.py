"""Do the chart level's GEMMs lose time to alignment at D=400?  (The
port's counterpart of tools/bench_matmul_pad.py.)

Times the products one chart level of the plain chart pass runs through
``torch.matmul`` -- the compose's fc0 ``(M, 2D) @ (2D, D)`` and fc1
``(M, D) @ (D, D)`` with their ReLUs, and the bilinear score's
``(M, D) @ (D, D)`` -- at the B=128, L=20 inside pass's 170,240 gathered
child rows, at D = 400, at D = 512, and at D = 400 zero-padded to 512
(weights too).  It reports ms with CUDA events and TFLOP/s raw (the work
at that D) and effective (D=400's work over the time).  bf16 runs on the
tensor cores, where tiles align at multiples of 64; f32 runs without TF32
(torch's default, and the port's: the CUDA-core GEMMs of the f32 step).
It measures the library's GEMMs: no hand kernel is involved.

Usage::

    python -m cliora_tpu_torch.tools.bench_matmul_pad [--rows 170240]
        [--steps 50] [--dtype bfloat16|float32] [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import torch

from cliora_tpu_torch.tools import common


def level_matmuls(x2, x1, w0, w1, mat):
    """fc0 + ReLU, fc1 + ReLU, and the bilinear projection."""
    h0 = torch.relu(x2 @ w0)
    h1 = torch.relu(h0 @ w1)
    return h1, x1 @ mat


def operands(M, D, dtype, dev, gen, pad_to=None):
    """x2 (M, 2D), x1 (M, D), w0 (2D, D), w1, mat (D, D) from ``gen``;
    with ``pad_to`` each is zero-padded so that D becomes ``pad_to``
    (x2's and w0's two halves each)."""
    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    x2, x1 = randn(M, 2 * D), randn(M, D)
    w0, w1, mat = randn(2 * D, D), randn(D, D), randn(D, D)
    if pad_to is None:
        return x2, x1, w0, w1, mat
    P = pad_to

    def pad(t, rows, cols):
        out = torch.zeros(rows, cols, dtype=dtype, device=dev)
        out[:t.shape[0], :t.shape[1]] = t
        return out

    x2p = torch.zeros(M, 2 * P, dtype=dtype, device=dev)
    x2p[:, :D], x2p[:, P:P + D] = x2[:, :D], x2[:, D:]
    w0p = torch.zeros(2 * P, P, dtype=dtype, device=dev)
    w0p[:D, :D], w0p[P:P + D, :D] = w0[:D], w0[D:]
    return x2p, pad(x1, M, P), w0p, pad(w1, P, P), pad(mat, P, P)


def time_ms(fn, args, steps, dev):
    """ms a call over ``steps`` warm calls: CUDA events on the card, the
    host clock after a sync elsewhere."""
    fn(*args)
    common.sync(dev)
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(steps):
            fn(*args)
        end.record()
        torch.cuda.synchronize(dev)
        return start.elapsed_time(end) / steps
    t0 = time.perf_counter()
    for _ in range(steps):
        fn(*args)
    return (time.perf_counter() - t0) / steps * 1e3


def flops(M, D):
    return 2 * M * (2 * D * D + D * D + D * D)


def main(argv=None):
    ap = argparse.ArgumentParser()
    # gathered child rows of one inside pass at B=128, n=20:
    # B * sum_l l*(n-l) = 128 * 1330 = 170240
    ap.add_argument("--rows", default=170240, type=int)
    ap.add_argument("--steps", default=50, type=int)
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float32"))
    common.add_device_flag(ap)
    args = ap.parse_args(argv)
    dev = common.device_for(args.device)
    # the f32 products on the CUDA cores, as the port runs them
    torch.backends.cuda.matmul.allow_tf32 = False
    M = args.rows
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    gen = torch.Generator(device=dev).manual_seed(0)
    print(f"device={dev} rows={M} dtype={args.dtype} tf32=False", flush=True)
    real = flops(M, 400)
    out = {}
    for tag, D, pad_to in (("d400", 400, None), ("d512", 512, None),
                           ("d400_padded_512", 400, 512)):
        ms = time_ms(level_matmuls, operands(M, D, dtype, dev, gen, pad_to),
                     args.steps, dev)
        raw = flops(M, pad_to or D) / ms / 1e9
        out[tag] = {"ms": ms, "raw_tflop_s": raw,
                    "effective_tflop_s": real / ms / 1e9}
        print(f"{tag:>16}: {ms:7.3f} ms   raw {raw:6.1f} TFLOP/s   "
              f"effective(D400-work) {real / ms / 1e9:6.1f} TFLOP/s",
              flush=True)
    common.emit({"metric": "bench_matmul_pad", "rows": M,
                 "dtype": args.dtype, "tf32": False, "steps": args.steps,
                 **out, **common.device_record(dev)})


if __name__ == "__main__":
    main()
