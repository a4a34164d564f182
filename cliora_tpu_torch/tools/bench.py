"""Headline benchmark of the port: CLIORA training throughput,
sentences/s on one card (the port's counterpart of bench.py).

Usage::

    python -m cliora_tpu_torch.tools.bench

Workload (bench.py:42-43,89-106): the full CLIORA train step
(inside-outside chart forward, reconstruction + VG + contrastive losses,
backward, global-norm clip, Adam) at B=128, L=20, D=400, E=1,024,
V=10,000 with a trainable table, k_neg=100, 36 regions x 2,048-d
features, ``compute_dtype="bfloat16"``, lr 5e-4, the config's dropout,
and the fused span x region route ``attn_impl="cuda"`` (kernels K2-K4).
Tokens, negatives and regions are drawn from ``np.random.RandomState(0)``
as bench.py draws them and live on the card, as a prefetcher keeps them.
``K_CALL`` steps go through one ``Trainer.steps`` call (one captured
CUDA graph, replayed); ``max(1, WARMUP // K_CALL)`` calls warm up (the
first holds the two eager warm-up steps and the capture), then
``STEPS // K_CALL`` calls are timed to one sync.

Prints ONE JSON line with bench.py's fields ("card" where bench.py says
"chip") and beside them: ``step_ms``; ``eager_pipelined_step_ms`` (10
eager ``Trainer.step`` calls to one sync); ``capture_s`` (the first
call) and ``build_s`` (building or loading K2-K4's library before it);
``idle_share`` of a replayed step (1 - the profiler's device-busy
ms, the union of its operations' intervals, over ``step_ms``); ``max_memory_allocated_bytes``; ``step_flops`` and
``mfu_vs_h100_bf16_peak``; ``device`` and ``power_limit``.

``vs_baseline`` divides by bench.py's 2.11 sentences/s: the reference
PyTorch implementation on a host CPU (tools/measure_reference_baseline.py),
not a TPU number.

``step_flops`` is ``torch.utils.flop_counter.FlopCounterMode``'s total
over one eager step of a trainer built from the same seed on the
``chunked`` route, whose span x region products are aten products: so
the count is the step's work, whatever implements it (the ``cuda``
route's kernels launch through ctypes, which the counter cannot see).
It counts the matmul-like aten ops (``mm``, ``bmm``, ``addmm``, ...),
forward and backward; it does not count elementwise ops, reductions or
Adam, which XLA's count in bench.py includes.  So this MFU and bench.py's
``mfu_vs_v5e_bf16_peak`` are not comparable.  The MFU is given on an H100
only; elsewhere it is null and ``mfu_note`` says why.

Without a CUDA device the line has ``value`` 0.0 and an ``error``, and
the tool exits 0 (as bench.py does when its TPU is unreachable).
"""

from __future__ import annotations

import math
import time

import torch
from torch.utils.flop_counter import FlopCounterMode

from cliora_tpu_torch import kernels
from cliora_tpu_torch.tools import common, profile_step
from cliora_tpu_torch.tools.common import D, E, F, R, V
from cliora_tpu_torch.tools.common import KNEG as K

METRIC = "cliora_train_sentences_per_sec_per_card"
UNIT = "sentences/sec/card"
# the reference PyTorch implementation, same model and losses (B=32), on a
# host CPU (bench.py:36-40): not a card or TPU number
BASELINE_SENTS_PER_SEC = 2.11

B, L = 128, 20
WARMUP, STEPS = 5, 30
K_CALL = 10
DTYPE = "bfloat16"
EAGER_STEPS = 10

# NVIDIA H100 SXM, bf16 on the tensor cores, dense (the data sheet; the
# peak chip_smoke.py's kernel bounds use)
H100_BF16_PEAK = 989e12


def step_flops(B=B, L=L, dtype=DTYPE, attn_impl="chunked", device=None,
               use_contr=True, **widths) -> int:
    """FlopCounterMode's total over one eager train step of a fresh bench
    trainer (seed 0) on ``attn_impl``: the matmul-like aten ops, forward
    and backward."""
    trainer, batch = profile_step.build(B, L, dtype, device, attn_impl,
                                        use_contr=use_contr, **widths)
    with FlopCounterMode(display=False) as counter:
        trainer.step(batch)
        common.sync(trainer.device)
    return counter.get_total_flops()


def run(B=B, L=L, D=D, E=E, V=V, K=K, R=R, F=F, dtype=DTYPE,
        warmup=WARMUP, steps=STEPS, k_call=K_CALL, device=None):
    """The bench on ``device`` (the current card by default): the JSON
    record ``main`` prints, without its error field."""
    widths = {"D": D, "E": E, "V": V, "K": K, "R": R, "F": F}
    trainer, batch = profile_step.build(B, L, dtype, device, "cuda",
                                        **widths)
    dev = trainer.device
    batches = [batch] * k_call

    # K2-K4's library builds at its first use: apart from the capture
    t0 = time.perf_counter()
    if dev.type == "cuda":
        kernels.load("span_region")
    build_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    for _ in range(max(1, warmup // k_call)):
        metrics = trainer.steps(batches)
    common.sync(dev)
    capture_s = time.perf_counter() - t0

    n_calls = steps // k_call
    t0 = time.perf_counter()
    for _ in range(n_calls):
        metrics = trainer.steps(batches)
    common.sync(dev)
    dt = time.perf_counter() - t0
    n_steps = n_calls * k_call
    step_ms = 1e3 * dt / n_steps
    sps = B * n_steps / dt
    loss = float(metrics[-1]["total_loss"])

    idle = "not measured"
    if dev.type == "cuda":
        table, busy = common.profile_kernels(lambda: trainer.steps([batch]),
                                             reps=k_call)
        if table:
            idle = common.idle_share(busy, step_ms)

    t0 = time.perf_counter()
    for _ in range(EAGER_STEPS):
        trainer.step(batch)
    common.sync(dev)
    eager_ms = 1e3 * (time.perf_counter() - t0) / EAGER_STEPS
    peak = common.peak_bytes(dev)
    del trainer, batch, batches, metrics

    flops = step_flops(B, L, dtype, "chunked", dev, **widths)
    where = common.device_record(dev)
    result = {
        "metric": METRIC,
        "value": sps,
        "unit": UNIT,
        "vs_baseline": sps / BASELINE_SENTS_PER_SEC,
        "step_ms": step_ms,
        "eager_pipelined_step_ms": eager_ms,
        "capture_s": capture_s,
        "build_s": build_s,
        "idle_share": idle,
        "max_memory_allocated_bytes": peak,
        "step_flops": flops,
        "mfu_vs_h100_bf16_peak": None,
        "total_loss_last": loss,
        "loss_finite": math.isfinite(loss),
        "workload": {"B": B, "L": L, **widths, "dtype": dtype,
                     "attn_impl": "cuda", "k_call": k_call,
                     "timed_steps": n_steps},
        **where,
    }
    if "H100" in where["device"]:
        result["mfu_vs_h100_bf16_peak"] = (
            flops / (step_ms / 1e3) / H100_BF16_PEAK)
    else:
        result["mfu_note"] = (f"the peak is an H100's; this ran on "
                              f"{where['device']}")
    return result


def main():
    if not torch.cuda.is_available():
        # no made-up number: the line says what is missing
        common.emit({"metric": METRIC, "value": 0.0, "unit": UNIT,
                     "vs_baseline": 0.0,
                     "error": "no CUDA device: this benchmark runs on the "
                              "card; benchmark not run"})
        return
    common.emit(run())


if __name__ == "__main__":
    main()
