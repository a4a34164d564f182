"""K2-K4's share of their roofline in the profiled steps, in %: the sum
of each traced step's K2, K3 and K4 bounds (``benchmark/core/flops.py:
sr_bound``, the VG call on f32 word vectors and the contrastive call on
chart-dtype span vectors) over the device seconds of the kernels these
patterns name, their segmented second pass included."""

import re

from benchmark.core import flops

KERNELS = re.compile(r"::(k2_fwd_(bf16<|f32\()|k3_dspan<|"
                     r"k4_dobj_(gemm\(|f32<|regs\()|segment_reduce<)")


def read(run):
    if run.kind != "train" or run.trace is None or not run.cfg["use_obj"]:
        return None
    seconds, count = run.trace.kernel_seconds(KERNELS)
    if not count or seconds <= 0:
        return None
    bound = sum(flops.train_step_sr_bound_s(run.cfg, B, n)
                for B, n in run.traced_work)
    return 100.0 * bound / seconds
