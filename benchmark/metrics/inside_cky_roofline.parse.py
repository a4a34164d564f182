"""K1's share of its roofline in the profiled requests, in %: the sum of
each traced request's K1 bound (``benchmark/core/flops.py:k1_bound``) over
the device seconds of K1's device functions, which these patterns
name."""

import re

from benchmark.core import flops

KERNELS = re.compile(r"::(prep_weights|init_leaves|combine|fc0|project_simt|"
                     r"project_wgmma|fc1_simt|fc1_wgmma)[<(]")


def read(run):
    if run.kind != "parse" or run.trace is None:
        return None
    seconds, count = run.trace.kernel_seconds(KERNELS)
    if not count or seconds <= 0:
        return None
    bound = sum(flops.k1_bound(B, n, run.cfg["size"],
                               run.cfg["compute_dtype"])["bound_s"]
                for B, n in run.traced_work)
    return 100.0 * bound / seconds
