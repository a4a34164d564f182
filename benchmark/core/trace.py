"""The profiler's trace of a stretch of the window, reduced to numbers.

A traced stretch runs under ``torch.profiler`` (CPU and CUDA activity)
inside the annotation ``bench.trace_window``, and ends with a
synchronisation.  It starts with one too, or, where the device must not
be drained (a stream of steps kept in flight), its window opens at the
first kernel the trace holds: the device's stream was busy with work
launched before the trace until then.  The reduction reads the raw
activity records: the device's kernels, copies and sets, each with its
start and length on the trace's clock, and the host's ``bench.*``
annotations.  The device is busy where at least one of its operations
runs: the union of their intervals, so that operations overlapping on
two streams count once.  Nothing is written to disk.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

# the __global__ functions of each hand kernel of the program, as the
# profiler names them (K1: csrc/inside_cky.cu; K2-K4 and the segmented
# second pass: csrc/span_region.cu)
HAND_KERNELS = {
    "inside_cky": re.compile(
        r"::(prep_weights|init_leaves|combine|fc0|project_simt|"
        r"project_wgmma|fc1_simt|fc1_wgmma)[<(]"),
    "span_region_fwd": re.compile(r"::k2_fwd_(bf16<|f32\()"),
    "span_region_dspan": re.compile(r"::k3_dspan<"),
    "span_region_dobj": re.compile(r"::k4_dobj_(gemm\(|f32<|regs\()"),
    "segment_reduce": re.compile(r"::segment_reduce<"),
}
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "bench.trace_window"


def hand_kernel(name: str) -> Optional[str]:
    for k, pattern in HAND_KERNELS.items():
        if pattern.search(name):
            return k
    return None


class Trace:
    """Device operations ``(name, start_s, end_s)`` and host annotations
    ``(name, start_s, end_s)`` of one traced stretch, and its window."""

    def __init__(self, ops, notes, window):
        self.ops: List[Tuple[str, float, float]] = ops
        self.notes: List[Tuple[str, float, float]] = notes
        self.window: Tuple[float, float] = window

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy_intervals(self) -> List[Tuple[float, float]]:
        lo, hi = self.window
        out: List[List[float]] = []
        for _, a, b in sorted(self.ops, key=lambda o: o[1]):
            a, b = max(a, lo), min(b, hi)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def kernel_seconds(self, pattern) -> Tuple[float, int]:
        """Total device seconds and count of the operations whose name
        ``pattern`` (a compiled regex) finds."""
        ts = [b - a for name, a, b in self.ops if pattern.search(name)]
        return sum(ts), len(ts)

    def by_name(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, a, b in self.ops:
            key = hand_kernel(name) or name
            out[key] = out.get(key, 0.0) + (b - a)
        return out

    def gaps(self) -> List[Tuple[str, float]]:
        """Idle stretches of the window, each named by the innermost host
        annotation open at its middle (``host`` where none is)."""
        lo, hi = self.window
        edges = [lo]
        for a, b in self.busy_intervals():
            edges += [a, b]
        edges.append(hi)
        out = []
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            mid = (a + b) / 2
            open_ = [n for n in self.notes if n[1] <= mid <= n[2]]
            name = (min(open_, key=lambda n: n[2] - n[1])[0]
                    if open_ else "host")
            out.append((name, b - a))
        return out

    def breakdown(self, top: int = 10) -> Dict:
        ops = sorted(self.by_name().items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.gaps(), key=lambda g: -g[1])[:top]
        return {"device_ops": [[n[:120], s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in gaps]}


def _ns(evt, what: str) -> float:
    fn = getattr(evt, what + "_ns", None)
    if fn is not None:
        return fn() * 1e-9
    return getattr(evt, what + "_us")() * 1e-6


def reduce(prof, from_first_kernel: bool = False) -> Trace:
    """The :class:`Trace` of a finished ``torch.profiler.profile``; with
    ``from_first_kernel`` its window opens at the first kernel."""
    ops, notes, window = [], [], None
    first_kernel = None
    for evt in prof.profiler.kineto_results.events():
        name = evt.name()
        kind = getattr(evt, "activity_type", lambda: "")()
        start = _ns(evt, "start")
        end = start + (evt.duration_ns() * 1e-9
                       if hasattr(evt, "duration_ns")
                       else evt.duration_us() * 1e-6)
        on_device = str(evt.device_type()).endswith("CUDA")
        if on_device:
            if kind in DEVICE_ACTIVITIES or (not kind and
                                             not name.startswith("bench.")):
                ops.append((name, start, end))
            if kind == "kernel" and (first_kernel is None
                                     or start < first_kernel):
                first_kernel = start
        elif name == WINDOW:
            window = (start, end)
        elif name.startswith("bench."):
            notes.append((name[len("bench."):], start, end))
    if window is None:
        raise RuntimeError("the trace holds no bench.trace_window")
    if from_first_kernel and first_kernel is not None:
        window = (max(window[0], first_kernel), window[1])
    return Trace(ops, notes, window)


class Profiled:
    """``with Profiled(device) as p: ...`` traces the body, from a
    synchronisation (``drain``) or from the first kernel it launches, to
    a synchronisation; ``p.trace`` is its reduction, made on exit."""

    def __init__(self, device, drain: bool = True):
        self.device = device
        self.drain = drain
        self.trace: Optional[Trace] = None

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        if self.drain:
            torch.cuda.synchronize(self.device)
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._window = record_function(WINDOW)
        self._window.__enter__()
        return self

    def __exit__(self, *exc):
        import torch

        torch.cuda.synchronize(self.device)
        self._window.__exit__(*exc)
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self.trace = reduce(self._prof, not self.drain)
        self._prof = None
        return False
