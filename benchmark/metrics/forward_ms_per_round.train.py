"""Device milliseconds of the train step's forward in one round of the
profiled steps: from each ``cliora_mark_forward`` kernel to the next
phase marker, the union of the device's operations in between (the
upload's host-to-device copies, which run on their own stream, left
out), summed over a step's microbatches, averaged over the traced steps
of each bucket and summed over the buckets, so that a stretch of five or
six steps still reads one round.  The k-th traced step is
``run.traced_work[k]``; the markers are the program's
(``cliora_tpu_torch/utils/observability.py:mark``), four a step, and
the reading is ``None`` where the trace's markers are not those of the
traced steps, in order.

``read(run, phase)`` also serves the backward (``cliora_mark_backward``
to the next marker), the update (``cliora_mark_update`` to
``cliora_mark_end``) and ``longest_step`` (a step's first
``cliora_mark_forward`` to its ``cliora_mark_end``, the mean over the
traced steps of the longest bucket)."""

import bisect
import re

from benchmark.core.trace import Trace

MARK = re.compile(r"cliora_mark_(forward|backward|update|end)\b")
UPLOAD = re.compile(r"^Memcpy HtoD")


def _busy(merged, starts, lo, hi):
    """Seconds of the merged intervals inside [lo, hi)."""
    i = max(bisect.bisect_right(starts, lo) - 1, 0)
    total = 0.0
    while i < len(merged) and merged[i][0] < hi:
        total += max(0.0, min(merged[i][1], hi) - max(merged[i][0], lo))
        i += 1
    return total


def steps(run):
    """Each traced step's device seconds by phase (``forward``,
    ``backward``, ``update``, ``step``), or ``None``."""
    if run.kind != "train" or run.trace is None or not run.traced_work:
        return None
    marks, work = [], []
    for name, a, b in run.trace.ops:
        m = MARK.search(name)
        if m:
            marks.append((a, m.group(1)))
        elif not UPLOAD.search(name):
            work.append((name, a, b))
    marks.sort()
    accum = int(run.cfg.get("accum_steps", 1))
    one = ["forward", "backward"] * accum + ["update", "end"]
    if [p for _, p in marks] != one * len(run.traced_work):
        return None
    merged = Trace(work, [], run.trace.window).busy_intervals()
    starts = [a for a, _ in merged]
    out = []
    for k in range(len(run.traced_work)):
        mk = marks[k * len(one):(k + 1) * len(one)]
        rec = {"forward": 0.0, "backward": 0.0, "update": 0.0}
        for (a, phase), (b, _) in zip(mk, mk[1:]):
            rec[phase] += _busy(merged, starts, a, b)
        rec["step"] = _busy(merged, starts, mk[0][0], mk[-1][0])
        out.append(rec)
    return out


def read(run, phase="forward"):
    per_step = steps(run)
    if per_step is None:
        return None
    buckets = {}
    for shape, rec in zip(run.traced_work, per_step):
        buckets.setdefault(tuple(shape), []).append(rec)
    if phase == "longest_step":
        longest = max(buckets, key=lambda s: s[-1])
        recs = buckets[longest]
        return 1e3 * sum(r["step"] for r in recs) / len(recs)
    return 1e3 * sum(sum(r[phase] for r in recs) / len(recs)
                     for recs in buckets.values())
