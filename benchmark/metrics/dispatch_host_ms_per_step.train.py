"""Host milliseconds a replayed step spends in ``Trainer.steps``'s own
dispatch work: the median, over the replayed steps outside the profiled
stretch, of the group's ``train.place`` over the steps of its group,
plus the step's ``train.copy_in``, ``train.reseed`` and
``train.collect``.  The replay's launch (``train.launch``) is left out:
it holds the wait for room in the device's launch queue.  The spans are
the program's tracing registry's
(``cliora_tpu_torch/utils/observability.py``), read after the window as
``upload_stage_ms_per_step.train`` reads them; ``None`` where the
program records none."""

import bisect
import statistics

from benchmark.core.cell import reader

PARTS = ("train.place", "train.launch", "train.eager", "train.copy_in",
         "train.reseed", "train.collect")


def read(run):
    recs = reader("upload_stage_ms_per_step.train")(run, parts=PARTS,
                                                     records=True)
    if recs is None:
        return None
    place, launch, eager, copy_in, reseed, collect = recs
    steps = sorted(a for a, _ in launch + eager)
    if not copy_in or not place or not (
            len(copy_in) == len(reseed) == len(collect)):
        return None
    lo, hi = run.trace.window if run.trace is not None else (0.0, -1.0)
    starts = [a for a, _ in place]
    out = []
    for c, r, o in zip(copy_in, reseed, collect):
        if lo <= c[0] * 1e-9 <= hi:
            continue
        j = bisect.bisect_right(starts, c[0]) - 1
        if j < 0:
            continue
        end = starts[j + 1] if j + 1 < len(starts) else float("inf")
        group = (bisect.bisect_left(steps, end)
                 - bisect.bisect_left(steps, starts[j]))
        out.append((place[j][1] - place[j][0]) / max(group, 1)
                   + (c[1] - c[0]) + (r[1] - r[0]) + (o[1] - o[0]))
    return 1e-6 * statistics.median(out) if out else None
