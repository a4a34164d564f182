"""Idle device milliseconds a profiled request spends inside the
program's own host work: the profiled stretch's idle time (its window
less the union of its device operations) that lies inside the program's
``parse.*`` spans (``Trainer.parse``'s route, upload, forward and copy
back, from its tracing registry, ``cliora_tpu_torch/utils/
observability.py``, on the profiler's clock, as
``upload_stage_ms_per_step.train`` reads it), over the profiled
requests; ``None`` where the program records none in the stretch.  The
client parses in one thread, so a request's spans never overlap."""

from benchmark.core.cell import reader

PARTS = ("parse.route", "parse.upload", "parse.forward", "parse.copy_back")


def read(run):
    if run.kind != "parse" or run.trace is None or not run.traced_work:
        return None
    recs = reader("upload_stage_ms_per_step.train")(run, parts=PARTS,
                                                     kind="parse",
                                                     records=True)
    if recs is None:
        return None
    lo, hi = run.trace.window
    spans = sorted((max(a * 1e-9, lo), min(b * 1e-9, hi))
                   for part in recs for a, b in part
                   if a * 1e-9 < hi and b * 1e-9 > lo)
    if not spans:
        return None
    edges = [lo] + [x for iv in run.trace.busy_intervals() for x in iv] \
        + [hi]
    idle = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    inside, j = 0.0, 0
    for a, b in idle:
        while j < len(spans) and spans[j][1] <= a:
            j += 1
        k = j
        while k < len(spans) and spans[k][0] < b:
            inside += max(0.0, min(b, spans[k][1]) - max(a, spans[k][0]))
            k += 1
    return 1e3 * inside / len(run.traced_work)
