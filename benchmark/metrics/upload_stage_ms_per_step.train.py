"""Host milliseconds the device prefetch spends staging one batch
(``data/prefetch.py:_Uploader.put``: the pinned allocations, the numpy
copies and the enqueue of the uploads): the median of the program's
``prefetch.stage`` spans outside the profiled stretch, read from its
tracing registry (``cliora_tpu_torch/utils/observability.py``) after the
window; ``None`` where the program records none.

This reader is the one that reaches the registry for the others.
``read(run, parts, kind)`` is the median, over the records outside the
profiled stretch, of the k-th records of ``parts`` summed
(``parse_host_ms_per_request.parse``), and ``read(run, parts, kind,
records=True)`` hands back each part's records, oldest first
(``dispatch_host_ms_per_step.train``,
``program_idle_ms_per_request.parse``)."""

import statistics


def _records(run, kind, parts):
    if run.kind != kind:
        return None
    try:
        from cliora_tpu_torch.utils import observability
    except ImportError:
        return None
    snapshot = getattr(observability, "snapshot", None)
    if snapshot is None:
        return None
    spans = snapshot()["spans"]
    return [sorted(spans.get(n, {}).get("records", [])) for n in parts]


def read(run, parts=("prefetch.stage",), kind="train", records=False):
    recs = _records(run, kind, parts)
    if records or recs is None:
        return recs
    if not recs[0] or len({len(r) for r in recs}) != 1:
        return None
    lo, hi = run.trace.window if run.trace is not None else (0.0, -1.0)
    ms = [1e-6 * sum(b - a for a, b in one) for one in zip(*recs)
          if not lo <= one[0][0] * 1e-9 <= hi]
    return statistics.median(ms) if ms else None
