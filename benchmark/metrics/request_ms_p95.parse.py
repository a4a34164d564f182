"""The 95th percentile of the window's request latencies, in ms: each from
its parse's start to its trees, over every request outside the profiled
stretch.  The decode runs beside the next requests' parses, so a request
also waits behind those queued before it for the decode."""


def read(run):
    if run.kind != "parse":
        return None
    return run.counters.get("request_ms_p95")
