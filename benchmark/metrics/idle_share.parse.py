"""The device's idle share of the profiled stretch of requests, in %: 1 -
the union of its kernel, copy and set intervals over the stretch's
length."""


def read(run):
    if run.kind != "parse" or run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
