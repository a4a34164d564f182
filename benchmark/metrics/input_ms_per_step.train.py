"""Host milliseconds a step spends getting its batch: the ``input`` span
around each ``next()`` of ``data/prefetch.py:device_prefetch``'s iterator
(the producer's queue, the pinned staging, the upload's enqueue), over
the window's steps outside the profiled stretch."""


def read(run):
    n = run.spans.count("input")
    if run.kind != "train" or not n:
        return None
    return 1e3 * run.spans.total("input") / n
