"""Device milliseconds of the train step's backward in one round of the
profiled steps: from each ``cliora_mark_backward`` kernel to the next
phase marker, read as ``forward_ms_per_round.train`` reads the
forward."""

from benchmark.core.cell import reader


def read(run):
    return reader("forward_ms_per_round.train")(run, phase="backward")
