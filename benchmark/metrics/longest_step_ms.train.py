"""Device milliseconds of one step of the longest bucket: from a traced
step's first ``cliora_mark_forward`` kernel to its ``cliora_mark_end``,
the union of the device's operations in between, the mean over the
profiled steps of the bucket of the longest sentences (as
``forward_ms_per_round.train`` reads the phases)."""

from benchmark.core.cell import reader


def read(run):
    return reader("forward_ms_per_round.train")(run, phase="longest_step")
