"""Device milliseconds of the train step's update in one round of the
profiled steps: from ``cliora_mark_update`` (before the gradient
collectives, the clip and Adam) to ``cliora_mark_end``, read as
``forward_ms_per_round.train`` reads the forward."""

from benchmark.core.cell import reader


def read(run):
    return reader("forward_ms_per_round.train")(run, phase="update")
