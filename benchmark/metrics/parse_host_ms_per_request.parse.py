"""Host milliseconds of a request's own work in ``Trainer.parse`` before
it waits for the device: the median, over the requests outside the
profiled stretch, of the program's ``parse.route`` + ``parse.upload`` +
``parse.forward`` spans (its ``parse.copy_back``, which waits for the
card, left out), read from its tracing registry
(``cliora_tpu_torch/utils/observability.py``) after the window, as
``upload_stage_ms_per_step.train`` reads it; ``None`` where the program
records none."""

from benchmark.core.cell import reader

PARTS = ("parse.route", "parse.upload", "parse.forward")


def read(run):
    return reader("upload_stage_ms_per_step.train")(run, parts=PARTS,
                                                     kind="parse")
