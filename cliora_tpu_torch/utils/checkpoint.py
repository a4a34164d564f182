"""Tiny experiment-state json (reference: cliora/utils/checkpoint.py).

The reference records only ``{step}`` (and restores nothing --
cliora/utils/checkpoint.py:4-8); we add the epoch, the host-side
dropout/step counter, and the run seed so ``--resume`` reproduces the
uninterrupted run's batch order and rng stream exactly
(scripts/train.py run_train).
"""

import json


def save_experiment(path: str, step: int, **extra):
    with open(path, "w") as f:
        json.dump({"step": step, **extra}, f)


def load_experiment(path: str) -> dict:
    with open(path) as f:
        return json.load(f)
