"""The readings the limits of ``correct`` are set from.  The benchmark's
own runs never run this.

    python3 -m benchmark.calibrate --workload <cell> --seeds 1,2,3
        --mode program|control|fault:<name>

* ``program``: the program's compared numbers, as a run computes them,
  without the window: for a ``train`` cell the set-up's steps, for a
  ``parse`` cell the judged requests served one after another by the one
  client.
* ``control``: the reference itself in the program's place, computed in
  the nearest precision below the configuration's (``fp8`` for
  bfloat16, ``tf32`` for float32), held to the reference in its own; a
  ``train`` cell's steps are those of the program's set-up.
* ``fault:<name>``: the program with a fault of ``benchmark/core/
  faults.py`` planted.

One JSON line a seed: each compared number, and beside it the
configuration's limit.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import sys

LOWER = {"bfloat16": "fp8", "float32": "tf32"}


def _free(device):
    import torch

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def train_readings(cfg, spec, seed, device, mode):
    from benchmark.core import faults, train
    from benchmark.core.cell import Outcome

    outcome = Outcome()
    fault = (faults.FAULTS["train"][mode.split(":", 1)[1]]
             if mode.startswith("fault:") else None)
    params0, mix, trainer = train.build(cfg, spec, seed, device, fault)
    got = train.setup_steps(trainer, mix, device, spec)
    del trainer, mix
    _free(device)
    if mode == "control":
        # the program's set-up fixes the steps; the reference in the lower
        # precision takes them in its place
        low = train.reference_readings(cfg, params0, got, device,
                                       LOWER[cfg["compute_dtype"]])
        got.losses, got.grads, got.params = (low["losses"], low["grads"],
                                             low["params"])
        del low
        _free(device)
    want = train.reference_readings(cfg, params0, got, device)
    readings = train.judge(cfg, got, want, {}, outcome)
    return readings, outcome.notes


def parse_readings(cfg, spec, seed, device, mode):
    import torch

    from benchmark.core import faults, parse, traffic, weights
    from benchmark.core.cell import Outcome
    from benchmark.core.spans import Spans
    from benchmark.core.train import host_tree
    from benchmark.reference import cky

    outcome = Outcome()
    if mode == "control":
        params0 = host_tree(weights.make(cfg, seed, device))
        mix = traffic.ParseMix(spec, cfg, seed)
        params = parse._to(params0, device)
        kept = {i: cky.best_trees(
            cfg, params, torch.as_tensor(mix.requests[i], device=device),
            LOWER[cfg["compute_dtype"]])
            for i in parse.sample(mix, seed)}
        del params
    else:
        fault = (None if mode == "program"
                 else faults.FAULTS["parse"][mode.split(":", 1)[1]])
        params0, mix, trainer = parse.build(cfg, spec, seed, device, fault)
        kept = {}
        for i in parse.sample(mix, seed):
            trees, _ = parse.serve(trainer, mix.requests[i], Spans())
            kept[i] = trees
        del trainer
    _free(device)
    worst = parse.judge(cfg, params0, mix, kept, device, {}, outcome)
    return {"tree_gap": worst}, outcome.notes


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--mode", default="program")
    args = ap.parse_args(argv)

    import torch

    from benchmark.core import cell

    man = cell.manifest()
    work = cell.workload(man, args.workload)
    cfg = cell.config(man, work["config"])
    spec = cell.traffic(work["traffic"])
    limits = cell.limits(work["name"])
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fn = train_readings if spec["kind"] == "train" else parse_readings
    for seed in (int(s) for s in args.seeds.split(",")):
        readings, notes = fn(cfg, spec, seed, device, args.mode)
        print(json.dumps({
            "workload": work["name"], "mode": args.mode, "seed": seed,
            "readings": {k: (v if math.isfinite(v) else str(v))
                         for k, v in readings.items()},
            "limits": limits, "notes": notes}), flush=True)
        _free(device)


if __name__ == "__main__":
    sys.exit(main())
