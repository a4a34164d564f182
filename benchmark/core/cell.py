"""A cell's files, found by the names in ``BENCHMARK.json``, and the record
of one run that the per-layer metric readers read.

* ``benchmark/configs/<config>.json``: the configuration as it is run;
* ``benchmark/traffic/<traffic>.json``: the mix's parameters, whose
  ``kind`` names the driver (``benchmark/core/<kind>.py``);
* ``benchmark/metrics/<metric>.py``: one per-layer metric's reader, a
  ``read(run)`` that returns the number or ``None`` where the run holds
  nothing to read;
* ``benchmark/limits/<workload>.json``: the limit of each number the
  check of ``correct`` compares.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
from typing import Any, Dict, List, Optional

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)


def _json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> Dict:
    return _json(os.path.join(REPO, "BENCHMARK.json"))


def workload(man: Dict, name: str) -> Dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(man: Dict, name: str) -> Dict:
    for c in man["configs"]:
        if c["name"] == name:
            return _json(os.path.join(REPO, c["file"]))
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str) -> Dict:
    return _json(os.path.join(BENCH, "traffic", name + ".json"))


def limits(name: str) -> Dict[str, float]:
    path = os.path.join(BENCH, "limits", name + ".json")
    return {k: (None if v["limit"] is None else float(v["limit"]))
            for k, v in _json(path)["limits"].items()}


def reported(man: Dict, cell: str, trace: bool) -> List[Dict]:
    """The metrics a run of ``cell`` reports: its end-to-end metrics with
    ``trace`` off, its per-layer metrics with it on."""
    e2e = [m for m in man["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in man["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


def reader(name: str):
    """The ``read`` function of ``benchmark/metrics/<name>.py``."""
    path = os.path.join(BENCH, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclasses.dataclass
class Run:
    """What one run measured, for the readers.  Window figures leave out
    the profiled stretch of a traced run."""
    kind: str
    cfg: Dict[str, Any]
    spans: Any
    window_s: float = 0.0
    flops: float = 0.0              # least FLOP of the window's work
    peak_flops: float = 0.0         # of the configuration's compute dtype
    units: int = 0                  # steps or requests in the window
    sentences: int = 0
    trace: Any = None               # core.trace.Trace of the profiled stretch
    traced_work: List[tuple] = dataclasses.field(default_factory=list)
    counters: Dict[str, float] = dataclasses.field(default_factory=dict)
    end_to_end: Dict[str, float] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Outcome:
    """The judged part of a run: attempts, failures, and each compared
    number beside its limit."""
    attempted: int = 0
    failed: int = 0
    checks: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)
    notes: List[str] = dataclasses.field(default_factory=list)

    def check(self, name: str, value: float, limit: Optional[float]):
        self.checks[name] = {"value": value, "limit": limit}

    @property
    def correct(self) -> bool:
        return self.failed == 0 and all(
            c["limit"] is not None and math.isfinite(c["value"])
            and c["value"] <= c["limit"] for c in self.checks.values())
