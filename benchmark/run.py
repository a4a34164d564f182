"""Run one cell of the benchmark once.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

The cell's configuration, traffic mix, per-layer metric readers and
limits are files found by the names in ``BENCHMARK.json``
(``benchmark/core/cell.py``).  The run needs as many CUDA cards as the
cell asks for and stops with an error (exit 2, no result) without them.
It prints, as the last line of standard output, one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``: each number the check of ``correct`` compared, beside its
limit.  The same checks end its standard error.

Every build and kernel cache stays inside the checkout: the program
builds its kernels under ``cliora_tpu_torch/_build/``, and the caches
of torch's own compilers are pointed at ``.bench_cache/``.  A run that
finds JAX or the JAX package loaded once its window has closed stops
with an error (exit 3, no result).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
import traceback

FORBIDDEN = ("jax", "jaxlib", "flax", "cliora_tpu")


def seconds_since_start() -> float:
    """Seconds since this process started (the kernel's start time, so
    that the interpreter's own start-up counts)."""
    try:
        with open("/proc/self/stat") as f:
            start = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T0


_T0 = time.perf_counter()


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def cache_dirs(repo: str):
    cache = os.path.join(repo, ".bench_cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = os.path.join(cache, sub)
    os.environ["USE_FLAX"] = "0"


def _finite(x):
    """JSON has no infinity: a reading that is not finite prints as the
    largest double, far above any limit."""
    return x if math.isfinite(x) else 1.7976931348623157e308


def fail(code: int, msg: str):
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(code)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        fail(2, "--seed must be a whole number >= 0")

    from benchmark.core import cell

    cache_dirs(cell.REPO)
    man = cell.manifest()
    work = cell.workload(man, args.workload)

    import torch

    if not torch.cuda.is_available():
        fail(2, "no CUDA device: the benchmark measures the card")
    if torch.cuda.device_count() < int(work["chips"]):
        fail(2, f"the cell asks for {work['chips']} cards, "
                f"{torch.cuda.device_count()} found")
    try:
        import cliora_tpu_torch  # noqa: F401
    except ImportError as err:
        fail(2, f"the program is missing from the checkout: {err}")

    cfg = cell.config(man, work["config"])
    spec = cell.traffic(work["traffic"])
    limits = cell.limits(work["name"])
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    driver = __import__(f"benchmark.core.{spec['kind']}",
                        fromlist=["run"])
    run, outcome, peak = driver.run(cfg, spec, args.seed, args.seconds,
                                    bool(args.trace), device, limits,
                                    seconds_since_start)

    loaded = forbidden_modules()
    if loaded:
        fail(3, f"modules of JAX or the JAX package are loaded: {loaded}")

    metrics = {}
    for m in cell.reported(man, work["name"], bool(args.trace)):
        if args.trace:
            value = cell.reader(m["name"])(run)
        else:
            value = run.end_to_end.get(m["name"])
        if value is None or not math.isfinite(value):
            continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
           "count": int(work["chips"]), "memory_peak_bytes": int(peak)}
    out = {"correct": outcome.correct, "attempted": outcome.attempted,
           "failed": outcome.failed, "metrics": metrics, "device": dev}
    if args.trace and run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        out["breakdown"] = run.trace.breakdown()
    out["checks"] = {k: {"value": _finite(c["value"]),
                         "limit": c["limit"]}
                     for k, c in outcome.checks.items()}
    for note in outcome.notes:
        print(f"benchmark: {note}", file=sys.stderr)
    for name, c in outcome.checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    try:
        main()
    except SystemExit:
        raise
    except BaseException:
        traceback.print_exc()
        sys.stderr.flush()
        raise SystemExit(1)
