"""Host-clock spans around the benchmark's calls into the program's layers.

Each span is a name and a duration, kept in memory.  While a profiled
stretch runs, the spans are also annotations of the profiler's trace
(``bench.<name>``), so that an idle gap on the device can be named by
what the host was doing, and they are not counted: the profiler slows
the host.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List


class Spans:
    def __init__(self):
        self.seconds: Dict[str, List[float]] = {}
        self.tracing = False

    @contextlib.contextmanager
    def span(self, name: str):
        if self.tracing:
            from torch.profiler import record_function

            with record_function("bench." + name):
                yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds.setdefault(name, []).append(time.perf_counter() - t0)

    def total(self, name: str) -> float:
        return sum(self.seconds.get(name, ()))

    def count(self, name: str) -> int:
        return len(self.seconds.get(name, ()))
