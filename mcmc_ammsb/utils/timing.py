"""Stage timers + stats table.

The reference accumulates per-kernel device-event seconds and prints a
stage table with % of total at exit (/root/reference/mcmc/learner.cc:
252-299, phi.cc:755-762). Under full-step jit fusion individual "kernels"
no longer exist, so the host-clock stages are host sampling, device step
dispatch (per scan-chunk), and evaluation; per-stage device time comes
from a profiler trace (utils/profiling.py).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Callable, Dict


class StageTimers:
    def __init__(self):
        self.seconds: Dict[str, float] = defaultdict(float)
        self.calls: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[name] += time.perf_counter() - t0
            self.calls[name] += 1

    def print_table(self, log: Callable[[str], None] = print) -> None:
        total = self.seconds.get("total", sum(self.seconds.values()))
        log(f"TOTAL    : {total:.6f}")
        for name in sorted(self.seconds):
            if name == "total":
                continue
            s = self.seconds[name]
            pct = 100.0 * s / total if total else 0.0
            log(f"{name.upper():9s}: {s:.6f} (%{pct:.2f}) "
                f"[{self.calls[name]} calls]")
