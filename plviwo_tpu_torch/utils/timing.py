"""Named stopwatch (port of plviwo_tpu/utils/timing.py; reference:
viw::TimeChecker, TimeChecker.h:35-80: ding/dong pairs).  Only the pairs
the driver reads are kept; the JAX class's mean/max summaries have no
caller in the port.  Host clock only: a caller timing device work
synchronizes before `dong`."""

from __future__ import annotations

import time


class TimeChecker:
    def __init__(self):
        self._start: dict[str, float] = {}

    def ding(self, name: str):
        self._start[name] = time.perf_counter()

    def dong(self, name: str) -> float:
        """Seconds since `ding(name)`, or 0.0 without one."""
        t0 = self._start.pop(name, None)
        return 0.0 if t0 is None else time.perf_counter() - t0
