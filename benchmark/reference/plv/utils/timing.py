"""Named stopwatch profiler (port of plviwo_tpu/utils/timing.py; reference:
viw::TimeChecker, TimeChecker.h:35-80: ding/dong pairs with mean/max
accumulation and per-name totals).  Host clock only: a caller timing
device work synchronizes before `dong`."""

from __future__ import annotations

import time
from collections import defaultdict


class TimeChecker:
    def __init__(self):
        self._start: dict[str, float] = {}
        self._sum = defaultdict(float)
        self._max = defaultdict(float)
        self._count = defaultdict(int)

    def ding(self, name: str):
        self._start[name] = time.perf_counter()

    def dong(self, name: str) -> float:
        """Seconds since `ding(name)`, or 0.0 without one."""
        t0 = self._start.pop(name, None)
        if t0 is None:
            return 0.0
        dt = time.perf_counter() - t0
        self._sum[name] += dt
        self._max[name] = max(self._max[name], dt)
        self._count[name] += 1
        return dt

    def timer(self, name: str):
        """Context manager form: `with tc.timer("track"): ...`"""
        tc = self

        class _Ctx:
            def __enter__(self):
                tc.ding(name)

            def __exit__(self, *a):
                tc.dong(name)

        return _Ctx()

    def mean_ms(self, name: str) -> float:
        c = self._count[name]
        return 1e3 * self._sum[name] / c if c else 0.0

    def max_ms(self, name: str) -> float:
        return 1e3 * self._max[name]

    def total_s(self, name: str) -> float:
        return self._sum[name]

    def summary(self) -> dict:
        return {
            name: {
                "mean_ms": round(self.mean_ms(name), 3),
                "max_ms": round(self.max_ms(name), 3),
                "total_s": round(self._sum[name], 3),
                "count": self._count[name],
            }
            for name in self._sum
        }

    def print_summary(self):
        for name, s in sorted(self.summary().items()):
            print(
                f"  {name:<24} mean {s['mean_ms']:8.2f} ms  "
                f"max {s['max_ms']:8.2f} ms  n={s['count']}"
            )
