"""Stage spans of the program, and a named stopwatch.

`span(name)` marks a stage (a `with` block) and `spans()` returns what the
marks recorded.  A span records only while a `torch.profiler` session runs
over the program; otherwise it is one shared do-nothing context.  While
recording, a span keeps its name, its enclosing span, its host start and
end on the wall clock (`time.time_ns`, the clock of the profiler's chrome
trace once its `baseTimeNanoseconds` is added), and on a card two CUDA
events on the current stream, so that `device_ms` is the stretch of the
stream from the stage's first queued work to the end of its last: its
kernels and the idle gaps the host leaves between them.  It also opens a
`torch.profiler.record_function` range of its name, so that the trace
carries the stages beside the device's operations.  A span never
synchronizes.

`TimeChecker` is the port of plviwo_tpu/utils/timing.py (reference:
viw::TimeChecker, TimeChecker.h:35-80: ding/dong pairs with mean/max
accumulation and per-name totals).  Host clock only: a caller timing
device work synchronizes before `dong`."""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import time
from collections import defaultdict

import torch

_OFF = contextlib.nullcontext()


@dataclasses.dataclass
class Span:
    """One finished span: `id` in order of entry, `parent` the enclosing
    span's id (None at a root), host start and end in ns of the wall clock,
    and `device_ms` (None on the CPU, and until the card has passed both
    events)."""

    id: int
    parent: int | None
    name: str
    t0_ns: int
    t1_ns: int
    device_ms: float | None = None
    events: tuple | None = dataclasses.field(default=None, repr=False)


class _Recorder:
    """The process's spans: the stack of open ones and the finished ones."""

    def __init__(self):
        self.ids = itertools.count()
        self.stack: list[int] = []
        self.done: list[Span] = []

    @contextlib.contextmanager
    def open(self, name: str):
        sid = next(self.ids)
        parent = self.stack[-1] if self.stack else None
        self.stack.append(sid)
        t0 = time.time_ns()
        events = None
        try:
            with torch.profiler.record_function(name):
                if torch.cuda.is_initialized():
                    events = (torch.cuda.Event(enable_timing=True),
                              torch.cuda.Event(enable_timing=True))
                    events[0].record()
                try:
                    yield
                finally:
                    if events is not None:
                        events[1].record()
        finally:
            self.stack.pop()
            self.done.append(Span(sid, parent, name, t0, time.time_ns(), events=events))


_RECORDER = _Recorder()


def span(name: str):
    """A context that records the stage `name` while a profiler runs."""
    if not torch._C._autograd._profiler_enabled():
        return _OFF
    return _RECORDER.open(name)


def spans(clear: bool = False) -> list[Span]:
    """The finished spans in order of entry, with `device_ms` filled in
    where the card has passed both events (queried, never waited for);
    `clear` drops them from the recorder."""
    out = sorted(_RECORDER.done, key=lambda s: s.id)
    for s in out:
        if s.events is not None and s.events[1].query():
            s.device_ms = s.events[0].elapsed_time(s.events[1])
            s.events = None
    if clear:
        _RECORDER.done = []
    return out


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
