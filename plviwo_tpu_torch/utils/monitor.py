"""Process resource monitor (port of plviwo_tpu/utils/monitor.py): CPU% /
RSS of a PID sampled over time.

Analogue of the reference's `ov_eval/python/pid_sys.py` (157 LoC: psutil
loop logging CPU percent and memory of a node PID to a timing file).  Read
straight off ``/proc`` (psutil is not needed) and usable
both as a library (``ResourceMonitor`` context manager around a replay) and
as a CLI::

    python -m plviwo_tpu_torch.utils.monitor <pid> --interval 0.5 --out usage.txt

Output file is the same #-header + comma-row layout the timing tools load
(`eval/loader.load_timing`), so `python -m plviwo_tpu_torch.eval timing usage.txt`
and `timing-compare` work on it directly.
"""

from __future__ import annotations

import argparse
import os
import sys
import threading
import time

_CLK = os.sysconf("SC_CLK_TCK")
_PAGE = os.sysconf("SC_PAGE_SIZE")


def sample(pid: int):
    """One /proc sample: (cpu_seconds_total, rss_bytes, n_threads).

    Returns None if the process has exited.
    """
    try:
        with open(f"/proc/{pid}/stat", "rb") as f:
            raw = f.read().decode("ascii", "replace")
    except OSError:
        return None
    # comm may contain spaces/parens: split after the closing paren
    rest = raw.rsplit(")", 1)[1].split()
    utime, stime = int(rest[11]), int(rest[12])  # fields 14,15 (1-indexed)
    n_threads = int(rest[17])
    rss_pages = int(rest[21])
    return (utime + stime) / _CLK, rss_pages * _PAGE, n_threads


class ResourceMonitor:
    """Background sampler of a PID (default: this process).

    Usage::

        with ResourceMonitor(out="usage.txt", interval=0.5) as mon:
            ...  # run the replay
        print(mon.peak_rss_mb, mon.mean_cpu_pct)
    """

    def __init__(self, pid: int | None = None, interval: float = 0.5,
                 out: str | None = None):
        self.pid = pid if pid is not None else os.getpid()
        self.interval = interval
        self.out = out
        self.rows: list[tuple[float, float, float, int]] = []
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def _loop(self):
        prev = sample(self.pid)
        prev_t = time.monotonic()
        t0 = prev_t
        while prev is not None and not self._stop.wait(self.interval):
            cur = sample(self.pid)
            now = time.monotonic()
            if cur is None:
                break
            cpu_pct = 100.0 * (cur[0] - prev[0]) / max(now - prev_t, 1e-9)
            self.rows.append((now - t0, cpu_pct, cur[1] / 1e6, cur[2]))
            prev, prev_t = cur, now

    def __enter__(self):
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        if self.out and self.rows:
            self.write(self.out)

    def write(self, path: str):
        with open(path, "w") as f:
            f.write("# t,cpu_pct,rss_mb,threads\n")
            for row in self.rows:
                f.write(f"{row[0]:.3f},{row[1]:.2f},{row[2]:.2f},{row[3]}\n")

    @property
    def peak_rss_mb(self) -> float:
        return max((r[2] for r in self.rows), default=float("nan"))

    @property
    def mean_cpu_pct(self) -> float:
        if not self.rows:
            return float("nan")
        return sum(r[1] for r in self.rows) / len(self.rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="plviwo_tpu_torch.utils.monitor")
    ap.add_argument("pid", type=int)
    ap.add_argument("--interval", type=float, default=0.5)
    ap.add_argument("--out", default="usage.txt")
    args = ap.parse_args(argv)
    mon = ResourceMonitor(pid=args.pid, interval=args.interval, out=args.out)
    with mon:
        try:
            while sample(args.pid) is not None:
                time.sleep(args.interval)
        except KeyboardInterrupt:
            pass
    print(f"wrote {len(mon.rows)} samples to {args.out} "
          f"(peak rss {mon.peak_rss_mb:.1f} MB, "
          f"mean cpu {mon.mean_cpu_pct:.0f}%)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
