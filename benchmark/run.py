"""Run one cell of the benchmark of plviwo_tpu_torch once, on the card it is started on.

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell is `workloads/<cell>.json`: it names its configuration (`configs/<name>.json`),
its driver (`drivers/<driver>.py`) and its traffic's parameters.  The metrics are the
entries of BENCHMARK.json that the cell reports: the end-to-end ones with `--trace 0`,
the per-layer ones with `--trace 1`, each read by `metrics/<metric>.py` from the run's
records.  A later cell, configuration or metric is a new file, found by its name.

The driver builds the traffic from the seed, warms up, then drives the program for
`--seconds` in a closed loop, and afterwards holds the outputs it kept to the frozen
plain reference (`reference/`).  The last lines on standard error are the numbers
compared, each beside its limit; the last line of standard output is the result, one
JSON object.  Without a card, or with JAX or the JAX package loaded once the window has
closed, the run prints no result and exits with another code than 0.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
CACHE = ROOT / "build" / "benchmark"
FORBIDDEN = ("jax", "jaxlib", "flax", "plviwo_tpu")
PIN_CORES = 2  # the process's main thread and the CUDA driver's own threads


def process_start() -> float:
    """Wall-clock time at which this process started (from /proc), or now."""
    try:
        ticks = os.sysconf("SC_CLK_TCK")
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19]) / ticks
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - start)
    except (OSError, ValueError, IndexError):
        return time.time()


def quiet_host():
    """One process on few threads, pinned: the host's thread pools (OpenMP, MKL, BLAS,
    torch's intra-op pool) to one thread each, and the process to the last `PIN_CORES`
    cores it may run on, so that its threads do not wander between cores.  Called before
    numpy's or torch's first import in the process."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    try:
        cores = sorted(os.sched_getaffinity(0))
        os.sched_setaffinity(0, cores[-PIN_CORES:])
    except (AttributeError, OSError):
        pass


def cache_env():
    """Point every build and kernel cache at fixed directories inside the checkout."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"


def load_module(path: Path, kind: str):
    """A benchmark file loaded by path as benchmark.<kind>.<stem> (dots become '__')."""
    name = f"benchmark.{kind}.{path.name[:-3].replace('.', '__')}"
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def merge(base: dict, over: dict) -> dict:
    """base with over's keys set, dictionaries merged key by key."""
    out = dict(base)
    for k, v in over.items():
        out[k] = merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def cell_files(cell: str, overrides: dict | None = None):
    """(workload, config, driver module) of a cell, with test overrides merged in:
    overrides = {"workload": {...}, "config": {...}}."""
    overrides = overrides or {}
    workload = merge(read_json(BENCH / "workloads" / f"{cell}.json"),
                     overrides.get("workload", {}))
    config = merge(read_json(BENCH / "configs" / f"{workload['config']}.json"),
                   overrides.get("config", {}))
    driver = load_module(BENCH / "drivers" / f"{workload['driver']}.py", "drivers")
    return workload, config, driver


def cell_metrics(spec: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a cell reports: end-to-end ones (trace off) whose `workloads` list it
    or that have none; per-layer ones (trace on) whose `workloads` list it."""
    if trace:
        return [m for m in spec["per_layer"] if cell in m["workloads"]]
    return [m for m in spec["end_to_end"] if cell in m.get("workloads", [cell])]


def loaded_forbidden() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not read"


class Context:
    """What a driver gets: the cell's files, the seed, the window's length, whether the
    run is traced, the device, the program (`program.load`), and `setup_done`, which a
    driver calls once it is about to time its first frame."""

    def __init__(self, cell, workload, config, seed, seconds, trace, device, program, t_start):
        self.cell, self.workload, self.config = cell, workload, config
        self.seed, self.seconds, self.trace = int(seed), float(seconds), bool(trace)
        self.device, self.program, self.t_start = device, program, t_start
        self.setup_s = None
        self.info: list[str] = []
        self.numbers: dict = {}  # every number the check read, compared or not

    def setup_done(self):
        self.setup_s = time.time() - self.t_start

    def say(self, line: str):
        """A line for standard error, printed before the numbers compared."""
        self.info.append(line)


def run_cell(cell: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             overrides: dict | None = None, control: str | None = None,
             t_start: float | None = None) -> dict:
    """One run of a cell; returns the driver's records with "setup_s", "checks" (name ->
    (value, limit)) and "info" (lines).  `control` puts the reference in the lower
    precision in the program's place (see `program.load`)."""
    from . import program

    t_start = time.time() if t_start is None else t_start
    workload, config, driver = cell_files(cell, overrides)
    ctx = Context(cell, workload, config, seed, seconds, trace, device,
                  program.load(control), t_start)
    rec = driver.run(ctx)
    rec["setup_s"] = ctx.setup_s
    rec["info"] = ctx.info
    rec["numbers"] = ctx.numbers
    return rec


def result(rec: dict, metrics: list[dict], trace: bool, device: dict) -> dict:
    """The result line: correct, attempted, failed, metrics, device, breakdown, checks."""
    from .metrics._device import breakdown, busy_s, window_s

    values = {}
    for m in metrics:
        v = load_module(BENCH / "metrics" / f"{m['name']}.py", "metrics").read(rec)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    checks = rec["checks"]
    correct = bool(checks) and all(v <= lim for v, lim in checks.values())
    out = {"correct": correct, "attempted": rec["attempted"],
           "failed": rec["attempted"] - rec["completed"], "metrics": values, "device": device}
    if trace:
        prof = rec.get("profile")
        device["busy_s"] = busy_s(prof) or 0.0
        device["window_s"] = window_s(prof) or 0.0
        bd = breakdown(prof)
        if bd is not None:
            out["breakdown"] = bd
    out["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return out


def main(argv=None) -> int:
    t_start = process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    quiet_host()
    cache_env()
    import torch

    torch.set_num_threads(1)
    spec = read_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if args.workload not in cells:
        print(f"no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    chips = cells[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"no card to measure on: cuda available {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()} cards, the cell asks for {chips}", file=sys.stderr)
        return 3
    rec = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda",
                   t_start=t_start)
    bad = loaded_forbidden()
    if bad:
        print(f"JAX or the JAX package is loaded in this process: {', '.join(bad)}",
              file=sys.stderr)
        return 4
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
              "memory_peak_bytes": int(rec["memory_peak_bytes"])}
    out = result(rec, cell_metrics(spec, args.workload, bool(args.trace)), bool(args.trace),
                 device)
    numbers = ", ".join(f"{k} {v!r}" for k, v in sorted(rec["numbers"].items()))
    for line in rec["info"] + [f"numbers read: {numbers}", f"card: {card_line()}"]:
        print(line, file=sys.stderr)
    for k, c in out["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
