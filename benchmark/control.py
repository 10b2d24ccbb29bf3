"""Readings for the limits of `correct`: a cell's numbers compared, over many seeds, for
the program and for the control (the reference computed in the precision just below the
configuration's, put in the program's place; see `program.load`), in one process.

    python -m benchmark.control --workload <cell> --seeds 1,2,3 [--control tf32]
        [--control-seeds 4,5] [--seconds 4] [--warm-frames 2]

Prints one JSON line per run ({"side", "seed", "correct", "numbers": every number the
check read, compared or not}), then per number the largest program reading and the
smallest control reading.  A short window will do: each run goes on after it until the
frames it checks have run.  `--warm-frames` shortens the warm-up, which times nothing here.
The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys

from . import run


def readings(cell, seeds, control, seconds, device="cuda", overrides=None, control_seeds=None):
    """[(side, seed, correct, {number: value})] for each seed, program then control (on
    `control_seeds`, or the same seeds)."""
    out = []
    for side in ("program",) + ((control,) if control else ()):
        for seed in (seeds if side == "program" or control_seeds is None else control_seeds):
            rec = run.run_cell(cell, seed, seconds, False, device, overrides,
                               control=None if side == "program" else side)
            ok = all(v <= lim for v, lim in rec["checks"].values())
            out.append((side, seed, ok, dict(rec["numbers"])))
            print(json.dumps({"side": side, "seed": seed, "correct": ok, "numbers": out[-1][3]}),
                  flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--control-seeds", default=None, help="the control's seeds, if others")
    ap.add_argument("--control", choices=("tf32", "f32_state"), default=None)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--warm-frames", type=int, default=None)
    args = ap.parse_args(argv)
    run.quiet_host()
    run.cache_env()
    import torch

    if not torch.cuda.is_available():
        print("no card", file=sys.stderr)
        return 3
    over = ({"workload": {"warm_frames": args.warm_frames}}
            if args.warm_frames is not None else None)
    ctl_seeds = ([int(s) for s in args.control_seeds.split(",")]
                 if args.control_seeds else None)
    rows = readings(args.workload, [int(s) for s in args.seeds.split(",")], args.control,
                    args.seconds, overrides=over, control_seeds=ctl_seeds)
    for name in sorted({k for r in rows for k in r[3]}):
        prog = [r[3][name] for r in rows if r[0] == "program" and name in r[3]]
        ctl = [r[3][name] for r in rows if r[0] != "program" and name in r[3]]
        print(json.dumps({"number": name, "program_max": max(prog) if prog else None,
                          "control_min": min(ctl) if ctl else None}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
