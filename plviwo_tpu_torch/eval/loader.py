"""Trajectory and timing file IO (port of plviwo_tpu/eval/loader.py;
reference: ov_eval Loader / Recorder, utils/Loader.h:51-97): TUM-format
trajectories and timing CSVs."""

from __future__ import annotations

import numpy as np


def load_tum(path):
    """Load a TUM-format trajectory: t tx ty tz qx qy qz qw.

    Returns (t (N,), p (N,3), q (N,4)).  Quaternions are stored as written
    (the drivers write JPL q_GtoI)."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.replace(",", " ").split()
            if len(parts) < 8:
                continue
            rows.append([float(x) for x in parts[:8]])
    arr = np.asarray(rows)
    if arr.size == 0:
        return np.zeros(0), np.zeros((0, 3)), np.zeros((0, 4))
    return arr[:, 0], arr[:, 1:4], arr[:, 4:8]


def save_tum(path, t, p, q):
    with open(path, "w") as f:
        f.write("# timestamp tx ty tz qx qy qz qw\n")
        for ti, pi, qi in zip(t, p, q):
            f.write(f"{ti:.9f} {pi[0]:.6f} {pi[1]:.6f} {pi[2]:.6f} "
                    f"{qi[0]:.7f} {qi[1]:.7f} {qi[2]:.7f} {qi[3]:.7f}\n")


def load_timing(path):
    """Timing CSV: t, total_ms [, stage_ms...] under a `# name,...` header.
    Returns (names, rows (N, k))."""
    names = None
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith("#"):
                names = [s.strip() for s in line[1:].split(",")]
                continue
            rows.append([float(x) for x in line.split(",")])
    return names, np.asarray(rows)


def save_timing(path, names, rows):
    with open(path, "w") as f:
        f.write("# " + ",".join(names) + "\n")
        for r in rows:
            f.write(",".join(f"{x:.6f}" for x in r) + "\n")
