"""Evaluation CLI (port of plviwo_tpu/eval/__main__.py):
`python -m plviwo_tpu_torch.eval <cmd> ...`.

Consolidates the reference's 12 ov_eval binaries (error_singlerun,
error_comparison, error_dataset, timing_*, plot_trajectories,
format_converter...) into subcommands producing JSON (and markdown tables
for `compare` and `timing-compare`), the JAX CLI's output for the same
files.  `plot` draws its two panels (x-y, and z over time) with
`utils/viz`'s segment drawer into an RGB PNG of the port's own codec: not
matplotlib's figure (no axes or legend), which the machines running the
port do not carry.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from .loader import load_timing, load_tum, save_tum
from .metrics import Stats, ate, nees, rpe


def cmd_ate(args):
    t_e, p_e, q_e = load_tum(args.est)
    t_g, p_g, q_g = load_tum(args.gt)
    out = ate(t_e, p_e, q_e, t_g, p_g, q_g, method=args.align, tol=args.tol)
    print(json.dumps(out, indent=None))
    return 0


def cmd_rpe(args):
    t_e, p_e, q_e = load_tum(args.est)
    t_g, p_g, q_g = load_tum(args.gt)
    segs = tuple(float(s) for s in args.segments.split(","))
    out = rpe(t_e, p_e, q_e, t_g, p_g, q_g, segment_lengths=segs, tol=args.tol)
    print(json.dumps(out))
    return 0


def cmd_compare(args):
    """Multi-run x multi-algorithm ATE table (error_comparison equivalent)."""
    rows = []
    t_g, p_g, q_g = load_tum(args.gt)
    for est in args.est:
        t_e, p_e, q_e = load_tum(est)
        res = ate(t_e, p_e, q_e, t_g, p_g, q_g, method=args.align)
        pos = res.get("pos", {})
        rows.append((est, pos.get("rmse", float("nan")),
                     (res.get("ori_deg") or {}).get("rmse", float("nan"))))
    print("| run | ATE pos RMSE [m] | ATE ori RMSE [deg] |")
    print("|---|---|---|")
    for name, p, o in rows:
        print(f"| {name} | {p:.4f} | {o:.4f} |")
    return 0


def cmd_timing(args):
    names, rows = load_timing(args.file)
    out = {}
    for i, name in enumerate(names or []):
        if i == 0:
            continue  # timestamp column
        out[name] = Stats.from_values(rows[:, i]).as_dict()
    print(json.dumps(out))
    return 0


def cmd_dataset(args):
    """Per-dataset error aggregation over runs (error_dataset equivalent):
    each --pair is est,gt; runs sharing a gt file group into one dataset."""
    groups = {}
    for pair in args.pair:
        est, gt = pair.split(",")
        groups.setdefault(gt, []).append(est)
    out = {}
    all_rmse = []
    for gt, ests in groups.items():
        t_g, p_g, q_g = load_tum(gt)
        rmses = []
        for est in ests:
            t_e, p_e, q_e = load_tum(est)
            res = ate(t_e, p_e, q_e, t_g, p_g, q_g, method=args.align)
            rmses.append(res.get("pos", {}).get("rmse", float("nan")))
        out[gt] = {"runs": len(ests),
                   "ate_rmse": Stats.from_values(np.asarray(rmses)).as_dict()}
        all_rmse.extend(rmses)
    out["overall_mean_rmse"] = float(np.mean(all_rmse)) if all_rmse else None
    print(json.dumps(out))
    return 0


def cmd_nees(args):
    """Full-state NEES over recorder est/std/gt triplets (error_simulation /
    ResultSimulation semantics, ov_eval calc/ResultSimulation.h:52-80)."""
    d = args.dir
    est = np.loadtxt(os.path.join(d, "state_est.txt"))
    std = np.loadtxt(os.path.join(d, "state_std.txt"))
    gt = np.loadtxt(os.path.join(d, "state_gt.txt"))
    n = min(len(est), len(std), len(gt))
    est, std, gt = est[:n], std[:n], gt[:n]
    # est/gt rows: [t q(4) p(3) v(3) bg(3) ba(3)]; std rows: [t th p v bg ba]
    out = nees(est[:, 5:8], est[:, 1:5], std[:, 4:7], std[:, 1:4],
                  gt[:, 5:8], gt[:, 1:5])
    for name, sl_e, sl_s in (("v", slice(8, 11), slice(7, 10)),
                             ("bg", slice(11, 14), slice(10, 13)),
                             ("ba", slice(14, 17), slice(13, 16))):
        err = est[:, sl_e] - gt[:, sl_e]
        block = np.sum((err / np.maximum(std[:, sl_s], 1e-12)) ** 2, axis=1)
        out[f"{name}_nees"] = Stats.from_values(block).as_dict()
        out[f"{name}_err_rmse"] = float(np.sqrt(np.mean(err**2)))
    print(json.dumps(out))
    return 0


def cmd_timing_compare(args):
    """Side-by-side per-stage timing stats across runs (timing_comparison
    analogue, ov_eval/src/timing_comparison.cpp): one markdown row per
    stage, one column pair (mean/std ms) per timing file."""
    runs = []
    stages = []
    for path in args.file:
        names, rows = load_timing(path)
        cols = {}
        for i, name in enumerate(names or []):
            if i == 0:
                continue
            cols[name] = Stats.from_values(rows[:, i])
            if name not in stages:
                stages.append(name)
        runs.append((path, cols))
    header = "| stage | " + " | ".join(p for p, _ in runs) + " |"
    print(header)
    print("|---" * (len(runs) + 1) + "|")
    for stage in stages:
        cells = []
        for _, cols in runs:
            s = cols.get(stage)
            cells.append("-" if s is None
                         else f"{s.mean:.2f} ± {s.std:.2f} ms")
        print(f"| {stage} | " + " | ".join(cells) + " |")
    return 0


def cmd_flamegraph(args):
    """Cumulative per-stage timing breakdown (timing_flamegraph analogue)."""
    names, rows = load_timing(args.file)
    totals = [(name, float(np.sum(rows[:, i])))
              for i, name in enumerate(names or []) if i > 0]
    totals.sort(key=lambda kv: -kv[1])
    grand = sum(v for _, v in totals) or 1.0
    width = 50
    for name, v in totals:
        bar = "#" * max(1, int(width * v / totals[0][1]))
        print(f"{name:24s} {v:10.1f} ms {100*v/grand:5.1f}%  {bar}")
    return 0


def cmd_percentages(args):
    """Mean per-stage share of total frame time (timing_percentages)."""
    names, rows = load_timing(args.file)
    cols = {name: rows[:, i] for i, name in enumerate(names or []) if i > 0}
    tot = sum(cols.values())
    tot = np.where(tot <= 0, 1.0, tot)
    out = {name: round(float(np.mean(100.0 * v / tot)), 2)
           for name, v in cols.items()}
    print(json.dumps(out))
    return 0


def _panel(img, x0, y0, w, h, series, colors):
    """Draw each (x, y) series as a polyline into the (x0, y0, w, h) box of
    img, all series scaled together (equal axes), on a dark frame."""
    from ..utils.viz import _draw_segment

    for a, b in (((x0, y0), (x0 + w, y0)), ((x0 + w, y0), (x0 + w, y0 + h)),
                 ((x0 + w, y0 + h), (x0, y0 + h)), ((x0, y0 + h), (x0, y0))):
        _draw_segment(img, a, b, (0, 0, 0))
    pts = np.concatenate([s for s in series if len(s)]) if any(len(s) for s in series) else None
    if pts is None:
        return
    lo, hi = pts.min(0), pts.max(0)
    scale = 0.9 * min(w / max(hi[0] - lo[0], 1e-9), h / max(hi[1] - lo[1], 1e-9))
    mid = 0.5 * (lo + hi)
    for s, color in zip(series, colors):
        u = x0 + 0.5 * w + scale * (s[:, 0] - mid[0])
        v = y0 + 0.5 * h - scale * (s[:, 1] - mid[1])
        for k in range(len(s) - 1):
            _draw_segment(img, (u[k], v[k]), (u[k + 1], v[k + 1]), color)


def cmd_plot(args):
    """Plot trajectories to a PNG (plot_trajectories analogue): the x-y path
    on the left, z over time on the right, one color per file."""
    from ..utils.viz import save_image

    palette = [(31, 119, 180), (255, 127, 14), (44, 160, 44), (214, 39, 40),
               (148, 103, 189), (140, 86, 75)]
    img = np.full((600, 1320, 3), 255, dtype=np.uint8)
    xy, tz = [], []
    for path in args.traj:
        t, p, _ = load_tum(path)
        xy.append(p[:, :2])
        tz.append(np.stack([t - t[0], p[:, 2]], -1) if len(t) else np.zeros((0, 2)))
    colors = [palette[i % len(palette)] for i in range(len(args.traj))]
    _panel(img, 20, 20, 620, 560, xy, colors)
    _panel(img, 680, 20, 620, 560, tz, colors)
    out = args.out if args.out.endswith(".png") else args.out + ".png"
    save_image(out, img)
    print(json.dumps({"out": args.out, "n": len(args.traj)}))
    return 0


def cmd_convert(args):
    """Trajectory format conversion (format_converter analogue): TUM
    (space-separated t x y z qx qy qz qw) <-> CSV (comma, same columns)."""
    src = args.src
    delim = "," if args.from_fmt == "csv" else None
    arr = np.loadtxt(src, delimiter=delim, comments=("#", "t,"))
    if arr.ndim == 1:
        arr = arr[None]
    if args.to_fmt == "csv":
        header = "t,x,y,z,qx,qy,qz,qw"
        np.savetxt(args.dst, arr[:, :8], delimiter=",", header=header, fmt="%.9f")
    else:
        save_tum(args.dst, arr[:, 0], arr[:, 1:4], arr[:, 4:8])
    print(json.dumps({"rows": int(len(arr)), "out": args.dst}))
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(prog="plviwo_tpu_torch.eval")
    sub = ap.add_subparsers(dest="cmd", required=True)

    a = sub.add_parser("ate", help="absolute trajectory error (error_singlerun)")
    a.add_argument("est"); a.add_argument("gt")
    a.add_argument("--align", default="posyaw", choices=["none", "posyaw", "se3", "sim3"])
    a.add_argument("--tol", type=float, default=0.02)
    a.set_defaults(fn=cmd_ate)

    r = sub.add_parser("rpe", help="relative pose error over segments")
    r.add_argument("est"); r.add_argument("gt")
    r.add_argument("--segments", default="8,16,24,32,48")
    r.add_argument("--align", default="posyaw")
    r.add_argument("--tol", type=float, default=0.02)
    r.set_defaults(fn=cmd_rpe)

    c = sub.add_parser("compare", help="multi-run ATE table (error_comparison)")
    c.add_argument("gt"); c.add_argument("est", nargs="+")
    c.add_argument("--align", default="posyaw")
    c.set_defaults(fn=cmd_compare)

    t = sub.add_parser("timing", help="timing-file statistics (timing_histogram)")
    t.add_argument("file")
    t.set_defaults(fn=cmd_timing)

    ds = sub.add_parser("dataset", help="per-dataset error over runs (error_dataset)")
    ds.add_argument("pair", nargs="+", help="est.txt,gt.txt per run")
    ds.add_argument("--align", default="posyaw")
    ds.set_defaults(fn=cmd_dataset)

    n = sub.add_parser(
        "nees", help="full-state NEES over recorder triplets (error_simulation)")
    n.add_argument("dir", help="recorder directory with state_{est,std,gt}.txt")
    n.set_defaults(fn=cmd_nees)

    tc = sub.add_parser(
        "timing-compare",
        help="per-stage timing stats across runs (timing_comparison)")
    tc.add_argument("file", nargs="+")
    tc.set_defaults(fn=cmd_timing_compare)

    f = sub.add_parser("flamegraph", help="per-stage cumulative timing view")
    f.add_argument("file")
    f.set_defaults(fn=cmd_flamegraph)

    p = sub.add_parser("percentages", help="per-stage share of frame time")
    p.add_argument("file")
    p.set_defaults(fn=cmd_percentages)

    pl = sub.add_parser("plot", help="plot trajectories to PNG (plot_trajectories)")
    pl.add_argument("traj", nargs="+")
    pl.add_argument("--out", default="trajectories.png")
    pl.set_defaults(fn=cmd_plot)

    cv = sub.add_parser("convert", help="TUM <-> CSV trajectory conversion")
    cv.add_argument("src"); cv.add_argument("dst")
    cv.add_argument("--from", dest="from_fmt", default="tum",
                    choices=["tum", "csv"])
    cv.add_argument("--to", dest="to_fmt", default="csv",
                    choices=["tum", "csv"])
    cv.set_defaults(fn=cmd_convert)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
