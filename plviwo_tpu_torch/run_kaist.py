"""KAIST Complex Urban replay driver (port of plviwo_tpu/run_kaist.py): the
reference's `bag` executable (`run_bag.cpp:51-144`) without ROS.

It streams a sequence's time-ordered sensor events (`data/kaist.py`) into
the per-track `VioSystem`: IMU, wheel and GPS samples as they come, and
each image through the host KLT tracker (`update/tracker.py`, LK on the
card's kernel; stereo with --stereo and two calibrated cameras) and with
--lines the host line tracker (`update/line_tracker.py`), then
`feed_camera` / `feed_stereo`.  Options: the driver's KAIST defaults first,
then the layered YAML of --config over them (`config/yaml_io.py`).  At the
end a TUM trajectory (--out) and one JSON line: the JAX driver's keys
(frames, clones, updates, wall_s, fps and, where global_pose.csv has the
ground truth, the position-and-yaw aligned ate_rmse_m), the device, the
feature store the MSCKF candidates came from, and per frame the host ms of
the image decode, the point tracker, the line tracker and the filter (p50 /
p90).

Usage (on the card; `--device cpu` runs the same on the CPU):
    python -m plviwo_tpu_torch.run_kaist --root /data/urban26 --config configs/kaist/config.yaml
        [--wheel] [--gps] [--lines] [--stereo] [--dynamic] [--duration S] [--out traj.txt]
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _parser():
    ap = argparse.ArgumentParser(description="PL-VIWO port: KAIST replay")
    ap.add_argument("--root", required=True, help="sequence root (contains sensor_data/)")
    ap.add_argument("--duration", type=float, default=None, help="seconds to replay")
    ap.add_argument("--wheel", action="store_true")
    ap.add_argument("--gps", action="store_true")
    ap.add_argument("--lines", action="store_true")
    ap.add_argument("--stereo", action="store_true",
                    help="use stereo/right images when present (the reference README forces "
                         "mono on KAIST; stereo is opt-in here)")
    ap.add_argument("--dynamic", action="store_true")
    ap.add_argument("--config", type=str, default=None,
                    help="layered YAML config (see configs/kaist/config.yaml)")
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device; the run raises without a card unless it is 'cpu'")
    return ap


def kaist_base_options(ds, wheel: bool, gps: bool):
    """The driver's KAIST defaults (the reference's config/kaist/kaist_C
    values), which the YAML then overrides key by key."""
    from .config.options import Options

    base = Options()
    c = base.est.cam
    c.sigma_pix, c.chi2_mult, c.min_track_length, c.max_msckf = 1.5, 8.0, 4, 40
    # the standard KAIST rig's left camera; configs/kaist/config_camera.yaml
    # carries the reference's calibrated values
    c.intrinsics = [[816.402, 817.316, 608.826, 266.688, -0.0568, 0.0836, 0.0007, -0.0004]]
    c.extrinsics = [[0.5019, -0.4999, 0.4981, -0.5001, 0.0, 0.0, 0.0]]
    c.timeoffsets = [0.0]
    if wheel:
        w = base.est.wheel
        w.enabled, w.type = True, "Wheel3DAng"
        w.noise_w, w.noise_v, w.noise_p = 0.2, 0.5, 0.1
        w.intrinsics = list(map(float, ds.wheel_intr))
    if gps:
        g = base.est.gps
        g.enabled, g.noise, g.chi2_mult, g.init_distance = True, 3.0, 9999.0, 20.0
    return base


def replay(args):
    """Run the replay of parsed arguments.  Returns (summary dict or None
    without IMU data, the VioSystem, per-frame host ms {"point_tracker",
    "line_tracker", "filter"})."""
    import numpy as np
    import torch

    from .core.system import VioSystem
    from .data.kaist import KaistDataset
    from .eval.metrics import ate
    from .update.line_tracker import LineTracker
    from .update.tracker import KltTracker, StereoKltTracker

    ds = KaistDataset(args.root)
    if not ds.has_imu:
        return None, None, None
    base = kaist_base_options(ds, args.wheel, args.gps)
    if args.config:
        from .config.yaml_io import load_options

        opts = load_options(args.config, base=base).est
    else:
        opts = base.est
    opts.dynamic_cloning = args.dynamic or opts.dynamic_cloning
    opts.cam.use_lines = args.lines
    use_stereo = bool(args.stereo and ds.has_stereo and len(opts.cam.intrinsics) > 1
                      and len(opts.cam.extrinsics) > 1)

    cam_k = np.asarray(opts.cam.intrinsics[0], dtype=np.float64)
    ext = list(opts.cam.extrinsics[0])
    cam_dt = float(opts.cam.timeoffsets[0]) if opts.cam.timeoffsets else 0.0
    sys_ = VioSystem(opts, device=args.device)
    sys_.set_calibration(cam_k, ext[0:4], ext[4:7], cam_dt=cam_dt)
    if use_stereo:
        ext1 = list(opts.cam.extrinsics[1])
        dt1 = float(opts.cam.timeoffsets[1]) if len(opts.cam.timeoffsets) > 1 else 0.0
        sys_.set_calibration(list(opts.cam.intrinsics[1]), ext1[0:4], ext1[4:7], cam_dt=dt1,
                             cam=1)
    if args.wheel:
        wext = list(opts.wheel.extrinsics)
        sys_.set_wheel_calibration(wext[0:4], wext[4:7], list(opts.wheel.intrinsics))
    if args.gps and opts.gps.extrinsics:
        sys_.set_gps_calibration(np.asarray(opts.gps.extrinsics[0], dtype=np.float64))

    n_pts = int(opts.cam.n_pts) if opts.cam.n_pts else 150
    tracker = (StereoKltTracker if use_stereo else KltTracker)(
        n_pts=n_pts, cam_k=cam_k, grid_x=16, grid_y=10, device=args.device)
    ltracker = (LineTracker(max_lines=opts.cam.max_lines, device=args.device)
                if args.lines else None)

    ms = {"decode": [], "point_tracker": [], "line_tracker": [], "filter": []}
    filter_s = 0.0  # host seconds in the filter since the last frame

    def timed(fn, *a):
        nonlocal filter_s
        t0 = time.perf_counter()
        fn(*a)
        filter_s += time.perf_counter() - t0

    t0_wall = time.time()
    t_start = None
    n_frames = 0
    for t, kind, payload in ds.stream():
        if t_start is None:
            t_start = t
        if args.duration and t - t_start > args.duration:
            break
        if kind == "imu":
            timed(sys_.feed_imu, t, payload[0], payload[1])
        elif kind == "wheel" and args.wheel:
            timed(sys_.feed_wheel, t, payload[0], payload[1])
        elif kind == "gps" and args.gps:
            timed(sys_.feed_gps, t, *payload)
        elif kind == "image" and ds.has_images:
            t0 = time.perf_counter()
            img = ds.image(t)
            img_r = ds.image(t, cam=1) if use_stereo else None
            ms["decode"].append(1e3 * (time.perf_counter() - t0))
            out = tracker.feed_stereo(img, img_r) if use_stereo else tracker.feed(img)
            if ltracker is not None:
                out += ltracker.feed(img, out[0], out[1])
            if n_frames:
                ms["filter"].append(1e3 * filter_s)
            filter_s = 0.0
            ms["point_tracker"].append(tracker.last_ms)
            ms["line_tracker"].append(ltracker.last_ms if ltracker is not None else 0.0)
            timed(sys_.feed_stereo if use_stereo else sys_.feed_camera, t, *out)
            n_frames += 1
    wall = time.time() - t0_wall
    if n_frames:
        ms["filter"].append(1e3 * filter_s)

    if args.out and sys_.traj:
        from .eval.loader import save_tum

        save_tum(args.out, [t for t, _, _ in sys_.traj], [p for _, _, p in sys_.traj],
                 [q for _, q, _ in sys_.traj])

    summary = {"frames": n_frames, "clones": sys_.stats["clones"],
               "updates": sys_.stats["updates"], "wall_s": round(wall, 1),
               "fps": round(n_frames / max(wall, 1e-9), 2)}
    gt_t, gt_p, _ = ds.ground_truth()
    if len(gt_t) > 10 and len(sys_.traj) > 10:
        t_e = np.asarray([t for t, _, _ in sys_.traj])
        p_e = np.asarray([p for _, _, p in sys_.traj])
        res = ate(t_e, p_e, None, gt_t, gt_p, None, method="posyaw", tol=0.05)
        summary["ate_rmse_m"] = res.get("pos", {}).get("rmse")
    dev = sys_.device
    summary["device"] = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    summary["feature_store"] = sys_.feature_store
    summary["frame_ms"] = {k: {"p50": round(float(np.percentile(v, 50)), 3),
                               "p90": round(float(np.percentile(v, 90)), 3)}
                           for k, v in ms.items() if v}
    return summary, sys_, ms


def main(argv=None):
    args = _parser().parse_args(argv)
    summary, _, _ = replay(args)
    if summary is None:
        print(json.dumps({"error": f"no sensor_data/xsens_imu.csv under {args.root}"}))
        return 2
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
