"""Simulation replay driver (port of plviwo_tpu/run_sim.py: the `--images`
path): the simulator's IMU, rendered frames, wheel and GPS streams through
the port's `VioSystem` in time order, one vehicle, then a TUM-format
trajectory and a one-line JSON summary (the JAX driver's keys, plus the
device the run used).  Exit code 0 iff the ATE is finite and under 5 m.

Usage (on the card; `--device cpu` runs the same on the CPU):
    python -m plviwo_tpu_torch.run_sim --images --lines --wheel --gps --out traj.txt
    python -m plviwo_tpu_torch.run_sim --images --wheel --stereo
    python -m plviwo_tpu_torch.run_sim --images --lines --wheel --dynamic --clone-freq 10

Options of the JAX driver that the port does not run yet exit non-zero
naming their ROADMAP queue.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

# JAX driver options not ported yet -> the ROADMAP queue that owns them
_NOT_PORTED = {
    "intr_order": "A9 (polynomial interpolation, the per-track path)", "tags": "A9 (ArUco tags)",
    "host_tracker": "A9 (host trackers)", "auto_init": "A9 (auto-initialization)",
    "imu_res": "A9 (CPI interpolated poses)", "calib": "A9 (online calibration)",
    "plc": "A9 (point-line-coupled rows)", "sequential_update": "A9 (per-sensor updates)",
    "max_msckf": "A9 (the per-track MSCKF update)", "perturb": "A9 (online calibration)",
    "viz_dir": "A10 (utils/viz)",
    "record": "A10 (utils/recorder)",
}


def _parser():
    ap = argparse.ArgumentParser(description="PL-VIWO port: simulated images-in replay")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device; the run raises without a card unless it is 'cpu'")
    ap.add_argument("--duration", type=float, default=15.0, help="sim duration [s]")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--sigma-pix", type=float, default=0.5)
    ap.add_argument("--n-pts", type=float, default=45,
                    help="tracker slots (the JAX driver's default 45 means 96 slots)")
    ap.add_argument("--wheel", action="store_true", help="wheel-odometry fusion (VIWO)")
    ap.add_argument("--lines", action="store_true", help="line-feature fusion (PL)")
    ap.add_argument("--gps", action="store_true",
                    help="GNSS fusion: host-side 4-DoF delayed init, then per-fix rows in "
                         "the joint update")
    ap.add_argument("--images", action="store_true",
                    help="render frames and run the images-in frame (required: the "
                         "simulator-association path is ROADMAP A9)")
    ap.add_argument("--fused-f64", action="store_true",
                    help="the frame's camera tensors in f64 instead of f32")
    ap.add_argument("--max-obs", type=int, default=None,
                    help="observation-history depth per tracker slot")
    ap.add_argument("--out", type=str, default=None, help="TUM trajectory output path")
    ap.add_argument("--stereo", action="store_true",
                    help="stereo: a right image per frame (L->R association, two cameras)")
    ap.add_argument("--dynamic", action="store_true",
                    help="dynamic cloning: adaptive clone rate, interpolated-pose point rows")
    ap.add_argument("--clone-freq", type=int, default=None,
                    help="max clone rate [Hz] (with --dynamic this caps the adaptive rate)")
    for flag in ("tags", "host_tracker", "auto_init", "imu_res", "calib", "plc",
                 "sequential_update"):
        ap.add_argument("--" + flag.replace("_", "-"), action="store_true",
                        help=f"not ported yet (ROADMAP {_NOT_PORTED[flag]})")
    for flag in ("intr_order", "max_msckf", "perturb", "viz_dir", "record"):
        ap.add_argument("--" + flag.replace("_", "-"), default=None,
                        help=f"not ported yet (ROADMAP {_NOT_PORTED[flag]})")
    return ap


def main(argv=None):
    args = _parser().parse_args(argv)
    refused = [f for f in _NOT_PORTED if getattr(args, f) not in (False, None)]
    if refused or not args.images:
        what = [f"--{f.replace('_', '-')}: ROADMAP {_NOT_PORTED[f]}" for f in refused]
        if not args.images:
            what.append("runs without --images (simulator data association, the per-track "
                        "path): ROADMAP A9")
        print("run_sim: not ported yet: " + "; ".join(what), file=sys.stderr)
        return 2

    import numpy as np
    import torch

    from .config.options import EstimatorOptions
    from .core.system import VioSystem
    from .eval.metrics import ate
    from .ops import lie
    from .sim.simulator import SimConfig, Simulator

    cfg = SimConfig(duration=args.duration, seed=args.seed, sigma_pix=args.sigma_pix,
                    n_pts=int(args.n_pts))
    sim = Simulator(cfg)

    opts = EstimatorOptions()
    opts.dynamic_cloning = args.dynamic
    if args.clone_freq is not None:
        opts.clone_freq = args.clone_freq
    opts.cam.sigma_pix = max(args.sigma_pix, 0.3)
    opts.cam.min_track_length = 4
    opts.cam.chi2_mult = 5.0
    if args.stereo:
        opts.cam.max_n = 2
        opts.cam.min_track_length = 6  # stereo tracks gain 2 obs per frame
    if args.lines:
        opts.cam.use_lines = True
        opts.cam.max_lines = 20
        opts.cam.sigma_pix_line = 2.0
    if args.gps:
        opts.gps.enabled = True
        opts.gps.noise = cfg.sigma_gps
        opts.gps.chi2_mult = 10.0
        opts.gps.init_distance = 8.0
    if args.wheel:
        opts.wheel.enabled = True
        opts.wheel.type = "Wheel3DAng"
        opts.wheel.noise_w = 0.05
        opts.wheel.noise_v = 0.05
        opts.wheel.noise_p = 0.02
        opts.wheel.intrinsics = [cfg.wheel_rl, cfg.wheel_rr, cfg.wheel_base]
        opts.wheel.chi2_mult = 10.0
    if args.fused_f64:
        opts.cam.fused_dtype = "f64"
    if args.max_obs is not None:
        opts.cam.fused_max_obs = args.max_obs
    # the images-in frame's settings
    opts.cam.sigma_pix = max(opts.cam.sigma_pix, 1.5)
    opts.cam.chi2_mult = 8.0
    opts.cam.n_pts = int(args.n_pts) if args.n_pts != 45 else 96
    opts.cam.max_lines = min(opts.cam.max_lines, 24)
    if args.lines:
        opts.cam.sigma_pix_line = 2.5

    sys_ = VioSystem(opts, device=args.device)
    sys_.set_calibration(cfg.intrinsics, cfg.cam_ext_q, cfg.cam_ext_p)
    if args.stereo:
        sys_.set_calibration(cfg.intrinsics, cfg.cam_ext_q,
                             np.asarray(cfg.cam_ext_p) + [-cfg.stereo_baseline, 0.0, 0.0], cam=1)
    if args.wheel:
        sys_.set_wheel_calibration(cfg.wheel_ext_q, cfg.wheel_ext_p,
                                   [cfg.wheel_rl, cfg.wheel_rr, cfg.wheel_base])
    if args.gps:
        sys_.set_gps_calibration(cfg.gps_ext_p)

    def quat(R):
        return lie.rot_2_quat(torch.as_tensor(np.asarray(R))).numpy()

    imu_t, imu_w, imu_a = sim.imu_stream()
    kin0 = sim.gt_kin(imu_t[0])
    sys_.initialize_from(float(imu_t[0]), quat(kin0["R_GtoI"]), kin0["p_IinG"],
                         kin0["v_IinG"], sim.bg_true[0], sim.ba_true[0])

    # the generator's draws in the JAX driver's order: every frame, then
    # the wheel samples, then the GPS fixes (identity world->ENU)
    cam_iter = iter([(float(t), sim.render_frame(t, with_lines=args.lines))
                     + ((sim.render_frame(t, with_lines=args.lines, cam=1),) if args.stereo
                        else ())
                     for t in sim.cam_times()])
    next_cam = next(cam_iter, None)
    wheel_iter = iter([(float(t),) + sim.wheel_sample(t) for t in sim.wheel_times()]
                      if args.wheel else [])
    next_wheel = next(wheel_iter, None)
    gps_iter = iter([(float(t), sim.gps_sample(t)) for t in sim.gps_times()]
                    if args.gps else [])
    next_gps = next(gps_iter, None)

    t_wall = time.time()
    for i in range(len(imu_t)):
        while next_gps is not None and next_gps[0] <= imu_t[i]:
            sys_.feed_gps_enu(*next_gps)
            next_gps = next(gps_iter, None)
        while next_wheel is not None and next_wheel[0] <= imu_t[i]:
            sys_.feed_wheel(*next_wheel)
            next_wheel = next(wheel_iter, None)
        while next_cam is not None and next_cam[0] <= imu_t[i]:
            sys_.feed_image(*next_cam)
            next_cam = next(cam_iter, None)
        sys_.feed_imu(imu_t[i], imu_w[i], imu_a[i])
    wall = time.time() - t_wall

    rmse = float("nan")
    have = len(sys_.traj) >= 3
    if have:
        t_e = np.asarray([t for t, _, _ in sys_.traj])
        p_e = np.asarray([p for _, _, p in sys_.traj])
        q_e = np.asarray([q for _, q, _ in sys_.traj])
        kins = [sim.gt_kin(t) for t in t_e]
        p_g = np.asarray([k["p_IinG"] for k in kins])
        q_g = np.asarray([quat(k["R_GtoI"]) for k in kins])
        res = ate(t_e, p_e, q_e, t_e, p_g, q_g, method="none")
        rmse = res["pos"]["rmse"]
        final_err = res["pos"]["max"]

    if args.out:
        with open(args.out, "w") as f:
            f.write("# timestamp tx ty tz qx qy qz qw\n")
            for t, q, p in sys_.traj:
                f.write(f"{t:.9f} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
                        f"{q[0]:.7f} {q[1]:.7f} {q[2]:.7f} {q[3]:.7f}\n")

    finite = math.isfinite(rmse)
    summary = {
        "frames": len(sys_.traj),
        "ate_rmse_m": round(rmse, 4) if finite else None,
        "max_err_m": round(float(final_err), 4) if have else None,
        "updates": sys_.stats["updates"],
        "accept_rate": round(
            sys_.stats["cam_accept"]
            / max(sys_.stats["cam_accept"] + sys_.stats["cam_reject"], 1), 3),
        "wall_s": round(wall, 2),
        "fps": round(len(sys_.traj) / wall, 1),
    }
    summary.update(sys_.final_report())
    if args.gps:
        summary["gps_initialized"] = bool(sys_.gps.initialized)
        summary["gps_fused_rows"] = sys_.stats["gps_fused"]
    dev = sys_.device
    summary["device"] = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(json.dumps(summary))
    return 0 if (finite and rmse < 5.0) else 1


if __name__ == "__main__":
    sys.exit(main())
