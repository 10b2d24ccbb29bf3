"""Simulation replay driver (port of plviwo_tpu/run_sim.py): the simulator's
IMU, camera, wheel and GPS streams through the port's `VioSystem` in time
order, one vehicle, then a TUM-format trajectory and a one-line JSON summary
(the JAX driver's keys, plus the device the run used).  Exit code 0 iff the
ATE is finite and under 5 m.

Without --images the camera stream is the simulator's data association
(tracked ids and pixels, `Simulator.cam_frame`) into the per-track path
(`feed_camera` / `feed_stereo`); with --images, rendered frames into the
images-in path (`feed_image`), or with --images --host-tracker into the
host KLT trackers (`update/tracker.py`; with --lines also the host line
tracker, `update/line_tracker.py`, fed the point tracker's ids and pixels)
and from them into the per-track path.  --tags paints 6 fiducial tags on
the ground, looks down with a nadir camera and merges the ArUco tracker's
corner features (`update/aruco_tracker.py`, ids from 10,000,000 up) after
the KLT ones; it implies --images --host-tracker.  --auto-init starts the
filter from the IMU(+wheel) initializer instead of the ground truth (the
ATE then aligns position and yaw); --imu-res interpolates the per-track
poses by continuous preintegration.  --record DIR writes the MINS-format
est/std/gt triplets, the trajectory and the frame timing
(`utils/recorder.py`, for `python -m plviwo_tpu_torch.eval nees DIR`);
--viz-dir DIR the tracking overlays and the PLY dumps (`utils/viz.py`).

Usage (on the card; `--device cpu` runs the same on the CPU):
    python -m plviwo_tpu_torch.run_sim --wheel --gps --out traj.txt
    python -m plviwo_tpu_torch.run_sim --stereo --dynamic --intr-order 3
    python -m plviwo_tpu_torch.run_sim --lines --wheel [--plc]
    python -m plviwo_tpu_torch.run_sim --images --lines --wheel --gps
    python -m plviwo_tpu_torch.run_sim --images --lines --wheel --dynamic --clone-freq 10
    python -m plviwo_tpu_torch.run_sim --images --host-tracker --stereo --wheel --gps
    python -m plviwo_tpu_torch.run_sim --images --host-tracker --lines --wheel [--plc]
    python -m plviwo_tpu_torch.run_sim --wheel --auto-init --imu-res
    python -m plviwo_tpu_torch.run_sim --tags --duration 8 --seed 2
    python -m plviwo_tpu_torch.run_sim --wheel --record out/ --viz-dir out/viz

Per-track-only options with --images but without --host-tracker exit 2
naming the ROADMAP queue that ported them for the per-track path.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

# options only the per-track path reads (JAX's feed_image path ignores them)
# -> the ROADMAP queue that ported them there
_TRACKS_ONLY = {"intr_order": "A9a", "calib": "A9a", "sequential_update": "A9a",
                "max_msckf": "A9a", "plc": "A9b", "imu_res": "A9c"}


def _parser():
    ap = argparse.ArgumentParser(description="PL-VIWO port: simulated VIO replay")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device; the run raises without a card unless it is 'cpu'")
    ap.add_argument("--duration", type=float, default=15.0, help="sim duration [s]")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--sigma-pix", type=float, default=0.5)
    ap.add_argument("--n-pts", type=float, default=45,
                    help="landmarks associated per frame (with --images: tracker slots, the "
                         "default 45 meaning 96)")
    ap.add_argument("--max-msckf", type=int, default=None,
                    help="MSCKF features per update (default 30)")
    ap.add_argument("--stereo", action="store_true",
                    help="stereo: shared-id left/right observations (with --images: a right "
                         "image per frame, L->R association)")
    ap.add_argument("--wheel", action="store_true", help="wheel-odometry fusion (VIWO)")
    ap.add_argument("--lines", action="store_true", help="line-feature fusion (PL)")
    ap.add_argument("--plc", action="store_true",
                    help="with --lines: point-line-coupled rows (per-track path only)")
    ap.add_argument("--gps", action="store_true",
                    help="GNSS fusion: host-side 4-DoF delayed init, then per-fix rows")
    ap.add_argument("--dynamic", action="store_true",
                    help="dynamic cloning: adaptive clone rate, interpolated-pose updates")
    ap.add_argument("--clone-freq", type=int, default=None,
                    help="max clone rate [Hz] (with --dynamic this caps the adaptive rate)")
    ap.add_argument("--intr-order", type=int, default=None,
                    help="polynomial interpolation order (1 = linear, 3 = cubic)")
    ap.add_argument("--images", action="store_true",
                    help="render frames and run the images-in frame instead of the "
                         "simulator's data association")
    ap.add_argument("--host-tracker", action="store_true",
                    help="with --images: the host KLT trackers feed the per-track path "
                         "instead of the images-in frame")
    ap.add_argument("--auto-init", action="store_true",
                    help="the IMU(+wheel) initializer instead of the ground-truth seed")
    ap.add_argument("--imu-res", action="store_true",
                    help="CPI-interpolated poses (use_imu_res) instead of the polynomial table "
                         "(per-track path)")
    ap.add_argument("--fused-f64", action="store_true",
                    help="with --images: the frame's camera tensors in f64 instead of f32")
    ap.add_argument("--max-obs", type=int, default=None,
                    help="with --images: observation-history depth per tracker slot")
    ap.add_argument("--perturb", type=float, default=0.0,
                    help="perturb the installed camera extrinsic position (m scale)")
    ap.add_argument("--calib", action="store_true",
                    help="estimate the camera extrinsics online (do_calib_ext)")
    ap.add_argument("--sequential-update", action="store_true",
                    help="per-sensor sequential EKF updates instead of one joint update a frame")
    ap.add_argument("--out", type=str, default=None, help="TUM trajectory output path")
    ap.add_argument("--tags", action="store_true",
                    help="ground fiducial tags and the ArUco tracker's corner feed (implies "
                         "--images --host-tracker; nadir camera)")
    ap.add_argument("--viz-dir", type=str, default=None,
                    help="write tracking overlays and 3-D feature/line dumps (PLY) here")
    ap.add_argument("--record", type=str, default=None,
                    help="directory for MINS-format est/std/gt triplets and timing")
    return ap


def _refusals(args):
    if not args.images or args.host_tracker:
        return []
    return [f"--{f.replace('_', '-')} with --images: the images-in path does not read it "
            f"(ROADMAP {q} ported it for the per-track path: run without --images or with "
            "--host-tracker)"
            for f, q in sorted(_TRACKS_ONLY.items()) if getattr(args, f) not in (False, None)]


def main(argv=None):
    args = _parser().parse_args(argv)
    if args.tags:
        args.images = args.host_tracker = True
    what = _refusals(args)
    if what:
        print("run_sim: refused: " + "; ".join(what), file=sys.stderr)
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
    if args.tags:
        # ground fiducials and a nadir camera (the TrackAruco scenario: tags
        # on the ground seen from above, in-plane rotation from the yaw)
        cfg.n_tags = 6
        cfg.cam_ext_q = (1.0, 0.0, 0.0, 0.0)
        cfg.cam_ext_p = (0.0, 0.0, 0.0)
    sim = Simulator(cfg)

    opts = EstimatorOptions()
    opts.joint_update = not args.sequential_update
    opts.dynamic_cloning = args.dynamic
    opts.use_imu_res = args.imu_res
    if args.clone_freq is not None:
        opts.clone_freq = args.clone_freq
    if args.intr_order is not None:
        opts.intr_order = args.intr_order
    if args.calib:
        opts.cam.do_calib_ext = True
        opts.cam.init_cov_ext_or = 0.02
        opts.cam.init_cov_ext_pos = max(0.05, 2.0 * args.perturb)
    opts.cam.max_msckf = 30 if args.max_msckf is None else args.max_msckf
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
        opts.cam.use_plc = args.plc
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
    tracked = args.images and args.host_tracker
    if tracked:
        # the host trackers' settings
        opts.cam.sigma_pix = max(opts.cam.sigma_pix, 1.5)
        opts.cam.chi2_mult = 8.0
        if args.lines:
            opts.cam.sigma_pix_line = 2.5
    elif args.images:
        # the images-in frame's settings
        if args.fused_f64:
            opts.cam.fused_dtype = "f64"
        if args.max_obs is not None:
            opts.cam.fused_max_obs = args.max_obs
        opts.cam.sigma_pix = max(opts.cam.sigma_pix, 1.5)
        opts.cam.chi2_mult = 8.0
        opts.cam.n_pts = int(args.n_pts) if args.n_pts != 45 else 96
        opts.cam.max_lines = min(opts.cam.max_lines, 24)
        if args.lines:
            opts.cam.sigma_pix_line = 2.5

    sys_ = VioSystem(opts, device=args.device)
    cam_p_used = np.asarray(cfg.cam_ext_p, dtype=float)
    if args.perturb > 0:
        cam_p_used = cam_p_used + np.random.default_rng(args.seed + 1).normal(0, args.perturb, 3)
    sys_.set_calibration(cfg.intrinsics, cfg.cam_ext_q, cam_p_used)
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
    if not args.auto_init:
        kin0 = sim.gt_kin(imu_t[0])
        sys_.initialize_from(float(imu_t[0]), quat(kin0["R_GtoI"]), kin0["p_IinG"],
                             kin0["v_IinG"], sim.bg_true[0], sim.ba_true[0])

    # the generator's draws in the JAX driver's order: every frame, then
    # the wheel samples, then the GPS fixes (identity world->ENU)
    if args.images:
        cam_kind = "tracked" if tracked else "image"
        cams = [(float(t), sim.render_frame(t, with_lines=args.lines))
                + ((sim.render_frame(t, with_lines=args.lines, cam=1),) if args.stereo else ())
                for t in sim.cam_times()]
    else:
        cam_kind = "stereo" if args.stereo else "camera"
        cams = [(float(t),) + sim.cam_frame(t, cam=0)
                + (sim.cam_frame(t, cam=1) if args.stereo else ())
                + (sim.line_frame(t) if args.lines else ())
                for t in sim.cam_times()]
    streams = [("gps", [(float(t), sim.gps_sample(t)) for t in sim.gps_times()]
                if args.gps else []),
               ("wheel", [(float(t),) + sim.wheel_sample(t) for t in sim.wheel_times()]
                if args.wheel else []),
               (cam_kind, cams)]
    feeds = {"gps": sys_.feed_gps_enu, "wheel": sys_.feed_wheel, "image": sys_.feed_image,
             "camera": sys_.feed_camera, "stereo": sys_.feed_stereo}
    if tracked:
        from .examples import feed_tracked
        from .update.line_tracker import LineTracker
        from .update.tracker import KltTracker, StereoKltTracker

        tracker = (StereoKltTracker if args.stereo else KltTracker)(
            n_pts=80, cam_k=np.asarray(cfg.intrinsics), grid_x=12, grid_y=10, device=args.device)
        ltracker = (LineTracker(max_lines=opts.cam.max_lines, min_length=30.0, device=args.device)
                    if args.lines else None)
        atracker = None
        if args.tags:
            from .update.aruco_tracker import ArucoTracker

            atracker = ArucoTracker(max_tag_id=16, device=args.device)
        feeds["tracked"] = lambda *a: feed_tracked(sys_, tracker, "frame", a, ltracker, atracker)
    recorder = None
    if args.record:
        from .utils.recorder import StateRecorder

        recorder = StateRecorder(args.record)
    if args.viz_dir:
        from .utils.viz import VizRecorder

        sys_.viz = VizRecorder(args.viz_dir)
    nxt = [0] * len(streams)

    t_wall = time.time()
    for i in range(len(imu_t)):
        for k, (kind, items) in enumerate(streams):
            while nxt[k] < len(items) and items[nxt[k]][0] <= imu_t[i]:
                feeds[kind](*items[nxt[k]])
                nxt[k] += 1
        n0 = len(sys_.traj)
        sys_.feed_imu(imu_t[i], imu_w[i], imu_a[i])
        if recorder is not None and len(sys_.traj) > n0:
            t_now = sys_._time
            kin = sim.gt_kin(t_now)
            j = min(int(np.searchsorted(imu_t, t_now)), len(imu_t) - 1)
            recorder.record(sys_, gt={"q": quat(kin["R_GtoI"]), "p": kin["p_IinG"],
                                      "v": kin["v_IinG"], "bg": sim.bg_true[j],
                                      "ba": sim.ba_true[j]})
            if sys_.frame_timing:
                recorder.record_timing(t_now, sys_.frame_timing)
    wall = time.time() - t_wall
    if recorder is not None:
        recorder.save()
    if sys_.viz is not None:
        sys_.viz.save()

    rmse = float("nan")
    have = len(sys_.traj) >= 3
    if have:
        t_e = np.asarray([t for t, _, _ in sys_.traj])
        p_e = np.asarray([p for _, _, p in sys_.traj])
        q_e = np.asarray([q for _, q, _ in sys_.traj])
        kins = [sim.gt_kin(t) for t in t_e]
        p_g = np.asarray([k["p_IinG"] for k in kins])
        q_g = np.asarray([quat(k["R_GtoI"]) for k in kins])
        res = ate(t_e, p_e, q_e, t_e, p_g, q_g, method="posyaw" if args.auto_init else "none")
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
    if args.calib:
        lo = sys_.layout
        e = lo.cam_ext(0) + 3
        st = sys_.state
        ext_err = float(np.linalg.norm(st.cam_p[0, 0].cpu().numpy() - np.asarray(cfg.cam_ext_p)))
        ext_std = float(np.sqrt(np.trace(st.cov[0, e:e + 3, e:e + 3].cpu().numpy())))
        summary["cam_ext_err_m"] = round(ext_err, 4)
        summary["cam_ext_err0_m"] = round(
            float(np.linalg.norm(cam_p_used - np.asarray(cfg.cam_ext_p))), 4)
        summary["cam_ext_3sigma_m"] = round(3 * ext_std, 4)
    dev = sys_.device
    summary["device"] = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(json.dumps(summary))
    return 0 if (finite and rmse < 5.0) else 1


if __name__ == "__main__":
    sys.exit(main())
