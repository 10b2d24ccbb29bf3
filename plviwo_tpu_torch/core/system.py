"""The live driver (port of plviwo_tpu/core/system.py: the images-in subset).

`VioSystem` holds one vehicle (the batch-first state at B = 1) and is fed
sensor by sensor: `feed_imu`, `feed_wheel`, `feed_gps` / `feed_gps_enu` and
`feed_image`.  Host work is buffer assembly: padded IMU, wheel and GPS
windows are selected from the host buffers (`ImuBuffer`, `WheelBuffer`,
numpy), then each frame runs `core/frame.fused_frame` as one device step
(tracking, propagation, clone, point/line/wheel/GPS rows, one joint EKF
update; both hand kernels on the card) with no host sync inside it, and
ONE host transfer brings back the frame's metrics and pose.  Between frames
the host-side `GpsUpdater` marks keyframes and runs the 4-DoF world->ENU
initialization; after it, the fixes ride the frame's joint update.

A right image (`feed_image(t, img, img_r)` with two cameras calibrated)
runs the frame's stereo path.  With `opts.dynamic_cloning` the host rate
policy (`core/dynamic_cloning.py`) decides per frame whether a clone lands:
frames between clones still track, and their point rows update poses
interpolated between clones with the pixel noise inflated by the
interpolation error; the wheel window then runs clone to clone.

Not ported, and refused with NotImplementedError rather than skipped:
`feed_camera` / `feed_stereo` (the per-track path with its feature
databases), the IMU(+wheel) auto-initialization, ZUPT and the native
feature store (ROADMAP A9).  Callers seed the state with `initialize_from`.
"""

from __future__ import annotations

import logging
import time
from collections import deque

import numpy as np
import torch

from ..config.options import EstimatorOptions
from ..ops import cam as cam_ops
from ..ops.chi2 import _TABLE as CHI2_TABLE
from ..update import gps as gps_up
from ..update import wheel as wheel_up
from ..utils.timing import TimeChecker
from . import dynamic_cloning as dynclone
from . import propagator
from .frame import fused_frame, make_track_state
from .layout import StateLayout
from .state import CUDA, FilterState, checked_device, make_state, newest_clone_slot

F32 = torch.float32
F64 = torch.float64
IMU_PAD = 64  # max IMU samples per propagate call
WHEEL_PAD = 32  # wheel samples per frame window (64 clone to clone, dynamic cloning)
GPS_PAD = 4  # GPS fixes per frame
# landmark error-state representations (the JAX package's cam_helper.REP_CODES)
REP_CODES = {"GLOBAL_3D": 0, "GLOBAL_FULL_INVERSE_DEPTH": 1}
# per-frame metrics read back to the host, in this order, then time, q, p
_METRICS = ("accepted", "harvested", "lines_accepted", "line_harvested", "wheel_accepted",
            "gps_accepted")

log = logging.getLogger(__name__)


class VioSystem:
    def __init__(self, opts: EstimatorOptions | None = None, device=CUDA):
        self.opts = opts or EstimatorOptions()
        op = self.opts
        if op.zupt.enabled:
            raise NotImplementedError("zero-velocity updates (opts.zupt) are not ported yet "
                                      "(ROADMAP A9)")
        if not op.cam.fused_lk_conv:
            raise NotImplementedError("the gather LK (cam.fused_lk_conv=False) is a TPU "
                                      "variant the port does not carry (ROADMAP A, Not ported)")
        self.device = checked_device(device)
        self.layout = StateLayout(
            n_clones=op.max_clones,
            n_cams=op.cam.max_n,
            max_slam=op.cam.max_slam,
            use_wheel=op.wheel.enabled,
            n_gps=op.gps.max_n if op.gps.enabled else 0,
        )
        self.state: FilterState = make_state(self.layout, device=self.device)
        self._time = -np.inf  # host copy of state.time
        self.initialized = False
        self.imu_buf = propagator.ImuBuffer()
        self._pending_images: deque = deque()
        self.gravity = torch.tensor([0.0, 0.0, op.gravity_mag], dtype=F64, device=self.device)
        self.sigmas = (op.imu.sigma_w, op.imu.sigma_a, op.imu.sigma_wb, op.imu.sigma_ab)
        self.distortion_model = cam_ops.RADTAN
        self.feat_rep = REP_CODES.get(op.cam.feat_rep, 0)
        self.wheel_buf = wheel_up.WheelBuffer()
        self.tc = TimeChecker()
        self.frame_timing = {}  # ms of the latest frame: device step, host work, GPS
        self.wheel_type = wheel_up.TYPE_CODES.get(op.wheel.type, wheel_up.W3D_ANG)
        self._last_frame_t = None
        self._fx = 1.0  # camera 0's fx, as set_calibration installs it
        # dynamic cloning: the next clone time, the rate chosen and the IMU's
        # acceleration at the last clone, and that clone's time
        self._next_clone_t = None
        self._clone_hz = 10.0
        self._cur_accel = 0.0
        self._last_clone_t = None
        self.track_state = None
        self.gps = (gps_up.GpsUpdater(op.gps, self.layout, CHI2_TABLE)
                    if op.gps.enabled else None)
        self._last_kf_pos = None
        self.stats = {"cam_accept": 0, "cam_reject": 0, "clones": 0, "updates": 0,
                      "wheel_accept": 0, "wheel_reject": 0,
                      "line_accept": 0, "line_reject": 0, "lost_marg_obs": 0,
                      "gps_fused": 0}
        self.traj: list = []  # (t, q_GtoI, p_IinG) at clone times

    # ------------------------------------------------------------------
    # configuration helpers
    # ------------------------------------------------------------------
    def _tensor(self, x):
        return torch.tensor(np.asarray(x, dtype=np.float64), device=self.device)

    def _set_at(self, name, index, value):
        """Copy of state field `name` with [:, index] set to value."""
        x = getattr(self.state, name).clone()
        x[:, index] = self._tensor(value)
        return x

    def set_calibration(self, cam_k, cam_q, cam_p, cam_dt=0.0, cam: int = 0):
        """Install camera calibration means into the state (per camera)."""
        if cam == 0:
            self._fx = float(cam_k[0])
        self.state = self.state.replace(
            cam_k=self._set_at("cam_k", cam, cam_k), cam_q=self._set_at("cam_q", cam, cam_q),
            cam_p=self._set_at("cam_p", cam, cam_p), cam_dt=self._set_at("cam_dt", cam, cam_dt))

    def set_wheel_calibration(self, wheel_q, wheel_p, intrinsics, dt=0.0):
        t = self._tensor
        self.state = self.state.replace(
            wheel_q=t(wheel_q)[None], wheel_p=t(wheel_p)[None], wheel_k=t(intrinsics)[None],
            wheel_dt=t(dt)[None])

    def set_gps_calibration(self, ext_p):
        """Install the antenna position in the IMU frame (the JAX driver
        writes the state's `gps_p` directly)."""
        self.state = self.state.replace(gps_p=self._set_at("gps_p", 0, ext_p))

    def initialize_from(self, t, q_GtoI, p, v, bg, ba):
        """Seed the state (ground-truth init path, Initializer.cpp:170-220)."""
        op = self.opts.imu
        oc = self.opts.cam
        priors = {
            "imu_th": op.init_cov_ori, "imu_p": op.init_cov_pos,
            "imu_v": op.init_cov_vel, "imu_bg": op.init_cov_dbg,
            "imu_ba": op.init_cov_dba,
        }
        # online-calibration priors: only estimated blocks get nonzero
        # covariance (reference: State ctor calib priors, State.cpp:215-269)
        if oc.do_calib_dt:
            priors["cam_dt"] = oc.init_cov_dt
        if oc.do_calib_ext:
            priors["cam_ext"] = max(oc.init_cov_ext_or, oc.init_cov_ext_pos)
        if oc.do_calib_int:
            priors["cam_int"] = max(oc.init_cov_in_k, oc.init_cov_in_c)
        ow = self.opts.wheel
        if ow.enabled and ow.do_calib_dt:
            priors["wheel_dt"] = ow.init_cov_dt
        if ow.enabled and ow.do_calib_ext:
            priors["wheel_ext"] = max(ow.init_cov_ext_or, ow.init_cov_ext_pos)
        if ow.enabled and ow.do_calib_int:
            priors["wheel_int"] = max(ow.init_cov_in_r, ow.init_cov_in_b)
        st = make_state(self.layout, priors=priors, device=self.device)
        d = self._tensor
        q, p, v, bg, ba = (d(x)[None] for x in (q_GtoI, p, v, bg, ba))
        old = self.state
        # carry over every installed calibration mean
        calib = {n: getattr(old, n) for n in ("cam_k", "cam_q", "cam_p", "cam_dt", "wheel_q",
                                              "wheel_p", "wheel_k", "wheel_dt", "gps_p", "gps_dt")}
        self.state = st.replace(time=d(t)[None], q=q, p=p, v=v, bg=bg, ba=ba, q_fej=q, p_fej=p,
                                v_fej=v, bg_fej=bg, ba_fej=ba, **calib)
        self._time = float(t)
        self.initialized = True

    # ------------------------------------------------------------------
    # sensor feeds
    # ------------------------------------------------------------------
    def feed_imu(self, t, w, a):
        self.imu_buf.feed(t, w, a)
        if not self.initialized:
            self._try_init()
        if self._pending_images:
            self._process_pending_images()

    def feed_camera(self, *args, **kwargs):
        raise NotImplementedError("feed_camera (tracked features into the per-track path) "
                                  "is not ported yet (ROADMAP A9); use feed_image")

    def feed_stereo(self, *args, **kwargs):
        raise NotImplementedError("feed_stereo (the per-track stereo path) is not ported "
                                  "yet (ROADMAP A9)")

    def feed_image(self, t, img, img_r=None):
        """One RAW camera frame (H, W) in [0, 1], and with img_r the right
        camera's: the images-in live path.  Each frame is processed, once
        the IMU covers it, as one `fused_frame` on the device (see the
        module docstring); the right image is used where the layout has two
        cameras."""
        def dev(x):
            return torch.as_tensor(np.asarray(x, dtype=np.float32), device=self.device)

        self._pending_images.append((float(t), dev(img),
                                     None if img_r is None else dev(img_r)))
        if self.initialized:
            self._process_pending_images()

    def _process_pending_images(self):
        op = self.opts
        while self._pending_images:
            t, img, img_r = self._pending_images[0]
            if t <= self._time:
                self._pending_images.popleft()
                continue
            if self.imu_buf.newest < t:
                return  # wait for IMU coverage
            self._pending_images.popleft()
            t_host0 = time.perf_counter()
            if self.track_state is None:
                H, W = img.shape[:2]
                n_slots = max(op.cam.n_pts, 32)
                self.track_state = make_track_state(
                    H, W, n_pts=n_slots, max_lines=max(op.cam.max_lines, 8),
                    max_obs=max(op.cam.fused_max_obs, 4), device=self.device)
                # detection grid must offer >= one cell per slot (the fused
                # detector takes the best corner per cell)
                gx = max(op.cam.grid_x, int(np.ceil(np.sqrt(n_slots * W / H))))
                gy = max(op.cam.grid_y, int(np.ceil(n_slots / gx)))
                self._fused_grid = (gx, gy)
            sel = self.imu_buf.select(self._time, t, pad_to=IMU_PAD)
            if sel is None:
                sel = self.imu_buf.select(self._time, t, pad_to=IMU_PAD * 4)
            if sel is None:
                # IMU gap (e.g. right after init): bridge with the chunked
                # propagator, then land the frame on the covered remainder
                self._propagate_to(t - 0.005)
                sel = self.imu_buf.select(self._time, t, pad_to=IMU_PAD)
                if sel is None:
                    continue  # unservable frame
            it, iw, ia = (self._tensor(x)[None] for x in sel)
            use_dyn = bool(op.dynamic_cloning)
            do_clone, sigma_pix = True, max(op.cam.sigma_pix, 1e-3)
            if use_dyn:
                do_clone, sigma_pix = self._clone_policy(t, sigma_pix)
            # wheel window spans [newest existing clone, t] = fused_frame's
            # preintegration interval (slot0 -> the new clone); with dynamic
            # cloning it runs clone to clone, on clone frames only
            wheel_pad = 2 * WHEEL_PAD if use_dyn else WHEEL_PAD
            w_t0 = self._last_clone_t if use_dyn else self._last_frame_t
            wsel = None
            if op.wheel.enabled and w_t0 is not None and do_clone:
                wsel = self.wheel_buf.select(w_t0, t, pad_to=wheel_pad)
            if wsel is not None:
                wt, wm1, wm2 = (self._tensor(x)[None] for x in wsel)
            else:
                wt = self._tensor(np.full(wheel_pad, t))[None]
                wm1 = wm2 = torch.zeros((1, wheel_pad), dtype=F64, device=self.device)
            wvalid = torch.tensor([wsel is not None], device=self.device)
            # GPS rows ride the joint update once the 4-DoF ENU init has
            # completed: pending fixes covered by this frame are consumed here
            use_gps_fused = self.gps is not None and self.gps.initialized
            gt = np.full((GPS_PAD,), t, dtype=np.float64)
            gp = np.zeros((GPS_PAD, 3))
            gv = np.zeros((GPS_PAD,), dtype=bool)
            if use_gps_fused and self.gps.pending:
                pend = self.gps.pending
                # a fix is consumable once a clone at/after it exists
                t_cov = t if do_clone or self._last_clone_t is None else self._last_clone_t
                take_idx = [i for i, f in enumerate(pend) if f[0] <= t_cov][:GPS_PAD]
                self.gps.pending = [f for i, f in enumerate(pend) if i not in take_idx]
                for j, i in enumerate(take_idx):
                    gt[j] = pend[i][0]
                    gp[j] = pend[i][1]
                    gv[j] = True
            tc = self.tc
            tc.ding("frame")
            self.state, self.track_state, m = fused_frame(
                self.state, self.track_state, img[None],
                it, iw, ia, self._tensor([t]), wt, wm1, wm2, wvalid,
                self.gravity, self.sigmas,
                sigma_pix, op.cam.chi2_mult,
                op.cam.sigma_pix_line, (op.wheel.noise_w, op.wheel.noise_v, op.wheel.noise_p),
                model=self.distortion_model, window_size=op.window_size,
                cam_dtype=F64 if op.cam.fused_dtype == "f64" else F32,
                wheel_type=self.wheel_type,
                min_track=max(op.cam.min_track_length, 3),
                grid_x=self._fused_grid[0], grid_y=self._fused_grid[1],
                min_px_dist=op.cam.min_px_dist,
                use_wheel=op.wheel.enabled, use_lines=op.cam.use_lines,
                use_gps=use_gps_fused, gps_t=self._tensor(gt)[None],
                gps_p=self._tensor(gp)[None],
                gps_valid=torch.as_tensor(gv, device=self.device)[None],
                sigma_gps=op.gps.noise if self.gps is not None else 3.0,
                gps_chi2_mult=op.gps.chi2_mult if self.gps is not None else 1.0,
                use_dynamic=use_dyn,
                do_clone=torch.tensor([do_clone], device=self.device) if use_dyn else None,
                use_stereo=img_r is not None and self.layout.n_cams >= 2,
                img_r=None if img_r is None else img_r[None])
            # ONE host transfer: the frame's metrics, time and pose
            st = self.state
            host = torch.cat([m[k].to(F64) for k in _METRICS]
                             + [st.time, st.q[0], st.p[0]]).cpu().numpy()
            ms_frame = 1e3 * tc.dong("frame")
            acc, harv, lacc, lharv, wacc, gacc = (int(x) for x in host[:len(_METRICS)])
            self._time = float(host[len(_METRICS)])
            self.stats["cam_accept"] += acc
            self.stats["cam_reject"] += max(harv - acc, 0)
            self.stats["line_accept"] += lacc
            self.stats["line_reject"] += max(lharv - lacc, 0)
            self.stats["gps_fused"] += gacc
            self.stats["wheel_accept"] += wacc
            if wsel is not None and not wacc:
                self.stats["wheel_reject"] += 1
            if do_clone:
                self.stats["clones"] += 1
                self._last_clone_t = t
            self.stats["updates"] += 1
            self._last_frame_t = t
            q, p = host[len(_METRICS) + 1:len(_METRICS) + 5], host[len(_METRICS) + 5:]
            self._record_pose(self._time, q, p)
            ms_gps = 0.0
            if self.gps is not None:
                t_gps = time.perf_counter()
                was_init = self.gps.initialized
                self.gps.try_process(self)
                if self.gps.initialized and not was_init:
                    self.state = self.state.replace(
                        clone_keyframe=torch.zeros_like(self.state.clone_keyframe))
                ms_gps = 1e3 * (time.perf_counter() - t_gps)
            self.imu_buf.prune(t - op.window_size - 0.5)
            if op.wheel.enabled:
                self.wheel_buf.prune(t - op.window_size - 0.5)
            host_ms = 1e3 * (time.perf_counter() - t_host0) - ms_frame
            self.frame_timing = {"frame": ms_frame, "host": host_ms, "gps": ms_gps}

    def _clone_policy(self, t, sigma_pix):
        """Dynamic cloning's host rate policy for a frame at t: whether a
        clone lands here (the first frame, then once the rate chosen at the
        last clone has elapsed; at a clone the rate is chosen anew from the
        IMU's recent accelerations, at most opts.clone_freq), and the pixel
        noise inflated by the interpolation error at the current rate.
        Returns (do_clone, sigma_pix_eff)."""
        op = self.opts
        do_clone = self._next_clone_t is None or t >= self._next_clone_t - 1e-9
        if do_clone:
            b = self.imu_buf
            ang_acc, lin_acc = dynclone.estimate_accelerations(b.t, b.w, b.a,
                                                               gravity_mag=op.gravity_mag)
            hz = dynclone.select_clone_rate(ang_acc, lin_acc, order=1, max_hz=float(op.clone_freq))
            self._cur_accel = ang_acc + lin_acc
            self._next_clone_t = t + 1.0 / hz - 1e-6
            self._clone_hz = hz
        interp_std = dynclone.interp_noise_std(self._cur_accel, self._clone_hz, 1)
        return do_clone, float(np.sqrt(sigma_pix**2 + (self._fx * interp_std) ** 2))

    def feed_gps(self, t, lat, lon, alt):
        """One geodetic GNSS fix (reference: feed_measurement_gps,
        SystemManager.cpp:139-170 — datum at first fix, ENU conversion)."""
        if self.gps is None:
            return
        self.gps.feed_geodetic(t, lat, lon, alt)
        self._gps_keyframe()

    def feed_gps_enu(self, t, p_enu):
        """One GNSS fix already in a local ENU frame (simulation path)."""
        if self.gps is None:
            return
        self.gps.feed_enu(t, p_enu)
        self._gps_keyframe()

    def _gps_keyframe(self):
        """Pre-init keyframe marking: pin the newest clone so it survives
        marginalization until 4-DoF alignment completes (reference:
        add_keyframes, UpdaterGPS.cpp:29-58)."""
        if self.gps.initialized or not self.initialized:
            return
        st = self.state
        valid = st.clone_valid[0].cpu().numpy()
        if not valid.any() or int(st.clone_keyframe[0].sum()) >= 5:
            return
        slot = int(newest_clone_slot(st)[0])
        pos = st.clone_p[0, slot].cpu().numpy()
        if (
            self._last_kf_pos is None
            or np.linalg.norm(pos - self._last_kf_pos)
            >= self.opts.gps.keyframe_min_distance
        ):
            kf = st.clone_keyframe.clone()
            kf[0, slot] = True
            self.state = st.replace(clone_keyframe=kf)
            self._last_kf_pos = pos

    def feed_wheel(self, t, m1, m2):
        """One wheel sample: (m1, m2) = (left, right) rates/velocities, or
        (omega, v) for the *Cen types (reference: WheelData.m1/m2)."""
        self.wheel_buf.feed(t, m1, m2)

    # ------------------------------------------------------------------
    # initialization and propagation
    # ------------------------------------------------------------------
    def _try_init(self):
        raise NotImplementedError(
            "auto-initialization (init/static_imu.py, init/imu_wheel.py) is not ported yet "
            "(ROADMAP A9): seed the state with initialize_from before feeding the IMU")

    def _propagate_to(self, t_target):
        t0 = self._time
        while t0 < t_target - 1e-9:
            t1 = min(t_target, t0 + (IMU_PAD - 4) / 100.0)  # chunk long gaps
            sel = self.imu_buf.select(t0, t1, pad_to=IMU_PAD)
            if sel is None:
                sel = self.imu_buf.select(t0, t1, pad_to=IMU_PAD * 4)
                if sel is None:
                    raise RuntimeError(f"IMU gap: cannot propagate {t0}->{t1}")
            t_arr, w_arr, a_arr = (self._tensor(x)[None] for x in sel)
            self.state = propagator.propagate(self.state, t_arr, w_arr, a_arr,
                                              self._tensor([t1]), self.gravity, self.sigmas)
            t0 = self._time = t1

    def _record_pose(self, t, q, p):
        self.traj.append((float(t), np.array(q), np.array(p)))

    # ------------------------------------------------------------------
    # telemetry (reference: SystemManager::print_status/print_final_report,
    # SystemManager.cpp:314-522)
    # ------------------------------------------------------------------
    def print_status(self):
        st = self.state
        p = st.p[0].cpu().numpy()
        n_clones = int(st.clone_valid.sum())
        n_slam = int(st.slam_valid.sum())
        log.info(f"t={self._time:.2f} p=[{p[0]:.2f} {p[1]:.2f} {p[2]:.2f}] "
                 f"clones={n_clones} slam={n_slam} stats={self.stats}")

    def final_report(self) -> dict:
        """End-of-run summary (distance traveled, per-sensor accept rates)."""
        ps = np.asarray([p for _, _, p in self.traj])
        dist = float(np.sum(np.linalg.norm(np.diff(ps, axis=0), axis=1))) \
            if len(ps) > 1 else 0.0

        def rate(a, r):
            return round(a / max(a + r, 1), 3)
        out = {
            "distance_m": round(dist, 2),
            "clones": self.stats["clones"],
            "updates": self.stats["updates"],
            "cam_accept_rate": rate(self.stats["cam_accept"], self.stats["cam_reject"]),
            "line_accept_rate": rate(self.stats["line_accept"], self.stats["line_reject"]),
            "wheel_accept_rate": rate(self.stats["wheel_accept"], self.stats["wheel_reject"]),
        }
        if self.gps is not None:
            out["gps"] = dict(self.gps.stats)
        return out
