"""The live driver (port of plviwo_tpu/core/system.py).

`VioSystem` holds one vehicle (the batch-first state at B = 1) and is fed
sensor by sensor: `feed_imu`, `feed_wheel`, `feed_gps` / `feed_gps_enu`, and
camera frames through one of two paths: raw images (`feed_image`, the
images-in path below) or tracked features (`feed_camera` / `feed_stereo`,
the per-track path further down).  A system runs one of the two.

The images-in path.  Host work is buffer assembly: padded IMU, wheel and GPS
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

The per-track path.  Each frame's tracked ids and pixels (a tracker's, or
the simulator's data association) are undistorted on the host and appended
to the feature database (`update/feature_db.py`); tracked line segments go
to the line database with each segment's vanishing-point class from the
orientation at feed time.  Once the IMU covers a frame, `_process_pending`
propagates, marginalizes the clones leaving the window (harvesting the point
and line tracks that still observe them first), clones, and updates: the
MSCKF rows of the tracks that were lost or observe a clone about to leave,
at poses interpolated over the clones by the polynomial of order
`intr_order` (`core/interp.build_interp_table`); the in-state SLAM landmarks
(`cam.max_slam > 0`, xyz or inverse depth: their own gated update, then the
delayed init of new ones); the line rows of the line tracks that were lost
or observe a clone about to leave (triangulated along their majority
vanishing-point axis, with point-line-coupled rows under `cam.use_plc`);
and the wheel rows of each new clone pair, all summed into one joint EKF
update a frame (or one update per sensor with `joint_update=False`); then
the GPS fixes the clones cover.  With `opts.dynamic_cloning`, frames between
clones are skipped: their observations stay in the database and update
later through interpolated poses, at the order the rate policy picks.  The
host keeps mirrors of the clone ring's times, validity and keyframe flags
and of the SLAM slots' ids and validity, so the bookkeeping reads no device
state; the device is read where the JAX driver must read it too (the
accepted-feature and accepted-line counts, the orientation a line frame is
classified at, the SLAM chi^2 vector and each new landmark's triangulation
and correction, each wheel pair's chi^2, the recorded pose, the calibration
estimates when they are estimated online).

With `opts.use_imu_res` the per-track poses between clones come from
continuous preintegration of the IMU from the clone at or before each time
(`core/interp.build_cpi_table`) instead of the polynomial.  With
`opts.zupt.enabled` a stationary IMU window (tested on the host on every
sample, against a host mirror of the gyro bias) adds a zero-velocity
update between frames (`update/zupt.py`).

Until `initialize_from` seeds the state, every IMU sample tries the
auto-initialization on the host buffers: the IMU+wheel initializer
(`init/imu_wheel.py`, with the wheel) or the static IMU one
(`init/static_imu.py`); the camera frames from before its time are dropped.
The tracked features of `feed_camera` come from the caller: the simulator's
data association, or the host KLT trackers of `update/tracker.py` (with
lines the host line tracker of `update/line_tracker.py`).

The feature store.  Tracks live in the Python `FeatureDatabase`, which the
SLAM and line bookkeeping read track by track; where the native library
builds (`native.py`) a C++ store mirrors the camera-0 observations, and the
mono MSCKF candidates are exported from it in one call, as the JAX driver
does (SLAM-owned tracks then take candidate places and are masked out).
Stereo bypasses it.  `feature_store` and the final report name the store
the candidates came from.

`viz` (a `utils/viz.VizRecorder`, None by default) takes, at the JAX
driver's four places, the images-in frame's tracking overlay, the SLAM
points at each recorded pose, the accepted lines' display endpoints and the
accepted MSCKF points; each hook reads the device (once) only when `viz`
is set.  `print_status` logs through `utils/logging`.
"""

from __future__ import annotations

import contextlib
import time
from collections import deque

import numpy as np
import torch

from .. import native
from ..config.options import EstimatorOptions
from ..init.imu_wheel import IwInitializer
from ..init.static_imu import try_static_init
from ..ops import cam as cam_ops
from ..ops import lie
from ..ops.chi2 import _TABLE as CHI2_TABLE
from ..update import cam_helper
from ..update import gps as gps_up
from ..update import lines as line_up
from ..update import wheel as wheel_up
from ..update.feature_db import FeatureDatabase, LineDatabase
from ..update.zupt import ZuptUpdater
from ..utils import logging as vlog
from ..utils.timing import span
from ..utils.viz import line_display_endpoints
from . import dynamic_cloning as dynclone
from . import ekf, propagator
from .frame import fused_frame, make_track_state
from .interp import build_cpi_table, build_interp_table
from .layout import StateLayout
from .state import CUDA, FilterState, checked_device, make_state, newest_clone_slot

F32 = torch.float32
F64 = torch.float64
IMU_PAD = 64  # max IMU samples per propagate call
CPI_PAD = 64  # IMU samples per CPI window (use_imu_res)
WHEEL_PAD = 32  # wheel samples per frame window (64 clone to clone, dynamic cloning)
GPS_PAD = 4  # GPS fixes per frame
# per-frame metrics read back to the host, in this order, then time, q, p and bg
_METRICS = ("accepted", "harvested", "lines_accepted", "line_harvested", "wheel_accepted",
            "gps_accepted")


@contextlib.contextmanager
def _stage(timing: dict, key: str, name: str):
    """The span `name` (`utils.timing.span`), with its host milliseconds in
    timing[key] whether or not a profiler records the span."""
    t0 = time.perf_counter()
    with span(name):
        yield
    timing[key] = 1e3 * (time.perf_counter() - t0)


class VioSystem:
    def __init__(self, opts: EstimatorOptions | None = None, device=CUDA):
        self.opts = opts or EstimatorOptions()
        op = self.opts
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
        # host copy of state.bg for the stationarity test; None when an update
        # since the last read may have moved it
        self._bg = np.zeros(3)
        self.initialized = False
        self.imu_buf = propagator.ImuBuffer()
        self._pending_images: deque = deque()
        self.gravity = torch.tensor([0.0, 0.0, op.gravity_mag], dtype=F64, device=self.device)
        self.sigmas = (op.imu.sigma_w, op.imu.sigma_a, op.imu.sigma_wb, op.imu.sigma_ab)
        self.distortion_model = cam_ops.RADTAN
        # landmark error-state representation (reference feat_rep option,
        # CamHelper.cpp:21-56): GLOBAL_3D or GLOBAL_FULL_INVERSE_DEPTH
        self.feat_rep = cam_helper.REP_CODES.get(op.cam.feat_rep, 0)
        self.wheel_buf = wheel_up.WheelBuffer()
        # host ms of the latest frame's stages, taken at its spans' boundaries
        self.frame_timing = {}
        # optional utils.viz.VizRecorder: overlays and 3-D dumps; the device is
        # read for it only when it is set
        self.viz = None
        self.wheel_type = wheel_up.TYPE_CODES.get(op.wheel.type, wheel_up.W3D_ANG)
        self._last_frame_t = None
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
        # zero-velocity updates (the reference's ZuptUpdater is missing from
        # its snapshot; update/zupt.py builds the intended behavior)
        z = op.zupt
        self.zupt = (ZuptUpdater(self.layout, CHI2_TABLE, sigma_v=z.sigma_v, sigma_w=z.sigma_w,
                                 gyro_thresh=z.gyro_thresh, accel_var_thresh=z.accel_var_thresh,
                                 window=z.window, chi2_mult=z.chi2_mult, device=self.device)
                     if z.enabled else None)
        self._iw_init = None  # the IMU+wheel initializer, made at the first attempt
        self.stats = {"cam_accept": 0, "cam_reject": 0, "clones": 0, "updates": 0,
                      "wheel_accept": 0, "wheel_reject": 0,
                      "line_accept": 0, "line_reject": 0, "lost_marg_obs": 0,
                      "gps_fused": 0}
        self.traj: list = []  # (t, q_GtoI, p_IinG) at clone times
        self._path = None  # "images" or "tracks": the camera path this system runs
        # the per-track path: feature store, frames waiting for IMU coverage,
        # the joint update's row collector, the wheel pairs' bookkeeping
        self.fdb = FeatureDatabase()
        # the C++ store of the mono candidates (None where native.py cannot build it)
        self.fdb_native = native.NativeFeatureDatabase() if native.available() else None
        self.stereo = False  # set by feed_stereo: stereo bypasses the C++ store
        self.ldb = LineDatabase()
        self.pending_frames: deque = deque()
        self._joint_rows = None
        self.chi2_table = torch.as_tensor(CHI2_TABLE, dtype=F64, device=self.device)
        self.clone_wv = {}  # clone time -> (w_hat, v) for the wheel dt column
        self.last_wheel_clone_t = None
        self._frame_dt = None
        # per-track dynamic cloning: frames before this time are skipped (the
        # images-in path's clone policy keeps its own _next_clone_t)
        self._track_next_clone_t = -np.inf if op.dynamic_cloning else None
        self._cur_ang_acc = 0.0
        self._cur_order = 1
        # host mirrors of the clone ring and of the calibration the path reads
        C = self.layout.n_clones
        self._clone_t = np.full(C, np.inf)
        self._clone_valid = np.zeros(C, dtype=bool)
        self._clone_kf = np.zeros(C, dtype=bool)
        self._cam_k = np.tile([1.0, 1.0, 0, 0, 0, 0, 0, 0], (self.layout.n_cams, 1))
        self._cam_dt0 = 0.0
        self._wheel_dt = 0.0
        # the wheel calibration set_wheel_calibration installed (q, p, intrinsics)
        self._wheel_calib = (np.array([0.0, 0.0, 0.0, 1.0]), np.zeros(3), np.ones(3))
        # host mirrors of the SLAM slots' ids and validity, and each slot's
        # count of consecutive failed gates
        S = self.layout.max_slam
        self._slam_id = np.full(S, -1, dtype=np.int64)
        self._slam_valid = np.zeros(S, dtype=bool)
        self._slam_fail = np.zeros(S, dtype=np.int32)
        self.host_reads = 0  # device -> host reads made by the per-track path

    # ------------------------------------------------------------------
    # configuration helpers
    # ------------------------------------------------------------------
    def _tensor(self, x, dtype=F64):
        """A host array on the device as `dtype`: a copy that does not wait
        for the device's queued work."""
        return torch.from_numpy(np.array(x)).to(self.device, dtype=dtype, non_blocking=True)

    def _set_at(self, name, index, value):
        """Copy of state field `name` with [:, index] set to value."""
        x = getattr(self.state, name).clone()
        x[:, index] = self._tensor(value)
        return x

    def set_calibration(self, cam_k, cam_q, cam_p, cam_dt=0.0, cam: int = 0):
        """Install camera calibration means into the state (per camera)."""
        if cam == 0:
            self._cam_dt0 = float(cam_dt)
        self._cam_k[cam] = np.asarray(cam_k, dtype=np.float64)
        self.state = self.state.replace(
            cam_k=self._set_at("cam_k", cam, cam_k), cam_q=self._set_at("cam_q", cam, cam_q),
            cam_p=self._set_at("cam_p", cam, cam_p), cam_dt=self._set_at("cam_dt", cam, cam_dt))

    def set_wheel_calibration(self, wheel_q, wheel_p, intrinsics, dt=0.0):
        t = self._tensor
        self.state = self.state.replace(
            wheel_q=t(wheel_q)[None], wheel_p=t(wheel_p)[None], wheel_k=t(intrinsics)[None],
            wheel_dt=t(dt)[None])
        self._wheel_dt = float(dt)
        self._wheel_calib = tuple(np.array(x, dtype=np.float64)
                                  for x in (wheel_q, wheel_p, intrinsics))

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
        self._bg = np.array(bg, dtype=np.float64)
        d = self._tensor
        q, p, v, bg, ba = (d(x)[None] for x in (q_GtoI, p, v, bg, ba))
        old = self.state
        # carry over every installed calibration mean
        calib = {n: getattr(old, n) for n in ("cam_k", "cam_q", "cam_p", "cam_dt", "wheel_q",
                                              "wheel_p", "wheel_k", "wheel_dt", "gps_p", "gps_dt")}
        self.state = st.replace(time=d(t)[None], q=q, p=p, v=v, bg=bg, ba=ba, q_fej=q, p_fej=p,
                                v_fej=v, bg_fej=bg, ba_fej=ba, **calib)
        self._time = float(t)
        self.startup_time = float(t)
        self._clone_t[:] = np.inf
        self._clone_valid[:] = False
        self._clone_kf[:] = False
        self._slam_id[:] = -1
        self._slam_valid[:] = False
        self.initialized = True

    # ------------------------------------------------------------------
    # sensor feeds
    # ------------------------------------------------------------------
    def feed_imu(self, t, w, a):
        self.imu_buf.feed(t, w, a)
        if not self.initialized:
            self._try_init()
            return
        self._process_pending()
        if self._pending_images:
            self._process_pending_images()
        b = self.imu_buf
        if self.zupt is not None and self.zupt.is_stationary(b.t, b.w, b.a, self._bg_host()):
            # propagate up to the current IMU time, then clamp the velocity
            try:
                if b.newest > self._time + 0.05:
                    self._propagate_to(b.newest)
                self.zupt.try_update(self, w)
            except RuntimeError:
                pass  # IMU coverage gap (e.g. right after init): skip

    def _bg_host(self):
        """The host mirror of state.bg, read again only after an update that
        the driver did not read it back from (a GPS update)."""
        if self._bg is None:
            self._bg = self._host(self.state.bg[0])
        return self._bg

    def _use_path(self, path: str):
        """Bind the system to one camera path: the per-track path keeps host
        mirrors of the clone ring that the images-in frame would not update."""
        if self._path not in (None, path):
            raise ValueError(f"this VioSystem runs the {self._path} path; feed {path} to "
                             "another instance")
        self._path = path

    def _per_track_checks(self):
        self._use_path("tracks")

    def _undistort(self, uvs, cam: int):
        k = torch.from_numpy(self._cam_k_now()[cam])
        return cam_ops.undistort_radtan(torch.from_numpy(uvs), k).numpy()

    def _classify_lines(self, segs):
        """Vanishing-point classes (L,) of raw pixel segments (L,4) from the
        current orientation and camera extrinsic (one device read), computed
        on the host."""
        qc = torch.from_numpy(self._host(torch.cat([self.state.q[0], self.state.cam_q[0, 0]])))
        vps, vp_valid = line_up.vanishing_points(qc[None, :4], qc[None, 4:],
                                                 torch.from_numpy(self._cam_k_now()[0])[None])
        return line_up.classify_lines(torch.from_numpy(segs)[None], vps, vp_valid)[0].numpy()

    def feed_camera(self, t, ids, uvs, line_ids=None, line_segs=None, line_pids=None):
        """One camera frame of tracked features: persistent ids (N,) and raw
        pixels (N,2), appended to the feature database with their
        undistorted normalized coordinates, and optionally tracked line
        segments: ids (L,), raw pixel endpoints (L,4) and per line the ids of
        its attached points (line_pids, for the point-line-coupled rows of
        cam.use_plc), appended to the line database with each segment's
        vanishing-point class from the current orientation; the frame is
        processed once the IMU covers it (see the module docstring)."""
        self._per_track_checks()
        uvs = np.atleast_2d(np.asarray(uvs, dtype=np.float64))
        if len(ids) > 0:
            uvns = self._undistort(uvs, 0)
            if self.fdb_native is not None:
                self.fdb_native.update_batch(np.asarray(ids), float(t), uvs, uvns)
            for fid, uv, uvn in zip(ids, uvs, uvns):
                self.fdb.update(int(fid), float(t), uv, uvn)
        if line_ids is not None and len(line_ids) > 0:
            segs = np.atleast_2d(np.asarray(line_segs, dtype=np.float64))
            n = len(line_ids)
            segs_n = self._undistort(segs.reshape(2 * n, 2), 0).reshape(n, 4)
            # the frame's classes from the orientation now (reference:
            # UpdaterCamera.cpp:100-104); the update votes over them
            cls = self._classify_lines(segs) if self.initialized else np.zeros(n, dtype=np.int64)
            pids = line_pids if line_pids is not None else [()] * n
            for lid, seg, seg_n, pid, ci in zip(line_ids, segs, segs_n, pids, cls):
                self.ldb.update(int(lid), float(t), seg, seg_n, point_ids=pid, D=int(ci))
        self.pending_frames.append(float(t))
        if self.initialized:
            self._process_pending()

    def feed_stereo(self, t, ids0, uvs0, ids1, uvs1, line_ids=None, line_segs=None,
                    line_pids=None):
        """One stereo pair of tracked features with ids shared by the two
        cameras (reference: TrackKLT::feed_stereo, TrackKLT.cpp:202-393):
        the right camera's observations enter the same tracks under camera
        1, and the MSCKF rows then carry a camera per observation."""
        self._per_track_checks()
        self.stereo = True
        uvs1 = np.atleast_2d(np.asarray(uvs1, dtype=np.float64))
        if len(ids1) > 0:
            uvns1 = self._undistort(uvs1, 1 % self.layout.n_cams)
            for fid, uv, uvn in zip(ids1, uvs1, uvns1):
                self.fdb.update(int(fid), float(t), uv, uvn, cam=1)
        self.feed_camera(t, ids0, uvs0, line_ids, line_segs, line_pids)

    def feed_image(self, t, img, img_r=None):
        """One RAW camera frame (H, W) in [0, 1], and with img_r the right
        camera's: the images-in live path.  Each frame is processed, once
        the IMU covers it, as one `fused_frame` on the device (see the
        module docstring); the right image is used where the layout has two
        cameras."""
        def dev(x):
            return torch.as_tensor(np.asarray(x, dtype=np.float32), device=self.device)

        self._use_path("images")
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
            with span("image"):
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
                t_frame = time.perf_counter()
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
                    img_r=None if img_r is None else img_r[None], lk_conv=op.cam.fused_lk_conv)
                # ONE host transfer: the frame's metrics, time, pose and bg
                st = self.state
                host = torch.cat([m[k].to(F64) for k in _METRICS]
                                 + [st.time, st.q[0], st.p[0], st.bg[0]]).cpu().numpy()
                ms_frame = 1e3 * (time.perf_counter() - t_frame)
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
                q, p = host[len(_METRICS) + 1:len(_METRICS) + 5], host[len(_METRICS) + 5:-3]
                self._bg = host[-3:]
                self._record_pose(self._time, q, p)
                if self.viz is not None:
                    self._viz_overlay(t, img)
                ms_gps = 0.0
                if self.gps is not None:
                    t_gps = time.perf_counter()
                    was_init = self.gps.initialized
                    self._gps_process()
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
        return do_clone, float(np.sqrt(sigma_pix**2 + (self._cam_k[0, 0] * interp_std) ** 2))

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
            self._clone_kf[slot] = True
            self._last_kf_pos = pos

    def feed_wheel(self, t, m1, m2):
        """One wheel sample: (m1, m2) = (left, right) rates/velocities, or
        (omega, v) for the *Cen types (reference: WheelData.m1/m2)."""
        self.wheel_buf.feed(t, m1, m2)
        if self.initialized:
            self._process_pending()

    # ------------------------------------------------------------------
    # initialization and propagation
    # ------------------------------------------------------------------
    def _gps_process(self):
        """The GPS updater's keyframe and fix handling after a frame; an
        update there leaves the host bg mirror stale."""
        st = self.state
        self.gps.try_process(self)
        if self.state is not st:
            self._bg = None

    def _try_init(self):
        """Auto-initialization on the host buffers (reference: the
        Initializer's try_initialize, Initializer.cpp): the IMU+wheel
        initializer with the wheel (unless init.imu_only_init), else the
        static IMU one; on success the state is seeded at its time and the
        camera frames from before it are dropped.  Reads no device state:
        the wheel calibration is the host copy set_wheel_calibration kept."""
        op = self.opts
        b = self.imu_buf
        if len(b.t) < 20:
            return
        if op.wheel.enabled and not op.init.imu_only_init:
            wq, wp, wk = self._wheel_calib
            if self._iw_init is None:
                R_OtoI = lie.quat_2_rot(torch.from_numpy(wq)).numpy().T
                self._iw_init = IwInitializer(
                    gravity_mag=op.gravity_mag, threshold=0.5, window_time=op.init.window_time,
                    R_OtoI=R_OtoI, p_IinO=wp, toff=self._wheel_dt,
                    gravity_aligned=op.init.imu_gravity_aligned)
            wb = self.wheel_buf
            if len(wb.t) < 5:
                return
            W, V = wheel_up.wv_stack_np(wb.m1, wb.m2, wk, self.wheel_type)
            res = self._iw_init.try_init(b.t, b.w, b.a, wb.t, W, V)
        else:
            res = try_static_init(b.t, b.w, b.a, op.init.window_time, op.init.imu_thresh,
                                  op.gravity_mag, require_excitation=False)
        if res is None:
            return
        q = lie.rot_2_quat(torch.from_numpy(np.asarray(res["R_GtoI"], dtype=np.float64)))
        self.initialize_from(res["t"], q.numpy(), np.zeros(3), res["v"], res["bg"], res["ba"])
        # drop the camera frames from before the initialization
        while self.pending_frames and self.pending_frames[0] <= res["t"]:
            self.pending_frames.popleft()
        self._db_cleanup(res["t"])

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
        if self.viz is not None and self._slam_valid.any():
            xyz = self._host(cam_helper.rep_to_xyz(self.state.slam_p[0], self.feat_rep))
            self.viz.add_slam_points(float(t), xyz[self._slam_valid])

    def _viz_overlay(self, t, img):
        """The images-in frame's tracking overlay: the image, the tracked
        slots and the tracked line segments in one read."""
        ts = self.track_state
        N, L = ts.uv.shape[1], ts.lseg.shape[1]
        host = self._host(torch.cat([img.reshape(-1).to(F64), ts.uv[0].reshape(-1).to(F64),
                                     ts.valid[0].to(F64), ts.lseg[0].reshape(-1).to(F64),
                                     ts.lvalid[0].to(F64)]))
        H, W = img.shape
        gray, host = host[:H * W].reshape(H, W).astype(np.float32), host[H * W:]
        uv, ok = host[:2 * N].reshape(N, 2), host[2 * N:3 * N] > 0.5
        segs, lok = host[3 * N:3 * N + 4 * L].reshape(L, 4), host[3 * N + 4 * L:] > 0.5
        self.viz.add_overlay(t, gray, uv[ok], None, segs[lok] if lok.any() else None)

    # ------------------------------------------------------------------
    # the per-track path
    # ------------------------------------------------------------------
    def _host(self, x):
        """A device tensor read to the host, counted in `host_reads`."""
        self.host_reads += 1
        return x.detach().cpu().numpy()

    def _cam_k_now(self):
        """Host copy of the camera intrinsics, read again from the state
        when they are estimated online."""
        if self.opts.cam.do_calib_int and self.initialized:
            self._cam_k = self._host(self.state.cam_k[0])
        return self._cam_k

    def _process_pending(self):
        op = self.opts
        while self.pending_frames:
            t_frame = self.pending_frames[0]
            if t_frame <= self._time:
                self.pending_frames.popleft()
                continue
            if self.imu_buf.newest < t_frame:
                return  # wait for IMU coverage
            # dynamic cloning: no clone at this frame while the motion lets
            # the clone rate stay low (reference: get_next_clone_time +
            # dynamic_cloning, SystemManager.cpp:172-312); the skipped
            # frame's observations stay in the database and update later
            # through interpolated poses
            if op.dynamic_cloning and self._track_next_clone_t is not None:
                if t_frame < self._track_next_clone_t - 1e-9:
                    self.pending_frames.popleft()
                    continue
            self.pending_frames.popleft()
            timing = {}
            with _stage(timing, "frame", "track"):
                if op.dynamic_cloning:
                    b = self.imu_buf
                    ang_acc, lin_acc = dynclone.estimate_accelerations(b.t, b.w, b.a,
                                                                       gravity_mag=op.gravity_mag)
                    hz, order = dynclone.select_rate_and_order(
                        ang_acc, lin_acc, max_order=op.intr_order, max_hz=float(op.clone_freq))
                    self._cur_ang_acc = ang_acc
                    self._cur_order = order
                    self._track_next_clone_t = t_frame + 1.0 / hz
                if self._last_frame_t is not None and t_frame > self._last_frame_t:
                    self._frame_dt = t_frame - self._last_frame_t
                self._last_frame_t = t_frame
                with _stage(timing, "propagate", "track.propagate"):
                    self._propagate_to(t_frame)
                    self._marginalize_for_window(t_frame)
                marg_times = self._next_marg_times(t_frame)
                self._augment_clone()
                self.stats["clones"] += 1
                # (body rate, global velocity) at the clone time for the wheel
                # dt-calibration column and the CPI anchors (the reference's CPI
                # side-band w/v, UpdaterWheel.cpp:400-414; the propagated state
                # at the clone time is exactly the CPI reconstruction)
                if (op.wheel.enabled and op.wheel.do_calib_dt) or op.use_imu_res:
                    wa = self.imu_buf.at(t_frame)
                    if wa is not None:
                        bv = self._host(torch.cat([self.state.bg[0], self.state.v[0]]))
                        self.clone_wv[t_frame] = (wa[0] - bv[:3], bv[3:].copy())
                if op.joint_update:
                    self._joint_rows = []
                with _stage(timing, "cam", "track.cam"):
                    self._msckf_update(t_frame, marg_times)
                    if self.layout.max_slam > 0:
                        self._slam_update(t_frame)
                with _stage(timing, "line", "track.line"):
                    if op.cam.use_lines:
                        self._line_update(t_frame, marg_times)
                with _stage(timing, "wheel", "track.wheel"):
                    if op.wheel.enabled:
                        self._wheel_update()
                with _stage(timing, "update", "track.update"):
                    self._apply_joint_rows()
                st = self.state
                # waits for the frame's device work; bg refreshes the host mirror
                qpb = self._host(torch.cat([st.q[0], st.p[0], st.bg[0]]))
                self._record_pose(self._time, qpb[:4], qpb[4:7])
                self._bg = qpb[7:]
                if self.gps is not None:
                    was_init = self.gps.initialized
                    self._gps_process()
                    if self.gps.initialized and not was_init:
                        # alignment done: release the keyframes
                        # (reference: SystemManager.cpp:164-168)
                        self.state = self.state.replace(
                            clone_keyframe=torch.zeros_like(self.state.clone_keyframe))
                        self._clone_kf[:] = False
                        if self.feat_rep != cam_helper.REP_GLOBAL_3D:
                            # the rotation into ENU marginalized every landmark
                            self._slam_id[:] = -1
                            self._slam_valid[:] = False
                self._db_cleanup(t_frame - op.window_size - 0.05)
                self.ldb.cleanup(t_frame - op.window_size - 0.05)
                self.imu_buf.prune(t_frame - op.window_size - 0.5)
            # host-clock stages: device work queued in a stage is waited for at
            # the next read (the accepted count in "cam", the pose at the end of
            # "frame"); the spans' device_ms count it in its own stage
            self.frame_timing = timing

    def _augment_clone(self):
        slot = int(np.argmin(self._clone_valid))  # the device takes the first free slot too
        self.state = ekf.augment_clone(self.state)
        self._clone_t[slot] = self._time
        self._clone_valid[slot] = True
        self._clone_kf[slot] = False

    def _apply_joint_rows(self):
        """Apply the frame's collected rows (unit noise) as ONE compress + EKF
        update (the JAX driver's joint design; the reference updates sensor
        by sensor, re-linearizing in between)."""
        rows, self._joint_rows = self._joint_rows, None
        if not rows:
            return
        H = torch.cat([h for h, _, _ in rows], dim=1)
        r = torch.cat([r for _, r, _ in rows], dim=1)
        m = torch.cat([m for _, _, m in rows], dim=1)
        Hc, rc, cmask = ekf.measurement_compress(H, r, m)
        self.state = ekf.update(self.state, Hc, rc, torch.ones_like(rc), cmask)
        self.stats["updates"] += 1

    def _marginalize_for_window(self, t_now):
        """Free clone slots: drop clones older than the window, and the oldest
        one if the ring is full (reference: marginalize_old_clone,
        StateHelper.cpp:214-233).  Tracks still observing a dying clone are
        harvested first with a final MSCKF (and line) update; a mature track
        outside the SLAM slots still holding such an observation afterwards is
        counted in stats["lost_marg_obs"] (it must stay 0)."""
        valid, times, keyframe = self._clone_valid, self._clone_t, self._clone_kf
        t_min = t_now - self.opts.window_size
        drop = valid & ~keyframe & (times < t_min)
        if int((valid & ~drop).sum()) >= self.layout.n_clones:
            rem = valid & ~drop & ~keyframe
            if rem.any():
                drop[int(np.argmin(np.where(rem, times, np.inf)))] = True
        drop_slots = np.nonzero(drop)[0]
        if len(drop_slots) == 0:
            return
        drop_times = {float(times[s]) for s in drop_slots}
        if any(any(ti in drop_times for ti in tr.times) for tr in self.fdb.tracks.values()):
            self._msckf_update(t_now, drop_times)
        if self.opts.cam.use_lines and any(any(ti in drop_times for ti in tr.times)
                                           for tr in self.ldb.tracks.values()):
            self._line_update(t_now, drop_times)
        # immature tracks lose only their pre-window head, as in the
        # reference's remove_unusable_measurements
        min_len = self.opts.cam.min_track_length
        usable_times = {float(times[i]) for i in np.nonzero(valid & ~drop)[0]} | drop_times
        slam_fids = self._slam_fids()
        self.stats["lost_marg_obs"] += sum(
            1 for fid, tr in self.fdb.tracks.items()
            if fid not in slam_fids
            and sum(1 for ti in tr.times if ti in usable_times) >= min_len
            and any(ti in drop_times for ti in tr.times))
        for slot in drop_slots:
            self.state = ekf.marginalize_clone(self.state, int(slot))
            self._clone_t[slot] = np.inf
            self._clone_valid[slot] = False
            self._clone_kf[slot] = False

    def _next_marg_times(self, t_now):
        """Times of every clone expected to leave the window by the next frame
        (age-out and ring-full), so tracks observing them are harvested this
        frame while the observations are still usable."""
        valid, times, keyframe = self._clone_valid, self._clone_t, self._clone_kf
        cand = valid & ~keyframe
        if not cand.any():
            return set()
        dt = self._frame_dt if self._frame_dt else 1.0 / float(self.opts.clone_freq)
        nct = self._track_next_clone_t
        if self.opts.dynamic_cloning and nct is not None and np.isfinite(nct):
            dt = max(dt, nct - t_now)
        t_min_next = t_now + 1.5 * dt - self.opts.window_size
        out = {float(t) for t in times[cand] if t < t_min_next}
        # this frame adds a clone; if age-outs won't free a slot by the next
        # frame the oldest will be forced out then
        if int(valid.sum()) + 1 - len(out) >= self.layout.n_clones:
            out.add(float(times[cand].min()))
        return out

    @property
    def feature_store(self) -> str:
        """The store the per-track MSCKF candidates come from: "native" (the
        C++ store, mono) or "python"."""
        return "native" if self.fdb_native is not None and not self.stereo else "python"

    def _db_cleanup(self, t_min):
        if self.fdb_native is not None:
            self.fdb_native.cleanup(t_min)
        self.fdb.cleanup(t_min)
        for t in [t for t in self.clone_wv if t < t_min]:
            del self.clone_wv[t]

    def _db_remove(self, fids):
        if self.fdb_native is not None:
            self.fdb_native.remove(fids)
        self.fdb.remove(fids)

    def _wheel_update(self):
        """Preintegrated relative-pose rows over consecutive clone pairs
        (reference: UpdaterWheel::try_update walking the clones newer than
        last_updated_clone_time, UpdaterWheel.cpp:36-140): 3D or planar by
        the wheel type, with the time-offset column when it is estimated,
        each pair chi^2-gated on its own."""
        op = self.opts.wheel
        lo = self.layout
        valid, times = self._clone_valid, self._clone_t
        slots_sorted = sorted((float(times[i]), int(i)) for i in np.nonzero(valid)[0])
        if len(slots_sorted) < 2:
            return
        if self.last_wheel_clone_t is None:
            self.last_wheel_clone_t = slots_sorted[0][0]
        tmap = {t: s for t, s in slots_sorted}
        if self.last_wheel_clone_t not in tmap:
            # marginalized away; restart from the oldest available
            self.last_wheel_clone_t = slots_sorted[0][0]
        if op.do_calib_dt:
            self._wheel_dt = float(self._host(self.state.wheel_dt)[0])
        toff = self._wheel_dt
        planar = self.wheel_type in (wheel_up.W2D_ANG, wheel_up.W2D_LIN, wheel_up.W2D_CEN)
        rows = 3 if planar else 6
        eye = torch.eye(rows, dtype=F64, device=self.device)
        mask = torch.ones((1, rows), dtype=torch.bool, device=self.device)
        ones = torch.ones((1, rows), dtype=F64, device=self.device)
        gate = float(CHI2_TABLE[rows]) * op.chi2_mult
        for t1, slot1 in slots_sorted:
            t0 = self.last_wheel_clone_t
            if t1 <= t0:
                continue
            sel = self.wheel_buf.select(t0 - toff, t1 - toff, pad_to=WHEEL_PAD)
            if sel is None:
                break
            ts, m1s, m2s = self._tensor(np.stack(sel))[:, None]
            st = self.state
            slot0 = tmap[t0]
            slots = self._tensor([slot0, slot1], torch.long)[:, None]
            # the dt-calibration column needs (w, v) at both clone times
            do_dt = op.do_calib_dt and t0 in self.clone_wv and t1 in self.clone_wv
            if do_dt:
                wv = self._tensor(np.concatenate([*self.clone_wv[t0], *self.clone_wv[t1]]))
                dt_args = dict(wheel_dt_off=lo.wheel_dt, do_calib_dt=True,
                               w0=wv[None, 0:3], v0=wv[None, 3:6], w1=wv[None, 6:9],
                               v1=wv[None, 9:12])
            else:
                dt_args = dict(wheel_dt_off=0, do_calib_dt=False)
            ring = (st.clone_q, st.clone_p, st.clone_q_fej, st.clone_p_fej, slots[0], slots[1],
                    st.wheel_q, st.wheel_p)
            noise = (op.noise_w, op.noise_v, op.noise_p, self.wheel_type)
            if planar:
                th_m, xy_m, Cov = wheel_up.preintegrate_2d(ts, m1s, m2s, st.wheel_k, *noise)
                H, res = wheel_up.linear_system_2d(*ring, th_m, xy_m, lo.n_clones, lo.clone_off,
                                                   lo.dim, **dt_args)
            else:
                R_m, p_m, Cov, dR_di, dp_di = wheel_up.preintegrate_3d(ts, m1s, m2s, st.wheel_k,
                                                                       *noise)
                H, res = wheel_up.linear_system_3d(
                    *ring, R_m, p_m, dR_di, dp_di, lo.n_clones, lo.clone_off, lo.dim,
                    lo.wheel_ext, lo.wheel_int, op.do_calib_ext, op.do_calib_int, **dt_args)
            Hw, rw = ekf.whiten(H, res, Cov + 1e-12 * eye)
            chi = float(self._host(ekf.chi2(st.cov, Hw, rw, ones, mask))[0])
            if chi < gate:
                if self._joint_rows is not None:
                    self._joint_rows.append((Hw, rw, mask))  # whitened: unit noise
                else:
                    self.state = ekf.update(st, Hw, rw, ones, mask)
                self.stats["wheel_accept"] += 1
            else:
                self.stats["wheel_reject"] += 1
            self.last_wheel_clone_t = t1
        self.wheel_buf.prune(self.last_wheel_clone_t - toff - 0.5)
        for t in [t for t in self.clone_wv if t < self.last_wheel_clone_t - 1e-9]:
            del self.clone_wv[t]

    def _interp_table(self, vt, vslots, obs_t, obs_valid):
        """The interpolated-pose table over the unique measurement times of
        an observation batch: the host picks K = order + 1 support clones
        per time (the reference's bounding_poses_n, State.cpp:1053-1136),
        the device evaluates `build_interp_table`.  Narrows obs_valid in
        place when more than T = 2C + 8 times occur (the oldest are
        dropped).  Returns (obs_tidx, tq, tp, tq_f, tp_f, tJ, tJt,
        is_interp, order) or None."""
        op = self.opts
        lo = self.layout
        if len(vt) < 2 or not obs_valid.any():
            return None
        if op.use_imu_res:
            return self._cpi_table(vt, vslots, obs_t, obs_valid)
        order = self._cur_order if op.dynamic_cloning else op.intr_order
        order = max(1, min(order, len(vt) - 1))
        K = order + 1
        T = 2 * lo.n_clones + 8
        tarr = np.unique(obs_t[obs_valid])
        if len(tarr) > T:
            tarr = tarr[-T:]  # keep the newest times; drop overflow obs
            obs_valid &= np.isin(obs_t, tarr)
        # online dt estimation: the labeled time goes with the initial
        # cam_dt; evaluate the pose at t_label + (dt_est - dt_initial)
        # (reference: State.cpp:833-973)
        dt_shift = (float(self._host(self.state.cam_dt[0, 0])) - self._cam_dt0
                    if op.cam.do_calib_dt else 0.0)
        # padding rows: distinct slots and offsets keep the Vandermonde
        # invertible (their outputs are unused)
        sup_slot = np.tile(np.arange(K, dtype=np.int64)[None, :], (T, 1))
        sup_dt = np.tile(np.arange(K, dtype=np.float64)[None, :], (T, 1))
        dt_eval = np.zeros(T)
        for i, ti in enumerate(tarr):
            j = int(np.searchsorted(vt, ti))
            lo_i = int(np.clip(j - K // 2, 0, len(vt) - K))
            ts = vt[lo_i:lo_i + K]
            sup_slot[i] = vslots[lo_i:lo_i + K]
            sup_dt[i] = ts - ts[0]
            dt_eval[i] = ti - ts[0] + dt_shift
        obs_tidx = np.searchsorted(tarr, obs_t).clip(0, T - 1)
        obs_tidx[~obs_valid] = 0
        st = self.state
        f = self._tensor(np.concatenate([sup_dt.ravel(), dt_eval]))
        table = build_interp_table(st.clone_q, st.clone_p, st.clone_q_fej, st.clone_p_fej,
                                   self._tensor(sup_slot, torch.long)[None],
                                   f[:T * K].reshape(1, T, K),
                                   f[T * K:][None], K=K, n_clones=lo.n_clones)
        is_interp = (~np.isin(obs_t, vt) if abs(dt_shift) < 1e-9
                     else np.ones_like(obs_valid))
        return (obs_tidx,) + table + (is_interp, order)

    def _cpi_table(self, vt, vslots, obs_t, obs_valid):
        """The CPI-interpolated pose table (use_imu_res, the reference's
        State::get_interpolated_pose_imu): each unique measurement time
        anchors at the clone at or before it, with the velocity recorded at
        that clone, and the device preintegrates the IMU window from the
        anchor (`build_cpi_table`, windows of up to CPI_PAD samples from
        `ImuBuffer.select`, cut after the longest window's last sample).
        Times no window covers are dropped from obs_valid (in place), as are
        the oldest beyond T = 2C + 8.  The return of `_interp_table` (order
        1)."""
        op = self.opts
        lo = self.layout
        T = 2 * lo.n_clones + 8
        tarr = np.unique(obs_t[obs_valid])
        if len(tarr) > T:
            tarr = tarr[-T:]
            obs_valid &= np.isin(obs_t, tarr)
        dt_shift = (float(self._host(self.state.cam_dt[0, 0])) - self._cam_dt0
                    if op.cam.do_calib_dt else 0.0)
        anchor_slot = np.zeros(T, dtype=np.int64)
        anchor_v = np.zeros((T, 3))
        wt = np.zeros((T, CPI_PAD))
        ww = np.zeros((T, CPI_PAD, 3))
        wa = np.zeros((T, CPI_PAD, 3))
        drop_times = set()
        for i, ti in enumerate(tarr):
            j = int(np.searchsorted(vt, ti + 1e-12, side="right") - 1)
            if j < 0:
                drop_times.add(ti)
                continue
            anchor_slot[i] = vslots[j]
            wv = self.clone_wv.get(float(vt[j]))
            anchor_v[i] = wv[1] if wv is not None else self._host(self.state.v[0])
            te = ti + dt_shift
            if te - vt[j] < 1e-9:
                wt[i] = vt[j]
            else:
                sel = self.imu_buf.select(float(vt[j]), float(te), pad_to=CPI_PAD)
                if sel is None:
                    drop_times.add(ti)
                    continue
                wt[i], ww[i], wa[i] = sel
        if drop_times:
            obs_valid &= ~np.isin(obs_t, sorted(drop_times))
            if not obs_valid.any():
                return None
        obs_tidx = np.searchsorted(tarr, obs_t).clip(0, T - 1)
        obs_tidx[~obs_valid] = 0
        # the steps past every window's last sample are padding, no-ops bit
        # for bit: the device integrates the longest window's samples only
        N = max(2, int(np.max(np.argmax(wt == wt[:, -1:], axis=1))) + 1)
        wt, ww, wa = wt[:, :N], ww[:, :N], wa[:, :N]
        st = self.state
        f = self._tensor(np.concatenate([anchor_v.ravel(), wt.ravel(), ww.ravel(), wa.ravel()]))
        n3, nt = 3 * T, T * N
        table = build_cpi_table(
            st.clone_q, st.clone_p, st.clone_q_fej, st.clone_p_fej,
            self._tensor(anchor_slot, torch.long)[None], f[:n3].reshape(1, T, 3),
            f[n3:n3 + nt].reshape(1, T, N), f[n3 + nt:n3 + 4 * nt].reshape(1, T, N, 3),
            f[n3 + 4 * nt:].reshape(1, T, N, 3), st.bg, st.ba, self.gravity,
            n_clones=lo.n_clones)
        is_interp = (~np.isin(obs_t, vt) if abs(dt_shift) < 1e-9
                     else np.ones_like(obs_valid))
        return (obs_tidx,) + table + (is_interp, 1)

    def _msckf_update(self, t_frame, marg_times):
        """MSCKF update of the tracks that are lost or observe a clone in
        marg_times (reference: UpdaterCamera::msckf_update,
        UpdaterCamera.cpp:197-294; candidates as CamHelper::get_features,
        :613-707): their observations at times the clones cover, at most
        cam.max_msckf tracks (longest first), triangulated at the table's
        poses, one 2-row system per observation, nullspace-projected and
        chi^2-gated per feature; the rows join the frame's joint update (or
        update alone).  The tracks are consumed.  SLAM landmarks' tracks are
        left to `_slam_update`."""
        op = self.opts.cam
        lo = self.layout
        valid, times = self._clone_valid, self._clone_t
        tmap = {float(times[i]): i for i in np.nonzero(valid)[0]}
        vslots = np.nonzero(valid)[0]
        vt = times[vslots]
        order_idx = np.argsort(vt)
        vt, vslots = vt[order_idx], vslots[order_idx]
        t_lo, t_hi = (vt[0], vt[-1]) if len(vt) else (np.inf, -np.inf)

        def usable(ti):
            """The clones cover time ti (at a clone or between two)."""
            return ti in tmap or t_lo < ti < t_hi

        slam_fids = self._slam_fids()  # SLAM landmarks update in the state, not as MSCKF rows
        Fn, O = op.max_msckf, lo.n_clones
        obs_cam = np.zeros((Fn, O), dtype=np.int64)
        if self.feature_store == "native":
            # the C++ export selects among every track, SLAM-owned ones included:
            # those keep their candidate places with no valid observation
            n_cands, fids, obs_uv, obs_uvn, _, _, _, obs_t, obs_valid = \
                self.fdb_native.export_msckf(vt, vslots.astype(np.int32), sorted(marg_times),
                                             t_frame, op.min_track_length, Fn, O)
            if n_cands == 0:
                return
            fids = fids[:n_cands].tolist()
            obs_valid[:n_cands] &= np.array([fid not in slam_fids for fid in fids])[:, None]
            used_fids = [fid for fid in fids if fid not in slam_fids]
        else:
            cands = []
            for fid, tr in self.fdb.tracks.items():
                if fid in slam_fids:
                    continue
                n_usable = sum(1 for ti in tr.times if usable(ti))
                if n_usable < op.min_track_length:
                    continue
                if tr.times[-1] < t_frame or any(ti in marg_times for ti in tr.times):
                    cands.append((n_usable, fid))
            if not cands:
                return
            cands.sort(reverse=True)
            cands = cands[:op.max_msckf]
            n_cands = len(cands)
            obs_uv = np.zeros((Fn, O, 2))
            obs_uvn = np.zeros((Fn, O, 2))
            obs_t = np.zeros((Fn, O))
            obs_valid = np.zeros((Fn, O), dtype=bool)
            used_fids = []
            for i, (_, fid) in enumerate(cands):
                tr = self.fdb.tracks[fid]
                j = 0
                for k, (ti, uv, uvn) in enumerate(zip(tr.times, tr.uvs, tr.uvns)):
                    if usable(ti) and j < O:
                        obs_uv[i, j] = uv
                        obs_uvn[i, j] = uvn
                        obs_t[i, j] = ti
                        obs_cam[i, j] = tr.cam_of(k)
                        obs_valid[i, j] = True
                        j += 1
                used_fids.append(fid)

        # the interpolated-pose table over the unique measurement times
        # (order from intr_order, or the dynamic selection)
        tbl = self._interp_table(vt, vslots, obs_t, obs_valid)
        if tbl is None:
            return
        obs_tidx, tq, tp, tq_f, tp_f, tJ, tJt, is_interp, order = tbl
        fx = float(self._cam_k_now()[0, 0])
        # per-row noise: pixel variance plus the interpolation error of
        # off-clone observations (reference: CamHelper.cpp:211-225)
        sigma2 = op.sigma_pix**2
        if self.opts.dynamic_cloning:
            interp_px = fx * dynclone.interp_noise_std(self._cur_ang_acc,
                                                       float(self.opts.clone_freq), order)
            s2_obs = sigma2 + (is_interp & obs_valid) * interp_px**2
        # the host arrays in one copy: uv, uvn, valid, camera-0 flags and
        # (dynamic cloning) the per-row noise as floats; table rows and
        # cameras as integers
        parts = [obs_uv, obs_uvn, obs_valid, obs_cam == 0]
        if self.opts.dynamic_cloning:
            parts.append(s2_obs)
        f = self._tensor(np.concatenate([np.asarray(x, np.float64).reshape(Fn, O, -1)
                                         for x in parts], axis=-1))[None]
        idx = self._tensor(np.stack([obs_tidx, np.clip(obs_cam, 0, lo.n_cams - 1)]),
                           torch.long)[:, None]
        uv, uvn = f[..., 0:2], f[..., 2:4]
        valid_t, cam0 = f[..., 4] > 0.5, f[..., 5] > 0.5
        tidx, cams = idx[0], idx[1]
        st = self.state
        cam_q, cam_p, cam_k = (cam_helper.gather_slots(x, cams)
                               for x in (st.cam_q, st.cam_p, st.cam_k))

        # triangulate at the interpolated estimates
        p_f, ok, avg_err = cam_helper.triangulate_batch(
            uvn, cam_helper.gather_slots(tq, tidx), cam_helper.gather_slots(tp, tidx), valid_t,
            cam_q, cam_p, min_dist=op.triangulation_min_dist,
            max_dist=op.triangulation_max_dist, max_cond=op.triangulation_max_cond)
        # moving-consistency: mean reprojection error below ~3 px
        ok = ok & (avg_err < 3.0 / fx)

        Hx, Hf, r, rowmask = cam_helper.point_systems_table_batch(
            p_f, uv, tidx, valid_t, cam0, tq, tp, tq_f, tp_f, tJ, tJt, cam_q, cam_p, cam_k,
            int(self.distortion_model), lo.clone_off, lo.dim,
            lo.cam_dt(0) if op.do_calib_dt else -1,
            lo.cam_ext(0) if op.do_calib_ext else -1,
            lo.cam_int(0) if op.do_calib_int else -1)
        rowmask = rowmask & ok[..., None]
        if self.opts.dynamic_cloning:
            s2_rows, r_unit = cam_helper.repeat_each(f[..., 6], 2), 1.0
        else:
            s2_rows, r_unit = sigma2, sigma2
        Hn, rn, rowvalid, feat_ok = cam_helper.msckf_project_and_gate(
            Hx, Hf, r, rowmask, st.cov, s2_rows, self.chi2_table, op.chi2_mult)
        n_ok = int(self._host(feat_ok.sum()))
        self.stats["cam_accept"] += n_ok
        self.stats["cam_reject"] += n_cands - n_ok
        if self.viz is not None and n_ok:
            host = self._host(torch.cat([p_f[0], feat_ok[0, :, None].to(F64)], dim=-1))
            self.viz.add_points(t_frame, host[host[:, 3] > 0.5, :3])
        if n_ok == 0:
            self._db_remove(used_fids)
            return

        M = Fn * Hn.shape[2]
        H_all = Hn.reshape(1, M, lo.dim)
        r_all = rn.reshape(1, M)
        mask_all = rowvalid.reshape(1, M)
        if self._joint_rows is not None:
            # unit-noise rows (r_unit is 1 when the rows were whitened per row)
            s = float(np.sqrt(r_unit))
            self._joint_rows.append((H_all / s, r_all / s, mask_all))
        else:
            Hc, rc, cmask = ekf.measurement_compress(H_all, r_all, mask_all)
            self.state = ekf.update(self.state, Hc, rc, torch.full_like(rc, r_unit), cmask)
            self.stats["updates"] += 1
        # consumed: MSCKF features are fire-and-forget
        self._db_remove(used_fids)

    # ------------------------------------------------------------------
    # SLAM landmarks and the line update
    # ------------------------------------------------------------------
    def _slam_fids(self):
        return {int(x) for x in self._slam_id if x >= 0}

    def _marginalize_slam(self, slot):
        self.state = ekf.marginalize_slam_slot(self.state, int(slot))
        self._slam_id[slot] = -1
        self._slam_valid[slot] = False
        self._slam_fail[slot] = 0

    def _slam_update(self, t_frame):
        """In-state SLAM landmarks (reference: slam_update, slam_init and
        marginalize_slam_features, UpdaterCamera.cpp:118-137, 296-369).
        (a) A landmark whose track was lost is marginalized; the others update
        with the frame's observation (2 rows each at the new clone, the
        landmark's columns chained through its representation), gated one by
        one in one batched chi^2, in one EKF update at sigma_pix^2; a
        landmark failing its gate more than 3 times in a row is marginalized
        and its track removed.  (b) Free slots take up to 5 new landmarks,
        the longest tracks first with at least min(10, max(window x
        clone_freq - 1, 4)) observations at clone times: each is
        triangulated, and `ekf.delayed_init` initializes it in the
        representation cam.feat_rep from its interpolated-pose rows, unless
        its correction is not finite or larger than 5."""
        op = self.opts.cam
        lo = self.layout
        S = lo.max_slam
        valid, times = self._clone_valid, self._clone_t
        tmap = {float(times[i]): i for i in np.nonzero(valid)[0]}
        rep = self.feat_rep
        sigma2 = op.sigma_pix**2
        model = int(self.distortion_model)

        # (a) update the active landmarks with the current frame's observation
        upd_slots, upd_uv = [], []
        for slot in np.nonzero(self._slam_valid)[0]:
            tr = self.fdb.tracks.get(int(self._slam_id[slot]))
            if tr is None or tr.times[-1] < t_frame - 1e-9:
                self._marginalize_slam(slot)  # lost
            elif t_frame in tmap:
                upd_slots.append(int(slot))
                upd_uv.append(tr.uvs[-1])
        if upd_slots:
            n = len(upd_slots)
            f = np.zeros((S, 3))  # uv, valid
            f[:n, :2] = upd_uv
            f[:n, 2] = 1.0
            idx = np.zeros((2, S), dtype=np.int64)  # slot, the new clone's slot
            idx[0, :n] = upd_slots
            idx[1] = tmap[t_frame]
            f, idx = self._tensor(f)[None], self._tensor(idx, torch.long)[:, None]
            st = self.state
            slots, ob_s = idx[0], idx[1][..., None]
            Hx, r, _ = cam_helper.slam_systems_batch(
                cam_helper.rep_to_xyz(cam_helper.gather_slots(st.slam_p, slots), rep), slots,
                f[..., None, 0:2], ob_s, f[..., 2:3] > 0.5,
                st.clone_q, st.clone_p, st.clone_q_fej, st.clone_p_fej,
                st.cam_q[:, 0], st.cam_p[:, 0], st.cam_k[:, 0], model, lo.n_clones, lo.clone_off,
                lo.slam_off, lo.dim,
                rep_jac=cam_helper.rep_jacobian(cam_helper.gather_slots(st.slam_p_fej, slots), rep))
            # every landmark's chi^2 in one batch and one read
            rows = np.zeros((S, 2), dtype=bool)
            rows[:n] = True
            chis = self._host(ekf.chi2(st.cov.expand(S, -1, -1), Hx[0], r[0],
                                       torch.full_like(r[0], sigma2),
                                       self._tensor(rows, torch.bool)))
            keep = chis[:n] < float(CHI2_TABLE[2]) * op.chi2_mult
            for slot, k in zip(upd_slots, keep):
                self._slam_fail[slot] = 0 if k else self._slam_fail[slot] + 1
            rows[:n] &= keep[:, None]
            if rows.any():
                M = 2 * S
                self.state = ekf.update(st, Hx.reshape(1, M, lo.dim), r.reshape(1, M),
                                        torch.full((1, M), sigma2, dtype=F64, device=self.device),
                                        self._tensor(rows.reshape(1, M), torch.bool))
            # marginalize repeat offenders (reference: update_fail_count)
            for slot in upd_slots:
                if self._slam_fail[slot] > 3:
                    fid = int(self._slam_id[slot])
                    self._marginalize_slam(slot)
                    self._db_remove([fid])

        # (b) initialize new landmarks into free slots
        free = [int(s) for s in np.nonzero(~self._slam_valid)[0]]
        if not free:
            return
        active = self._slam_fids()
        min_len = min(10, max(int(self.opts.window_size * self.opts.clone_freq) - 1, 4))
        cands = []
        for fid, tr in self.fdb.tracks.items():
            if fid in active or tr.times[-1] < t_frame - 1e-9:
                continue
            n_in = sum(1 for ti in tr.times if ti in tmap)
            if n_in >= min_len:
                cands.append((n_in, fid))
        cands.sort(reverse=True)
        O = lo.n_clones
        for _, fid in cands[:min(len(free), 5)]:
            tr = self.fdb.tracks[fid]
            f = np.zeros((O, 5))  # uv, uvn, valid
            s0 = np.zeros(O, dtype=np.int64)
            j = 0
            for ti, u, un in zip(tr.times, tr.uvs, tr.uvns):
                if ti in tmap and j < O:
                    f[j] = [*u, *un, 1.0]
                    s0[j] = tmap[ti]
                    j += 1
            f, s0 = self._tensor(f)[None, None], self._tensor(s0, torch.long)[None, None]
            obs_valid = f[..., 4] > 0.5
            st = self.state
            cam_q, cam_p, cam_k = st.cam_q[:, 0], st.cam_p[:, 0], st.cam_k[:, 0]
            p_f, ok, _ = cam_helper.triangulate_batch(
                f[..., 2:4], cam_helper.gather_slots(st.clone_q, s0),
                cam_helper.gather_slots(st.clone_p, s0), obs_valid, cam_q, cam_p)
            if not self._host(ok)[0, 0]:
                continue
            Hx, Hf, r, rowmask = cam_helper.point_systems_interp_batch(
                p_f, f[..., 0:2], s0, s0, torch.zeros_like(f[..., 4]), obs_valid,
                st.clone_q, st.clone_p, st.clone_q_fej, st.clone_p_fej, cam_q, cam_p, cam_k,
                model, lo.n_clones, lo.clone_off, lo.dim)
            slot = free.pop(0)
            # delayed init in the landmark's error-state representation:
            # H_n = Hf d(xyz)/d(rep) (CamHelper.cpp:21-56)
            rep0 = cam_helper.xyz_to_rep(p_f[:, 0], rep)
            m = rowmask[:, 0].to(F64)
            new_cov, dx_full, dn, *_ = ekf.delayed_init(
                st.cov, Hx[:, 0] * m[..., None],
                Hf[:, 0] @ cam_helper.rep_jacobian(rep0, rep) * m[..., None], r[:, 0] * m,
                torch.full_like(m, sigma2), lo.slam(slot), 3)
            dn_h = self._host(dn)[0]
            if not np.all(np.isfinite(dn_h)) or float(np.linalg.norm(dn_h)) > 5.0:
                free.insert(0, slot)
                continue
            st2 = ekf.apply_dx(st, dx_full)
            sel = torch.arange(S, device=self.device)[None] == slot
            new_rep = (rep0 + dn)[:, None]
            self.state = st2.replace(
                cov=new_cov,
                slam_p=torch.where(sel[..., None], new_rep, st2.slam_p),
                slam_p_fej=torch.where(sel[..., None], new_rep, st2.slam_p_fej),
                slam_valid=st2.slam_valid | sel,
                slam_id=torch.where(sel, fid, st2.slam_id))
            self._slam_id[slot] = fid
            self._slam_valid[slot] = True
            if not free:
                break

    def _line_update(self, t_frame, marg_times):
        """MSCKF line update (reference: UpdaterCamera::lines_update,
        UpdaterCamera.cpp:371-464) of the line tracks with >= 3 observations
        at clone times that were lost or observe a clone in marg_times (at
        most cam.max_lines, the longest first).  Each line is triangulated
        along the world axis of its majority vanishing-point class
        (direction-constrained least squares) or, unclassified, from its
        plane pairs (>= 3 of them); its rows (the two endpoints per
        observation, plus the attached points' with cam.use_plc) are dropped
        when their mean |r| exceeds 4.0 (classified) or 2.5 times
        sigma_pix_line, then nullspace-projected against the line's 4 dof and
        chi^2-gated per line (`msckf_project_and_gate`, plain torch: no TPU
        kernel lies on this path); they join the frame's joint update (or
        update alone).  The tracks are consumed."""
        op = self.opts.cam
        lo = self.layout
        valid, times = self._clone_valid, self._clone_t
        tmap = {float(times[i]): i for i in np.nonzero(valid)[0]}
        cands = []
        for lid, tr in self.ldb.tracks.items():
            n_in = sum(1 for ti in tr.times if ti in tmap)
            if n_in >= 3 and (tr.times[-1] < t_frame or any(ti in marg_times for ti in tr.times)):
                cands.append((n_in, lid))
        if not cands:
            return
        cands.sort(reverse=True)
        cands = cands[:op.max_lines]
        L, O = op.max_lines, lo.n_clones
        P = op.max_plc if op.use_plc else 0
        seg_uv = np.zeros((L, O, 4))
        seg_uvn = np.zeros((L, O, 4))
        obs_slot = np.zeros((L, O), dtype=np.int64)
        obs_valid = np.zeros((L, O), dtype=bool)
        plc_uv = np.zeros((L, O, P, 2))
        plc_valid = np.zeros((L, O, P), dtype=bool)
        line_dir = np.tile([1.0, 0.0, 0.0, 0.0], (L, 1))  # the class's world axis, classified
        used = []
        for i, (_, lid) in enumerate(cands):
            tr = self.ldb.tracks[lid]
            j = 0
            for k, (ti, seg, seg_n) in enumerate(zip(tr.times, tr.segs, tr.segs_n)):
                if ti in tmap and j < O:
                    seg_uv[i, j] = seg
                    seg_uvn[i, j] = seg_n
                    obs_slot[i, j] = tmap[ti]
                    obs_valid[i, j] = True
                    if P and k < len(tr.point_ids):
                        # the attached points' measured pixels at this time
                        # (reference: LineHelper.cpp:879-890)
                        m = 0
                        for pid in tr.point_ids[k]:
                            if m >= P:
                                break
                            ptr = self.fdb.tracks.get(int(pid))
                            if ptr is None or ti not in ptr.times:
                                continue
                            plc_uv[i, j, m] = ptr.uvs[ptr.times.index(ti)]
                            plc_valid[i, j, m] = True
                            m += 1
                    j += 1
            # the class by majority over the classes recorded at feed time
            cls = tr.majority_class()
            line_dir[i] = [*np.eye(3)[max(cls - 1, 0)], float(cls > 0)]
            used.append(lid)

        # the host arrays in one copy (floats) and one (slots)
        parts = [seg_uv, seg_uvn, obs_valid[..., None], plc_uv.reshape(L, O, 2 * P), plc_valid,
                 np.broadcast_to(line_dir[:, None], (L, O, 4))]
        f = self._tensor(np.concatenate([np.asarray(x, np.float64) for x in parts], -1))[None]
        slot = self._tensor(obs_slot, torch.long)[None]
        seg_uv_t, seg_uvn_t, valid_t = f[..., 0:4], f[..., 4:8], f[..., 8] > 0.5
        plc_uv_t = f[..., 9:9 + 2 * P].unflatten(-1, (P, 2))
        plc_valid_t = f[..., 9 + 2 * P:9 + 3 * P] > 0.5
        dir_G, has_cls = f[:, :, 0, 9 + 3 * P:12 + 3 * P], f[:, :, 0, 12 + 3 * P] > 0.5

        st = self.state
        cq = cam_helper.gather_slots(st.clone_q, slot)
        cp = cam_helper.gather_slots(st.clone_p, slot)
        cam_q, cam_p, cam_k = st.cam_q[:, 0], st.cam_p[:, 0], st.cam_k[:, 0]
        # triangulation: direction-constrained for classified lines, two
        # planes otherwise (with >= 3 supporting plane pairs: the weakest
        # geometry)
        n2, v2, ok2, pair_count = line_up.triangulate_two_plane(seg_uvn_t, cq, cp, valid_t,
                                                               cam_q, cam_p)
        ok2 = ok2 & (pair_count >= 3)
        nd, vd, okd = line_up.triangulate_direction_ls(seg_uvn_t, cq, cp, valid_t, cam_q, cam_p,
                                                       dir_G)
        use_dir = has_cls & okd
        n_G = torch.where(use_dir[..., None], nd, n2)
        v_G = torch.where(use_dir[..., None], vd, v2)
        ok = torch.where(use_dir, okd, ok2)
        Hx, Hl, r, rowmask = line_up.line_systems_batch_plc(
            n_G, v_G, seg_uv_t, plc_uv_t, plc_valid_t, slot, valid_t,
            st.clone_q, st.clone_p, st.clone_q_fej, st.clone_p_fej, cam_q, cam_p, cam_k,
            lo.n_clones, lo.clone_off, lo.dim)
        rowmask = rowmask & ok[..., None]
        # reprojection-quality gate: the rows' mean |r| against the noise,
        # looser for classified lines (multiplied, as in the JAX package)
        r_mean = (torch.sum(torch.abs(r) * rowmask, dim=-1)
                  / torch.clamp(torch.sum(rowmask, dim=-1), min=1))
        gate_mult = 2.5 + 1.5 * use_dir.to(F64)
        rowmask = rowmask & (r_mean < gate_mult * op.sigma_pix_line)[..., None]
        sigma2 = op.sigma_pix_line**2
        Hn, rn, rowvalid, line_ok = cam_helper.msckf_project_and_gate(
            Hx, Hl, r, rowmask, st.cov, sigma2, self.chi2_table, op.chi2_mult)
        n_ok = int(self._host(line_ok.sum()))
        self.stats["line_accept"] += n_ok
        self.stats["line_reject"] += len(cands) - n_ok
        if self.viz is not None and n_ok:
            self._viz_lines(t_frame, line_ok, n_G, v_G, seg_uvn, obs_slot, obs_valid)
        if n_ok:
            M = L * Hn.shape[2]
            H_all, r_all = Hn.reshape(1, M, lo.dim), rn.reshape(1, M)
            mask_all = rowvalid.reshape(1, M)
            if self._joint_rows is not None:
                s = float(np.sqrt(sigma2))
                self._joint_rows.append((H_all / s, r_all / s, mask_all))
            else:
                Hc, rc, cmask = ekf.measurement_compress(H_all, r_all, mask_all)
                self.state = ekf.update(self.state, Hc, rc, torch.full_like(rc, sigma2), cmask)
        self.ldb.remove(used)

    def _viz_lines(self, t_frame, line_ok, n_G, v_G, seg_uvn, obs_slot, obs_valid):
        """The accepted lines' display endpoints, from each line's newest
        observation (the device read in one transfer)."""
        st = self.state
        L, C = line_ok.shape[1], st.clone_q.shape[1]
        host = self._host(torch.cat([line_ok[0].to(F64), n_G[0].reshape(-1), v_G[0].reshape(-1),
                                     st.clone_q[0].reshape(-1), st.clone_p[0].reshape(-1),
                                     st.cam_q[0, 0], st.cam_p[0, 0]]))
        ok, host = host[:L] > 0.5, host[L:]
        nG, vG = host[:3 * L].reshape(L, 3), host[3 * L:6 * L].reshape(L, 3)
        host = host[6 * L:]
        cq, cp = host[:4 * C].reshape(C, 4), host[4 * C:7 * C].reshape(C, 3)
        cam_q, cam_p = host[7 * C:7 * C + 4], host[7 * C + 4:]
        eps = []
        for i in np.nonzero(ok)[0]:
            js = np.nonzero(obs_valid[i])[0]
            if not len(js):
                continue
            j = int(js[-1])
            k = obs_slot[i, j]
            eps.append(line_display_endpoints(nG[i], vG[i], seg_uvn[i, j], cq[k], cp[k], cam_q,
                                              cam_p))
        self.viz.add_lines(t_frame, np.asarray(eps))

    # ------------------------------------------------------------------
    # telemetry (reference: SystemManager::print_status/print_final_report,
    # SystemManager.cpp:314-522)
    # ------------------------------------------------------------------
    def print_status(self):
        st = self.state
        p = st.p[0].cpu().numpy()
        n_clones = int(st.clone_valid.sum())
        n_slam = int(st.slam_valid.sum())
        vlog.info(f"t={self._time:.2f} p=[{p[0]:.2f} {p[1]:.2f} {p[2]:.2f}] "
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
        if self.zupt is not None:
            out["zupt"] = dict(self.zupt.stats)
        if self._path == "tracks":
            out["feature_store"] = self.feature_store
        return out
