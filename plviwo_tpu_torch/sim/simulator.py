"""Synthetic sensor simulator (port of plviwo_tpu/sim/simulator.py).

A B-spline ground-truth trajectory plus IMU, rendered camera frames and
wheel samples, in numpy (the spline and the projection in float64 torch on
the CPU).  It consumes the numpy `default_rng` draws in the same order as
the JAX package's simulator, so one seed gives the same landmarks, texture
and noise; tests/test_torch_fused_frame.py holds the two to each other.
It gives the chip smoke real frames, IMU and wheel data on a machine
without JAX.

Ported: `gt_pose`, `gt_kin`, `imu_stream`, `cam_times`, `cam_frame` (the
simulator's data association, both stereo cameras), `line_frame` (the
lines' association) and `line_dir_class`, `render_frame` (with
`_draw_line`, both cameras, and the fiducial tags painted on the ground),
`tag_corners_world`, `wheel_times`, `wheel_sample`, `gps_times` and
`gps_sample`.

Conventions match the filter: q_GtoI JPL, gravity g = [0,0,9.81],
a_m = R_GtoI (a_G + g) + ba + n_a,  w_m = w_body + bg + n_g.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import cam as cam_ops
from ..ops import lie
from .bspline import BsplineSE3, figure8_controls

F64 = torch.float64


@dataclasses.dataclass
class SimConfig:
    seed: int = 0
    duration: float = 40.0
    imu_hz: float = 200.0
    cam_hz: float = 10.0
    wheel_hz: float = 100.0
    gps_hz: float = 1.0
    # imu noise (continuous-time densities)
    sigma_w: float = 1.7e-4
    sigma_a: float = 2.0e-3
    sigma_wb: float = 1.9e-5
    sigma_ab: float = 3.0e-3
    # camera
    n_landmarks: int = 400
    n_pts: int = 60
    sigma_pix: float = 1.0
    width: int = 640
    height: int = 480
    intrinsics: tuple = (300.0, 300.0, 320.0, 240.0, -0.05, 0.01, 0.0005, -0.0002)
    cam_ext_q: tuple = (0.5, -0.5, 0.5, -0.5)  # q_ItoC: camera x right, y down, z forward
    cam_ext_p: tuple = (0.05, 0.0, 0.0)
    stereo_baseline: float = 0.12
    # lines (vertical/horizontal structure, urban-like)
    n_lines: int = 60
    sigma_pix_line: float = 1.5
    # wheel
    wheel_rl: float = 0.3
    wheel_rr: float = 0.3
    wheel_base: float = 1.5
    sigma_wheel: float = 0.01  # rad/s on each wheel rate
    wheel_ext_q: tuple = (0.0, 0.0, 0.0, 1.0)  # q_ItoO
    wheel_ext_p: tuple = (0.0, 0.0, -0.5)
    # gps
    sigma_gps: float = 0.5
    gps_ext_p: tuple = (0.0, 0.0, 0.3)
    # fiducial tags painted on the ground plane (the TrackAruco test
    # surface), rendered in full perspective by the ground raycast, so the
    # tag corners are fixed world points; tag_size = black border side [m]
    n_tags: int = 0
    tag_size: float = 0.5
    # roll/pitch excitation [rad] added to the figure-8
    rp_excite: float = 0.0


def _rot(q) -> np.ndarray:
    return lie.quat_2_rot(torch.tensor(q, dtype=F64)).numpy()


class Simulator:
    def __init__(self, cfg: SimConfig | None = None, controls=None):
        self.cfg = cfg or SimConfig()
        c = self.cfg
        if controls is None:
            # a fixed-pace figure-8 whatever part of it is replayed
            lap = max(c.duration + 4.0, 60.0)
            controls = figure8_controls(duration=lap, dt_knot=0.25, rp_excite=c.rp_excite)
        self.spline = BsplineSE3(*controls)
        self.rng = np.random.default_rng(c.seed)
        self.t_start = max(self.spline.t_min, 0.0)
        self.t_end = min(self.spline.t_max, self.t_start + c.duration)

        # landmark field around the trajectory
        ts = np.linspace(self.t_start, self.t_end, 60)
        path = self.spline.kin(ts)["p_IinG"]
        lo, hi = path.min(0) - 8.0, path.max(0) + 8.0
        hi[2] = path[:, 2].max() + 6.0
        lo[2] = path[:, 2].min() - 2.0
        self.landmarks = self.rng.uniform(lo, hi, size=(c.n_landmarks, 3))

        # 3-D line field: half z-parallel, a quarter each x- and y-parallel
        n_v = c.n_lines // 2
        n_x = c.n_lines // 4
        starts = self.rng.uniform(lo, hi, size=(c.n_lines, 3))
        dirs = np.zeros((c.n_lines, 3))
        dirs[:n_v] = [0, 0, 1]
        dirs[n_v:n_v + n_x] = [1, 0, 0]
        dirs[n_v + n_x:] = [0, 1, 0]
        lengths = self.rng.uniform(2.0, 8.0, size=(c.n_lines, 1))
        self.line_p1 = starts
        self.line_p2 = starts + dirs * lengths
        # each line's world axis as the vanishing-point classes number them
        # (1 x, 2 y, 3 z)
        self.line_dir_class = np.concatenate(
            [np.full(n_v, 3), np.full(n_x, 1), np.full(c.n_lines - n_v - n_x, 2)])
        self.ground_z = float(self.landmarks[:, 2].min() - 2.0)

        # fiducial tags on the ground along the path (TrackAruco analogue)
        if c.n_tags > 0:
            from ..ops import aruco

            self.tag_codes = aruco.tag_family()[: c.n_tags]
            self.tag_bitmaps = np.stack([aruco.tag_bitmap(code) for code in self.tag_codes])
            idx = np.linspace(0, len(path) - 1, c.n_tags).astype(int)
            jitter = self.rng.uniform(-1.5, 1.5, size=(c.n_tags, 2))
            self.tag_center = path[idx, :2] + jitter
            self.tag_yaw = self.rng.uniform(0, 2 * np.pi, size=c.n_tags)

        # bias random walks sampled on the IMU grid
        n_imu = int((self.t_end - self.t_start) * c.imu_hz) + 1
        self.imu_t = self.t_start + np.arange(n_imu) / c.imu_hz
        dt = 1.0 / c.imu_hz
        self.bg_true = np.cumsum(
            self.rng.normal(0, c.sigma_wb * np.sqrt(dt), size=(n_imu, 3)), axis=0)
        self.ba_true = np.cumsum(
            self.rng.normal(0, c.sigma_ab * np.sqrt(dt), size=(n_imu, 3)), axis=0)

    # ------------------------------------------------------------------
    # ground truth
    # ------------------------------------------------------------------
    def gt_pose(self, t):
        """(q_GtoI, p_IinG) ground truth at time t (numpy)."""
        kin = self.spline.imu_true(t)
        return lie.rot_2_quat(torch.as_tensor(kin["R_GtoI"])).numpy(), kin["p_IinG"]

    def gt_kin(self, t):
        return self.spline.imu_true(t)

    # ------------------------------------------------------------------
    # sensor streams
    # ------------------------------------------------------------------
    def imu_stream(self):
        """All IMU samples: (t (N,), w_m (N,3), a_m (N,3)) with noise + bias."""
        c = self.cfg
        kin = self.spline.kin(self.imu_t)
        g = np.array([0.0, 0.0, 9.81])
        a_body = np.einsum("nij,nj->ni", kin["R_GtoI"], kin["a_IinG"] + g)
        w = kin["w_IinI"]
        dt = 1.0 / c.imu_hz
        w_m = w + self.bg_true + self.rng.normal(0, c.sigma_w / np.sqrt(dt), w.shape)
        a_m = a_body + self.ba_true + self.rng.normal(0, c.sigma_a / np.sqrt(dt), a_body.shape)
        return self.imu_t.copy(), w_m, a_m

    def cam_times(self):
        """Frame times at cam_hz, from 0.1 s after the start."""
        c = self.cfg
        n = int((self.t_end - self.t_start - 0.2) * c.cam_hz)
        return self.t_start + 0.1 + np.arange(n) / c.cam_hz

    def _project(self, p_C):
        k = torch.tensor(self.cfg.intrinsics, dtype=F64)
        return cam_ops.project(torch.as_tensor(p_C), k, cam_ops.RADTAN).numpy()

    def cam_frame(self, t, cam: int = 0):
        """Visible landmark observations at time t: (ids (M,) int64, uvs
        (M,2)) with pixel noise, the simulator acting as a perfect
        data-association tracker (TrackSIM).  cam=1 is the right stereo
        camera, its center shifted by `stereo_baseline` along camera x;
        landmark ids are shared by both cameras.  Draws a permutation when
        more than n_pts are visible, then the noise, as the JAX package
        does."""
        c = self.cfg
        kin = self.spline.imu_true(t)
        p_IinC = np.asarray(c.cam_ext_p, dtype=np.float64)
        if cam == 1:
            p_IinC = p_IinC + np.array([-c.stereo_baseline, 0.0, 0.0])
        p_C = (_rot(c.cam_ext_q) @ kin["R_GtoI"] @ (self.landmarks - kin["p_IinG"]).T).T + p_IinC
        front = p_C[:, 2] > 0.3
        uv = self._project(p_C[front])
        ids_all = np.nonzero(front)[0]
        inb = ((uv[:, 0] > 1) & (uv[:, 0] < c.width - 2) & (uv[:, 1] > 1)
               & (uv[:, 1] < c.height - 2) & (np.linalg.norm(p_C[front], axis=1) < 60.0))
        ids, uv = ids_all[inb], uv[inb]
        if len(ids) > c.n_pts:
            sel = self.rng.permutation(len(ids))[: c.n_pts]
            sel.sort()
            ids, uv = ids[sel], uv[sel]
        uv = uv + self.rng.normal(0, c.sigma_pix, uv.shape)
        return ids.astype(np.int64), uv

    def line_frame(self, t):
        """Visible line observations: (ids, endpoints_uv (M,4)) with noise."""
        c = self.cfg
        kin = self.spline.imu_true(t)
        R_GtoC = _rot(c.cam_ext_q) @ kin["R_GtoI"]
        p_I, p_IinC = kin["p_IinG"], np.asarray(c.cam_ext_p)

        def to_cam(P):
            return (R_GtoC @ (P - p_I).T).T + p_IinC

        p1c, p2c = to_cam(self.line_p1), to_cam(self.line_p2)
        front = (p1c[:, 2] > 0.5) & (p2c[:, 2] > 0.5)
        uv1 = self._project(p1c[front])
        uv2 = self._project(p2c[front])
        ids_all = np.nonzero(front)[0]
        inb = np.all([(uv[:, 0] > 1) & (uv[:, 0] < c.width - 2) & (uv[:, 1] > 1)
                      & (uv[:, 1] < c.height - 2) for uv in (uv1, uv2)], axis=0)
        ids = ids_all[inb]
        seg = np.concatenate([uv1[inb], uv2[inb]], axis=1)
        seg += self.rng.normal(0, c.sigma_pix_line, seg.shape)
        return ids.astype(np.int64), seg

    def render_frame(self, t, with_lines=True, cam: int = 0):
        """Render a synthetic grayscale image (H, W) float32 in [0, 1]:
        Gaussian blobs at the landmarks, dark strokes along the 3-D lines
        (with_lines: their noisy endpoints draw from the generator, as in
        the JAX package), over a ray-cast textured ground plane.  cam=1
        renders the right stereo camera, stereo_baseline along camera x
        (its line strokes are the left camera's, as the JAX package draws
        them)."""
        c = self.cfg
        H, W = c.height, c.width
        if not hasattr(self, "_ground_tex"):
            # smooth multi-octave ground texture (0.25 m/texel, wraps)
            tex = np.zeros((1024, 1024))
            for cell, amp in ((64, 0.10), (16, 0.06), (4, 0.03)):
                coarse = self.rng.uniform(-1, 1, (1024 // cell + 1, 1024 // cell + 1))
                ys = np.linspace(0, coarse.shape[0] - 1.01, 1024)
                y0 = ys.astype(int)
                fy = ys - y0
                up = (coarse[y0] * (1 - fy)[:, None] + coarse[y0 + 1] * fy[:, None])
                up2 = (up[:, y0] * (1 - fy)[None, :] + up[:, y0 + 1] * fy[None, :])
                tex += amp * up2
            self._ground_tex = 0.45 + tex
            self._blob_amp = self.rng.uniform(0.3, 0.5, size=c.n_landmarks)

        kin = self.spline.imu_true(t)
        R_GtoI, p_I = kin["R_GtoI"], kin["p_IinG"]
        p_cam_ext = np.asarray(c.cam_ext_p)
        if cam == 1:
            p_cam_ext = p_cam_ext + np.array([-c.stereo_baseline, 0.0, 0.0])
        R_GtoC = _rot(c.cam_ext_q) @ R_GtoI
        cam_center = p_I - R_GtoC.T @ p_cam_ext

        # --- ray-cast the textured ground plane ---
        fx, fy, cx, cy = c.intrinsics[:4]
        us, vs = np.meshgrid(np.arange(W), np.arange(H))
        rays_C = np.stack([(us - cx) / fx, (vs - cy) / fy, np.ones_like(us, dtype=float)], -1)
        rays_G = rays_C @ R_GtoC
        denom = rays_G[..., 2]
        hit = denom < -1e-6  # looking downward
        s = np.where(hit, (self.ground_z - cam_center[2]) / np.where(hit, denom, 1.0), 0.0)
        gx = cam_center[0] + s * rays_G[..., 0]
        gy = cam_center[1] + s * rays_G[..., 1]
        ti = np.mod(gx / 0.25, 1024).astype(int)
        tj = np.mod(gy / 0.25, 1024).astype(int)
        img = np.where(hit, self._ground_tex[tj, ti], 0.5)

        # --- project landmarks (noiseless) and splat blobs ---
        p_C = (R_GtoC @ (self.landmarks - p_I).T).T + p_cam_ext
        front = p_C[:, 2] > 0.3
        uv = self._project(p_C[front])
        amps = self._blob_amp[front]
        r = 6
        for (u, v), a in zip(uv, amps):
            if not (r < u < W - r - 1 and r < v < H - r - 1):
                continue
            iu, iv = int(u), int(v)
            ys = np.arange(iv - r, iv + r + 1)
            xs = np.arange(iu - r, iu + r + 1)
            dy = (ys - v)[:, None]
            dx = (xs - u)[None, :]
            img[np.ix_(ys, xs)] += a * np.exp(-(dx**2 + dy**2) / (2 * 1.8**2))

        if with_lines:
            _, segs = self.line_frame(t)
            for seg in segs:
                self._draw_line(img, seg, depth=0.35)

        # --- composite the ground tags (painted last: fiducials are opaque) ---
        cell_m = c.tag_size / 6.0
        for k in range(c.n_tags):
            dx = gx - self.tag_center[k, 0]
            dy = gy - self.tag_center[k, 1]
            cy_, sy_ = np.cos(self.tag_yaw[k]), np.sin(self.tag_yaw[k])
            u = (cy_ * dx + sy_ * dy) / cell_m
            v = (-sy_ * dx + cy_ * dy) / cell_m
            inside = hit & (np.abs(u) < 4.0) & (np.abs(v) < 4.0)
            if not inside.any():
                continue
            bm = self.tag_bitmaps[k]
            # bitmap row from -v: a ground plane is viewed from above, so the
            # plane's v maps to image -y; the flip makes the painted pattern
            # read canonically (a proper rotation, no mirror) for any camera
            # looking down
            bi = np.clip(((4.0 - v) * (bm.shape[0] / 8.0)).astype(int), 0, bm.shape[0] - 1)
            bj = np.clip(((u + 4.0) * (bm.shape[1] / 8.0)).astype(int), 0, bm.shape[1] - 1)
            img = np.where(inside, bm[bi, bj], img)
        return np.clip(img, 0.0, 1.0).astype(np.float32)

    def tag_corners_world(self):
        """(T, 4, 3) world positions of each tag's canonical TL, TR, BR, BL
        border corners (tag-local cells (-3,-3), (3,-3), (3,3), (-3,3))."""
        c = self.cfg
        cell_m = c.tag_size / 6.0
        # the canonical (detector-space) corner (cu, cv) sits at the painted
        # tag-local (cu, -cv) (the bitmap-row flip in render_frame)
        local = np.array([[-3.0, 3.0], [3.0, 3.0], [3.0, -3.0], [-3.0, -3.0]])
        out = np.zeros((c.n_tags, 4, 3))
        for k in range(c.n_tags):
            cy_, sy_ = np.cos(self.tag_yaw[k]), np.sin(self.tag_yaw[k])
            R = np.array([[cy_, -sy_], [sy_, cy_]])
            out[k, :, :2] = self.tag_center[k] + (local * cell_m) @ R.T
            out[k, :, 2] = self.ground_z
        return out

    @staticmethod
    def _draw_line(img, seg, depth=0.3):
        H, W = img.shape
        x1, y1, x2, y2 = seg
        L = max(np.hypot(x2 - x1, y2 - y1), 1.0)
        n = int(L * 2)
        ts = np.linspace(0, 1, n)
        xs = x1 + (x2 - x1) * ts
        ys = y1 + (y2 - y1) * ts
        for x, y in zip(xs, ys):
            iu, iv = int(round(x)), int(round(y))
            if 1 <= iu < W - 1 and 1 <= iv < H - 1:
                img[iv, iu] -= depth
                img[iv + 1, iu] -= depth * 0.5
                img[iv, iu + 1] -= depth * 0.5

    def wheel_times(self):
        """Sample times at wheel_hz from the start."""
        c = self.cfg
        n = int((self.t_end - self.t_start) * c.wheel_hz)
        return self.t_start + np.arange(n) / c.wheel_hz

    def wheel_sample(self, t):
        """(psi_left, psi_right) wheel angular rates at t (noisy)."""
        c = self.cfg
        kin = self.spline.imu_true(t)
        R_ItoO = _rot(c.wheel_ext_q)
        p_OinI = -R_ItoO.T @ np.asarray(c.wheel_ext_p)
        w_I = kin["w_IinI"]
        w_O = R_ItoO @ w_I
        v_O = R_ItoO @ (kin["R_GtoI"] @ kin["v_IinG"] + np.cross(w_I, p_OinI))
        vx, wz = v_O[0], w_O[2]
        psi_l = (vx - wz * c.wheel_base / 2.0) / c.wheel_rl
        psi_r = (vx + wz * c.wheel_base / 2.0) / c.wheel_rr
        n = self.rng.normal(0, c.sigma_wheel, 2)
        return psi_l + n[0], psi_r + n[1]

    def gps_times(self):
        """Fix times at gps_hz, from 0.05 s after the start."""
        c = self.cfg
        n = int((self.t_end - self.t_start) * c.gps_hz)
        return self.t_start + 0.05 + np.arange(n) / c.gps_hz

    def gps_sample(self, t):
        """ENU position of the GPS antenna at t (noisy); the world frame is
        the ENU frame."""
        c = self.cfg
        kin = self.spline.imu_true(t)
        p_gps = kin["p_IinG"] + kin["R_GtoI"].T @ np.asarray(c.gps_ext_p)
        return p_gps + self.rng.normal(0, c.sigma_gps, 3)
