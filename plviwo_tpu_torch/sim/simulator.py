"""Synthetic sensor simulator (port of plviwo_tpu/sim/simulator.py).

A B-spline ground-truth trajectory plus IMU, rendered camera frames and
wheel samples, in numpy (the spline and the projection in float64 torch on
the CPU).  It consumes the numpy `default_rng` draws in the same order as
the JAX package's simulator, so one seed gives the same landmarks, texture
and noise; tests/test_torch_fused_frame.py holds the two to each other.
It gives the chip smoke real frames, IMU and wheel data on a machine
without JAX.

Ported: `gt_pose`, `gt_kin`, `imu_stream`, `render_frame` of the left
camera (with `line_frame` and `_draw_line`), `wheel_sample`.  Not ported:
fiducial tags (`n_tags > 0` is refused), the right stereo camera,
`cam_frame`, the time grids, GPS.

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
    # fiducial tags (not ported: must stay 0)
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
        if c.n_tags > 0:
            raise NotImplementedError("fiducial tags are not ported (n_tags must be 0)")
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
        self.ground_z = float(self.landmarks[:, 2].min() - 2.0)

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

    def _project(self, p_C):
        k = torch.tensor(self.cfg.intrinsics, dtype=F64)
        return cam_ops.project(torch.as_tensor(p_C), k, cam_ops.RADTAN).numpy()

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

    def render_frame(self, t):
        """Render a synthetic grayscale image (H, W) float32 in [0, 1] of
        the (left) camera: Gaussian blobs at the landmarks, dark strokes
        along the 3-D lines, over a ray-cast textured ground plane."""
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

        _, segs = self.line_frame(t)
        for seg in segs:
            self._draw_line(img, seg, depth=0.35)
        return np.clip(img, 0.0, 1.0).astype(np.float32)

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
