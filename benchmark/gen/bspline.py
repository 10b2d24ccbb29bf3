"""Uniform cumulative SE(3) B-spline (port of plviwo_tpu/sim/bspline.py).

    T(u) = T_{i-1} exp(B1(u) O_i) exp(B2(u) O_{i+1}) exp(B3(u) O_{i+2}),
    O_j  = log(T_{j-1}^{-1} T_j),

evaluated in float64 on the CPU for many times at once.  Velocity and
acceleration are in closed form (the JAX package differentiates the pose
map with `jax.jacfwd`): each factor A = exp(b(u) O) has dA/du = A O^ b'
and d2A/du2 = A (O^ O^ b'^2 + O^ b''), and the product rule does the rest.

Control poses are T_ItoG (R_ItoG, p_IinG) at uniform spacing dt_knot.
"""

from __future__ import annotations

import numpy as np
import torch

from ..reference.plv.ops import lie

F64 = torch.float64


def _hat(xi):
    """se(3) hat: (...,6) [omega, rho] -> (...,4,4)."""
    top = torch.cat([lie.skew(xi[..., :3]), xi[..., 3:, None]], dim=-1)
    return torch.cat([top, torch.zeros(xi.shape[:-1] + (1, 4), dtype=xi.dtype)], dim=-2)


class BsplineSE3:
    def __init__(self, control_T, t0: float, dt_knot: float):
        """control_T: (K, 4, 4) control poses T_ItoG at times t0 + k*dt_knot."""
        self.control_T = torch.as_tensor(np.asarray(control_T), dtype=F64)
        self.t0 = float(t0)
        self.dt = float(dt_knot)
        self.K = self.control_T.shape[0]
        Tm = self.control_T
        self.omegas = lie.log_se3(lie.inv_se3(Tm[:-1]) @ Tm[1:])  # (K-1, 6)

    @property
    def t_min(self) -> float:
        return self.t0 + self.dt  # need one knot before

    @property
    def t_max(self) -> float:
        return self.t0 + (self.K - 3) * self.dt

    def eval(self, t):
        """(T, dT/dt, d2T/dt2), each (n,4,4) float64, at the times t (n,)."""
        s_raw = (torch.as_tensor(np.atleast_1d(np.asarray(t, dtype=np.float64)))
                 - self.t0) / self.dt
        # strict clamps away from the ends (as the JAX version): no motion
        # is read beyond the first and last full segments
        s = torch.minimum(torch.maximum(s_raw, torch.tensor(1.0, dtype=F64)),
                          torch.tensor(self.K - 2 - 1e-9, dtype=F64))
        ds = ((s_raw > 1.0) & (s_raw < self.K - 2 - 1e-9)).to(F64) / self.dt
        i = torch.floor(s).long()
        u = s - i.to(F64)
        b = [(5.0 + 3.0 * u - 3.0 * u * u + u**3) / 6.0,
             (1.0 + 3.0 * u + 3.0 * u * u - 2.0 * u**3) / 6.0,
             u**3 / 6.0]
        db = [(3.0 - 6.0 * u + 3.0 * u * u) / 6.0, (3.0 + 6.0 * u - 6.0 * u * u) / 6.0,
              u * u / 2.0]
        ddb = [u - 1.0, 1.0 - 2.0 * u, u]
        A, dA, ddA = [], [], []
        for k in range(3):
            O = self.omegas[i - 1 + k]
            H = _hat(O)
            Ak = lie.exp_se3(b[k][:, None] * O)
            A.append(Ak)
            dA.append(Ak @ H * (db[k] * ds)[:, None, None])
            ddA.append(Ak @ (H @ H * (db[k] * ds)[:, None, None] ** 2
                             + H * (ddb[k] * ds * ds)[:, None, None]))
        T0 = self.control_T[i - 1]
        T = T0 @ A[0] @ A[1] @ A[2]
        dT = T0 @ (dA[0] @ A[1] @ A[2] + A[0] @ dA[1] @ A[2] + A[0] @ A[1] @ dA[2])
        ddT = T0 @ (ddA[0] @ A[1] @ A[2] + A[0] @ ddA[1] @ A[2] + A[0] @ A[1] @ ddA[2]
                    + 2.0 * (dA[0] @ dA[1] @ A[2] + dA[0] @ A[1] @ dA[2]
                             + A[0] @ dA[1] @ dA[2]))
        return T, dT, ddT

    def kin(self, t):
        """True kinematics at the times t (n,): dict of numpy arrays R_GtoI
        (n,3,3), p_IinG, v_IinG, a_IinG, w_IinI (n,3)."""
        T, dT, ddT = self.eval(t)
        R_ItoG = T[:, :3, :3]
        # body angular velocity: [w]_x = R_ItoG^T dR_ItoG
        w_body = lie.unskew(R_ItoG.transpose(-1, -2) @ dT[:, :3, :3])
        return {"R_GtoI": R_ItoG.transpose(-1, -2).numpy(), "p_IinG": T[:, :3, 3].numpy(),
                "v_IinG": dT[:, :3, 3].numpy(), "a_IinG": ddT[:, :3, 3].numpy(),
                "w_IinI": w_body.numpy()}

    def imu_true(self, t):
        """`kin` at one time t, without the leading axis."""
        return {k: v[0] for k, v in self.kin(t).items()}


def figure8_controls(duration: float = 60.0, dt_knot: float = 0.5, rx: float = 20.0,
                     ry: float = 10.0, rz: float = 1.0, rp_excite: float = 0.0,
                     rp_hz: float = 0.5):
    """Car-like figure-8 path control poses, heading along the path (numpy;
    the JAX package's, without its speed warp).  rp_excite adds a
    roll/pitch oscillation (rad, at rp_hz)."""
    K = int(duration / dt_knot) + 6
    ts = (np.arange(K) - 2) * dt_knot
    w = 2 * np.pi / duration
    x = rx * np.sin(w * ts)
    y = ry * np.sin(2 * w * ts)
    z = rz * np.sin(w * ts * 0.5) * 0.2
    Ts = np.zeros((K, 4, 4))
    dx = rx * w * np.cos(w * ts)
    dy = 2 * ry * w * np.cos(2 * w * ts)
    for k in range(K):
        yaw = np.arctan2(dy[k], dx[k])
        c, s = np.cos(yaw), np.sin(yaw)
        R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
        if rp_excite > 0:
            ph = 2 * np.pi * rp_hz * ts[k]
            r_, p_ = rp_excite * np.sin(ph), rp_excite * np.sin(1.618 * ph)
            cr, sr = np.cos(r_), np.sin(r_)
            cp, sp = np.cos(p_), np.sin(p_)
            Rr = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
            Rp = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
            R = R @ Rp @ Rr
        Ts[k, :3, :3] = R
        Ts[k, :3, 3] = [x[k], y[k], z[k]]
        Ts[k, 3, 3] = 1.0
    return Ts, float(ts[0]), dt_knot
