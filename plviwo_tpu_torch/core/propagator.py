"""IMU propagation (port of plviwo_tpu/core/propagator.py), batch-first.

RK4 mean over a padded IMU stack plus the FEJ discrete transition Phi and
noise Qd (Trawny eqs. 129-130).  As in the JAX version, the per-interval
RK4 increments are composed by a log-depth quaternion prefix scan, and the
(Phi, Qd) chain by the same binary-tree fold (so its f32 products
associate identically).
Padding entries (dt = 0) are identity steps.  `ImuBuffer` is the
host-side sample ring the live driver (`core/system.py`) selects padded
windows from, in numpy, a copy of the JAX package's.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops import lie
from .ekf import propagate_cov
from .state import FilterState

F64 = torch.float64
F32 = torch.float32


def _id_quat(like):
    q = torch.zeros(like.shape[:-1] + (4,), dtype=like.dtype, device=like.device)
    q[..., 3] = 1.0
    return q


def _qdot(dq, w):
    return 0.5 * (lie.omega(w) @ dq[..., None])[..., 0]


def rk4_mean(q, p, v, w1, a1, w2, a2, dt, gravity):
    """One RK4 step of the JPL IMU mean dynamics (bias-corrected inputs).

    q (...,4), p/v/w/a (...,3), dt (...).  q_new = dq (x) q with dq
    integrated from identity under q_dot = 0.5 Omega(w) dq."""
    dt_ = dt[..., None]
    dt_safe = torch.where(dt_ > 0, dt_, 1.0)
    w_alpha = (w2 - w1) / dt_safe
    a_jerk = (a2 - a1) / dt_safe
    dq_0 = _id_quat(q)

    def vdot(dq, a):
        R_Gtok = lie.quat_2_rot(lie.quat_multiply(dq, q))
        return (R_Gtok.transpose(-1, -2) @ a[..., None])[..., 0] - gravity

    k1_q = _qdot(dq_0, w1) * dt_
    k1_p = v * dt_
    k1_v = vdot(dq_0, a1) * dt_
    w_h = w1 + 0.5 * w_alpha * dt_
    a_h = a1 + 0.5 * a_jerk * dt_
    dq_1 = lie.quat_norm(dq_0 + 0.5 * k1_q)
    v_1 = v + 0.5 * k1_v
    k2_q = _qdot(dq_1, w_h) * dt_
    k2_p = v_1 * dt_
    k2_v = vdot(dq_1, a_h) * dt_
    dq_2 = lie.quat_norm(dq_0 + 0.5 * k2_q)
    v_2 = v + 0.5 * k2_v
    k3_q = _qdot(dq_2, w_h) * dt_
    k3_p = v_2 * dt_
    k3_v = vdot(dq_2, a_h) * dt_
    w_h = w1 + w_alpha * dt_
    a_h = a1 + a_jerk * dt_
    dq_3 = lie.quat_norm(dq_0 + k3_q)
    v_3 = v + k3_v
    k4_q = _qdot(dq_3, w_h) * dt_
    k4_p = v_3 * dt_
    k4_v = vdot(dq_3, a_h) * dt_

    dq = lie.quat_norm(dq_0 + (k1_q + 2 * k2_q + 2 * k3_q + k4_q) / 6.0)
    return (lie.quat_multiply(dq, q),
            p + (k1_p + 2 * k2_p + 2 * k3_p + k4_p) / 6.0,
            v + (k1_v + 2 * k2_v + 2 * k3_v + k4_v) / 6.0)


def _blocks(rows):
    return torch.cat([torch.cat(r, dim=-1) for r in rows], dim=-2)


def step_transition(q_fej, dp_term, dv_term, new_q, w_hat, dt, sigmas):
    """FEJ discrete transition F (...,15,15) and noise Qd for one interval.

    Error order [theta p v bg ba]; sigmas = (sigma_w, sigma_a, sigma_wb,
    sigma_ab).  dp_term / dv_term are the caller's cancellation-safe terms
    (see the JAX docstring)."""
    dtype, dev = new_q.dtype, new_q.device
    Rfej = lie.quat_2_rot(q_fej)
    RfT = Rfej.transpose(-1, -2)
    dR = lie.quat_2_rot(new_q) @ RfT
    dt_safe = torch.where(dt > 0, dt, 1.0)
    dt2 = dt[..., None, None]
    Jr_neg = lie.jr_so3(-w_hat * dt[..., None])

    I3 = torch.eye(3, dtype=dtype, device=dev).expand(dR.shape)
    Z3 = torch.zeros_like(dR)
    A = -dR @ Jr_neg * dt2
    skP = -lie.skew(dp_term) @ RfT
    skV = -lie.skew(dv_term) @ RfT
    Bm = -0.5 * RfT * dt2 * dt2
    Cm = -RfT * dt2
    F = _blocks([
        [dR, Z3, Z3, A, Z3],
        [skP, I3, I3 * dt2, Z3, Bm],
        [skV, Z3, I3, Z3, Cm],
        [Z3, Z3, Z3, I3, Z3],
        [Z3, Z3, Z3, Z3, I3],
    ])

    sw, sa, swb, sab = sigmas
    qw = (sw**2 / dt_safe)[..., None, None]
    qa = (sa**2 / dt_safe)[..., None, None]
    qwb = (swb**2 * dt_safe)[..., None, None]
    qab = (sab**2 * dt_safe)[..., None, None]
    Qtt = qw * (A @ A.transpose(-1, -2))
    Qpp = (0.25 * dt2**4 * qa) * I3
    Qpv = (0.5 * dt2**3 * qa) * I3
    Qvv = (dt2**2 * qa) * I3
    Qd = _blocks([
        [Qtt, Z3, Z3, Z3, Z3],
        [Z3, Qpp, Qpv, Z3, Z3],
        [Z3, Qpv, Qvv, Z3, Z3],
        [Z3, Z3, Z3, qwb * I3, Z3],
        [Z3, Z3, Z3, Z3, qab * I3],
    ])

    is_pad = (dt <= 0)[..., None, None]
    F = torch.where(is_pad, torch.eye(15, dtype=dtype, device=dev), F)
    Qd = torch.where(is_pad, torch.zeros_like(Qd), Qd)
    return F, Qd


def _rk4_local_increments(w1, a1, w2, a2, dt):
    """Frame-independent RK4 increments (dq, dv_l, dp_l, gp) for one interval
    (see the JAX docstring): the stage math of `rk4_mean`, reassociated so
    the time recursion becomes prefix compositions.  Batched over (...)."""
    dt_ = dt[..., None]
    dt_safe = torch.where(dt_ > 0, dt_, 1.0)
    w_alpha = (w2 - w1) / dt_safe
    a_jerk = (a2 - a1) / dt_safe
    dq_0 = _id_quat(w1)

    def u_of(dq, a):
        return (lie.quat_2_rot(dq).transpose(-1, -2) @ a[..., None])[..., 0]

    k1_q = _qdot(dq_0, w1) * dt_
    u1 = u_of(dq_0, a1)
    w_h = w1 + 0.5 * w_alpha * dt_
    a_h = a1 + 0.5 * a_jerk * dt_
    dq_1 = lie.quat_norm(dq_0 + 0.5 * k1_q)
    k2_q = _qdot(dq_1, w_h) * dt_
    u2 = u_of(dq_1, a_h)
    dq_2 = lie.quat_norm(dq_0 + 0.5 * k2_q)
    k3_q = _qdot(dq_2, w_h) * dt_
    u3 = u_of(dq_2, a_h)
    w_h = w1 + w_alpha * dt_
    a_h = a1 + a_jerk * dt_
    dq_3 = lie.quat_norm(dq_0 + k3_q)
    k4_q = _qdot(dq_3, w_h) * dt_
    u4 = u_of(dq_3, a_h)

    dq = lie.quat_norm(dq_0 + (k1_q + 2 * k2_q + 2 * k3_q + k4_q) / 6.0)
    dv_l = (u1 + 2 * u2 + 2 * u3 + u4) / 6.0 * dt_
    dp_l = (u1 + u2 + u3) / 6.0 * dt_ * dt_
    return dq, dv_l, dp_l, 0.5 * dt * dt


def prefix_scan(combine, xs):
    """Inclusive prefix combination along axis 1 of every tensor in xs:
    out_k = x_0 . x_1 . ... . x_k for an associative combine(earlier, later).
    Hillis-Steele: log2(N) levels of batched combines (the counterpart of
    `jax.lax.associative_scan`; the grouping, so the rounding, differs)."""
    n = xs[0].shape[1]
    d = 1
    while d < n:
        later = combine(tuple(x[:, :-d] for x in xs), tuple(x[:, d:] for x in xs))
        xs = tuple(torch.cat([x[:, :d], y], dim=1) for x, y in zip(xs, later))
        d *= 2
    return xs


def quat_prefix(dqs):
    """(B,N,4) per-step rotations -> prefix products Q_k = dq_k (x) ... (x) dq_1."""
    return prefix_scan(lambda a, b: (lie.quat_multiply(b[0], a[0]),), (dqs,))[0]


def tree_fold(Fs, Qs):
    """Fold per-step (F, Q) stacks (...,N,n,n) into the window total with the
    binary tree (F2 F1, F2 Q1 F2^T + Q2) the JAX version uses."""
    n, dim = Fs.shape[-3], Fs.shape[-1]
    n_pad = 1 << max(int(math.ceil(math.log2(max(n, 1)))), 0)
    shp = Fs.shape[:-3] + (n_pad - n, dim, dim)
    eye = torch.eye(dim, dtype=Fs.dtype, device=Fs.device).expand(shp)
    Fs = torch.cat([Fs, eye], dim=-3)
    Qs = torch.cat([Qs, torch.zeros(shp, dtype=Qs.dtype, device=Qs.device)], dim=-3)
    while Fs.shape[-3] > 1:
        F1, F2 = Fs[..., 0::2, :, :], Fs[..., 1::2, :, :]
        Q1, Q2 = Qs[..., 0::2, :, :], Qs[..., 1::2, :, :]
        Fs = F2 @ F1
        Qc = F2 @ Q1 @ F2.transpose(-1, -2) + Q2
        Qs = 0.5 * (Qc + Qc.transpose(-1, -2))
    return Fs[..., 0, :, :], Qs[..., 0, :, :]


def propagate_arrays(q, p, v, bg, ba, q_fej, p_fej, v_fej,
                     imu_t, imu_w, imu_a, gravity, sigmas):
    """Advance the mean over the IMU stack and return the summed (Phi, Qd).

    q.. (B,4)/(B,3); imu_t (B,N), imu_w/imu_a (B,N,3); gravity (3,).
    Returns (q, p, v, Phi (B,15,15), Qd (B,15,15))."""
    dts = imu_t[:, 1:] - imu_t[:, :-1]
    w1 = imu_w[:, :-1] - bg[:, None]
    a1 = imu_a[:, :-1] - ba[:, None]
    w2 = imu_w[:, 1:] - bg[:, None]
    a2 = imu_a[:, 1:] - ba[:, None]

    dqs, dv_l, dp_l, gps = _rk4_local_increments(w1, a1, w2, a2, dts)
    pad = dts <= 0
    dqs = torch.where(pad[..., None], _id_quat(dqs), dqs)
    dv_l = torch.where(pad[..., None], 0.0, dv_l)
    dp_l = torch.where(pad[..., None], 0.0, dp_l)
    gps = torch.where(pad, 0.0, gps)
    dts = torch.where(pad, 0.0, dts)

    # prefix-composed orientation q_k = (dq_k (x) ... (x) dq_1) (x) q_0
    qs = lie.quat_norm(lie.quat_multiply(quat_prefix(dqs), q[:, None]))  # (B,N-1,4)
    q_starts = torch.cat([q[:, None], qs[:, :-1]], dim=1)
    RT = lie.quat_2_rot(q_starts).transpose(-1, -2)

    g = gravity[None, None, :]
    dvs = (RT @ dv_l[..., None])[..., 0] - g * dts[..., None]
    vs = v[:, None] + torch.cumsum(dvs, dim=1)
    v_starts = torch.cat([v[:, None], vs[:, :-1]], dim=1)
    dps = (v_starts * dts[..., None] + (RT @ dp_l[..., None])[..., 0]
           - g * gps[..., None])
    ps = p[:, None] + torch.cumsum(dps, dim=1)

    q_start = torch.cat([q_fej[:, None], qs[:, :-1]], dim=1)
    p_start = torch.cat([p_fej[:, None], ps[:, :-1]], dim=1)
    v_start = torch.cat([v_fej[:, None], vs[:, :-1]], dim=1)
    w_hats = imu_w[:, :-1] - bg[:, None]

    # transition/noise in f32, cancellation terms formed in f64 first
    dp_terms = ps - p_start - v_start * dts[..., None] + 0.5 * g * (dts**2)[..., None]
    dv_terms = vs - v_start + g * dts[..., None]
    sig32 = tuple(float(np.float32(s)) for s in sigmas)  # host scalars: no copy
    F_all, Qd_all = step_transition(
        q_start.to(F32), dp_terms.to(F32), dv_terms.to(F32), qs.to(F32),
        w_hats.to(F32), dts.to(F32), sig32)
    Phi, Qd = tree_fold(F_all, Qd_all)
    return qs[:, -1], ps[:, -1], vs[:, -1], Phi.to(q.dtype), Qd.to(q.dtype)


def propagate(state: FilterState, imu_t, imu_w, imu_a, t_end, gravity, sigmas) -> FilterState:
    """Propagate the full filter state to t_end (B,) given padded IMU stacks.

    gravity: (3,) float64 tensor on the state's device (a host array would
    be copied, and wait for the device, on every call)."""
    q, p, v, Phi, Qd = propagate_arrays(
        state.q, state.p, state.v, state.bg, state.ba,
        state.q_fej, state.p_fej, state.v_fej,
        imu_t, imu_w, imu_a, gravity, sigmas,
    )
    return state.replace(
        q=q, p=p, v=v, q_fej=q, p_fej=p, v_fej=v,
        bg_fej=state.bg, ba_fej=state.ba,
        cov=propagate_cov(state.cov, Phi, Qd),
        time=t_end,
    )


# ---------------------------------------------------------------------------
# host-side IMU buffer (bookkeeping only; math stays on device)
# ---------------------------------------------------------------------------

class ImuBuffer:
    """Host-side ring of IMU samples with boundary-interpolated selection.

    Mirrors Propagator::feed_imu / select_imu_readings / interpolate_data
    (Propagator.cpp:17-28, 92-152, 318-328) using numpy; produces fixed-size
    padded stacks for `propagate_arrays`.
    """

    def __init__(self, max_window: int = 4000):
        self.t = np.zeros(0)
        self.w = np.zeros((0, 3))
        self.a = np.zeros((0, 3))
        self.max_window = max_window

    def feed(self, t: float, w, a):
        self.t = np.append(self.t, t)
        self.w = np.vstack([self.w, np.asarray(w)[None]])
        self.a = np.vstack([self.a, np.asarray(a)[None]])
        if len(self.t) > self.max_window:
            cut = len(self.t) - self.max_window
            self.t, self.w, self.a = self.t[cut:], self.w[cut:], self.a[cut:]

    def prune(self, t_min: float):
        keep = self.t >= t_min
        # keep one sample before t_min for boundary interpolation
        first = int(np.argmax(keep)) if keep.any() else len(self.t)
        first = max(first - 1, 0)
        self.t, self.w, self.a = self.t[first:], self.w[first:], self.a[first:]

    @property
    def newest(self) -> float:
        return float(self.t[-1]) if len(self.t) else -np.inf

    @property
    def oldest(self) -> float:
        return float(self.t[0]) if len(self.t) else np.inf

    def _interp(self, i, j, t):
        lam = (t - self.t[i]) / (self.t[j] - self.t[i])
        w = (1 - lam) * self.w[i] + lam * self.w[j]
        a = (1 - lam) * self.a[i] + lam * self.a[j]
        return w, a

    def at(self, t: float):
        """Interpolated (w, a) at time t, or None if uncovered (the per-clone
        (omega, v) record behind the wheel dt-calibration column)."""
        if len(self.t) < 2 or t < self.t[0] or t > self.t[-1]:
            return None
        i = int(np.clip(np.searchsorted(self.t, t, side="right") - 1, 0, len(self.t) - 2))
        return self._interp(i, i + 1, t)

    def select(self, t0: float, t1: float, pad_to: int | None = None):
        """Samples covering [t0, t1] with interpolated boundary entries.

        Returns (t (N,), w (N,3), a (N,3)) or None if the request cannot be
        satisfied.  If pad_to is given, the stack is right-padded by repeating
        the final sample (dt = 0 entries are no-ops in the scan).
        """
        if len(self.t) < 2 or t1 <= t0 or self.t[0] > t0 or self.t[-1] < t1:
            return None
        mid = (self.t > t0) & (self.t < t1)
        ts, ws, as_ = [t0], [], []
        i0 = int(np.searchsorted(self.t, t0, side="right") - 1)
        w0, a0 = self._interp(i0, i0 + 1, t0)
        ws.append(w0)
        as_.append(a0)
        idx = np.nonzero(mid)[0]
        for i in idx:
            ts.append(self.t[i])
            ws.append(self.w[i])
            as_.append(self.a[i])
        i1 = int(np.searchsorted(self.t, t1, side="right") - 1)
        if self.t[i1] == t1:
            w1, a1 = self.w[i1], self.a[i1]
        else:
            w1, a1 = self._interp(i1, i1 + 1, t1)
        ts.append(t1)
        ws.append(w1)
        as_.append(a1)
        t_arr = np.asarray(ts)
        w_arr = np.asarray(ws)
        a_arr = np.asarray(as_)
        if pad_to is not None:
            n = len(t_arr)
            if n > pad_to:
                return None  # caller must use a bigger pad size
            reps = pad_to - n
            t_arr = np.concatenate([t_arr, np.full(reps, t_arr[-1])])
            w_arr = np.concatenate([w_arr, np.tile(w_arr[-1], (reps, 1))])
            a_arr = np.concatenate([a_arr, np.tile(a_arr[-1], (reps, 1))])
        return t_arr, w_arr, a_arr
