"""Wheel-odometry rows (port of plviwo_tpu/update/wheel.py), batch-first.

2D and 3D RK4 preintegration of the relative odometry-frame pose between two
clones, with its noise covariance and intrinsic Jacobians, and the FEJ
linear system against the two bounding clones.  The recursions are
log-depth prefix scans and the 6x6 (Phi, Q) chain the JAX tree fold, as in
the JAX version; the 2D models (`preintegrate_2d`, `linear_system_2d`) and
the time-offset calibration column serve the per-track driver.
`WheelBuffer` is the host-side sample buffer the live
driver (`core/system.py`) selects padded windows from, and `wv_stack_np`
the IMU+wheel initializer's sample conversion, both in numpy, copies of the
JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.propagator import _blocks, _id_quat, _qdot, prefix_scan, quat_prefix, tree_fold
from ..ops import lie
from .cam_helper import _mv, gather_slots, one_hot

F64 = torch.float64

W2D_ANG, W2D_LIN, W2D_CEN, W3D_ANG, W3D_LIN, W3D_CEN = range(6)
TYPE_CODES = {
    "Wheel2DAng": W2D_ANG, "Wheel2DLin": W2D_LIN, "Wheel2DCen": W2D_CEN,
    "Wheel3DAng": W3D_ANG, "Wheel3DLin": W3D_LIN, "Wheel3DCen": W3D_CEN,
}


def _wv_from_meas(m1, m2, intr, type_code: int):
    """Angular rate (about z) and forward velocity from samples (B,N);
    intr (B,3) = [radius_left radius_right baseline]."""
    rl, rr, b = intr[:, 0:1], intr[:, 1:2], intr[:, 2:3]
    if type_code in (W2D_ANG, W3D_ANG):
        return (m2 * rr - m1 * rl) / b, (m2 * rr + m1 * rl) / 2.0
    if type_code in (W2D_LIN, W3D_LIN):
        return (m2 - m1) / b, (m2 + m1) / 2.0
    return m1, m2


def wv_stack_np(m1, m2, intr, type_code: int):
    """Host numpy: raw samples (M,) to odometry-frame rates and velocities
    (W (M,3), V (M,3)) for the IMU+wheel initializer (only w_z and v_x are
    observed)."""
    rl, rr, b = intr
    m1 = np.asarray(m1)
    m2 = np.asarray(m2)
    if type_code in (W2D_ANG, W3D_ANG):
        w = (m2 * rr - m1 * rl) / b
        v = (m2 * rr + m1 * rl) / 2.0
    elif type_code in (W2D_LIN, W3D_LIN):
        w = (m2 - m1) / b
        v = (m2 + m1) / 2.0
    else:
        w, v = m1, m2
    W = np.zeros((len(m1), 3))
    V = np.zeros((len(m1), 3))
    W[:, 2] = w
    V[:, 0] = v
    return W, V


def _rk4_local(wh1, vh1, wh2, vh2, dt, dt_safe):
    """Carry-free RK4 increments (dq, dp_l) of one step, batched over (...)."""
    dt_ = dt[..., None]
    w_alpha = (wh2 - wh1) / dt_safe[..., None]
    v_jerk = (vh2 - vh1) / dt_safe[..., None]
    dq_0 = _id_quat(wh1)

    def u_of(dq, v):
        return _mv(lie.quat_2_rot(dq).transpose(-1, -2), v)

    k1_q = _qdot(dq_0, wh1) * dt_
    u1 = u_of(dq_0, vh1)
    w_h = wh1 + 0.5 * w_alpha * dt_
    v_h = vh1 + 0.5 * v_jerk * dt_
    dq_1 = lie.quat_norm(dq_0 + 0.5 * k1_q)
    k2_q = _qdot(dq_1, w_h) * dt_
    u2 = u_of(dq_1, v_h)
    dq_2 = lie.quat_norm(dq_0 + 0.5 * k2_q)
    k3_q = _qdot(dq_2, w_h) * dt_
    u3 = u_of(dq_2, v_h)
    w_h = wh1 + w_alpha * dt_
    v_h = vh1 + v_jerk * dt_
    dq_3 = lie.quat_norm(dq_0 + k3_q)
    k4_q = _qdot(dq_3, w_h) * dt_
    u4 = u_of(dq_3, v_h)
    dq = lie.quat_norm(dq_0 + (k1_q + 2 * k2_q + 2 * k3_q + k4_q) / 6.0)
    return dq, (u1 + 2 * u2 + 2 * u3 + u4) / 6.0 * dt_


def preintegrate_3d(ts, m1s, m2s, intr, noise_w, noise_v, noise_p,
                    type_code: int, dtype=F64):
    """3D RK4 preintegration over padded stacks (repeated-last padding).

    ts/m1s/m2s (B,N+1), intr (B,3).  dtype is the internal precision (the
    interval-local math is safe in float32; dts are formed in float64
    first).  Returns float64 (R_O0toO1 (B,3,3), p_O1inO0 (B,3), Cov (B,6,6),
    dR_di (B,3,3), dp_di (B,3,3))."""
    Bsz, N = ts.shape[0], ts.shape[1] - 1
    dev = ts.device
    dts = (ts[:, 1:] - ts[:, :-1]).to(dtype)
    pad = dts <= 0
    dt_safe = torch.where(pad, 1.0, dts)
    m1s = m1s.to(dtype)
    m2s = m2s.to(dtype)
    intr = intr.to(dtype)
    b = intr[:, 2:3]

    w1s, v1s = _wv_from_meas(m1s[:, :-1], m2s[:, :-1], intr, type_code)
    w2s, v2s = _wv_from_meas(m1s[:, 1:], m2s[:, 1:], intr, type_code)
    z = torch.zeros_like(w1s)
    w_hat1 = torch.stack([z, z, w1s], -1)
    v_hat1 = torch.stack([v1s, z, z], -1)
    w_hat2 = torch.stack([z, z, w2s], -1)
    v_hat2 = torch.stack([v2s, z, z], -1)

    dqs, dp_l = _rk4_local(w_hat1, v_hat1, w_hat2, v_hat2, dts, dt_safe)
    dqs = torch.where(pad[..., None], _id_quat(dqs), dqs)
    dp_l = torch.where(pad[..., None], 0.0, dp_l)

    R_end = lie.quat_2_rot(quat_prefix(dqs))  # (B,N,3,3) end-of-step rotations
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    R_start = torch.cat([eye3.expand(Bsz, 1, 3, 3), R_end[:, :-1]], dim=1)
    RTs = R_start.transpose(-1, -2)

    ps = torch.cumsum(_mv(RTs, dp_l), dim=1)
    p_start = torch.cat([ps.new_zeros(Bsz, 1, 3), ps[:, :-1]], dim=1)

    # intrinsic Jacobians: affine recursion b_k = A_k b_{k-1} + bvec_k
    zN = torch.zeros_like(w1s)
    Hwx = torch.stack([
        torch.stack([zN, zN, zN], -1),
        torch.stack([zN, zN, zN], -1),
        torch.stack([-m1s[:, :-1] / b, m2s[:, :-1] / b, -w1s / b], -1),
    ], -2)
    Hvx = torch.stack([
        torch.stack([m1s[:, :-1] / 2.0, m2s[:, :-1] / 2.0, zN], -1),
        torch.stack([zN, zN, zN], -1),
        torch.stack([zN, zN, zN], -1),
    ], -2)
    u_steps = -w_hat1 * dts[..., None]
    Hth = lie.jl_so3(u_steps) * dts[..., None, None]
    padm = pad[..., None, None]
    A = torch.where(padm, eye3, lie.exp_so3(u_steps))
    bvec = torch.where(padm, 0.0, Hth @ Hwx)
    _, b_pre = prefix_scan(lambda e, l: (l[0] @ e[0], l[0] @ e[1] + l[1]), (A, bvec))
    dR_di = b_pre[:, -1]
    dR_start = torch.cat([b_pre.new_zeros(Bsz, 1, 3, 3), b_pre[:, :-1]], dim=1)

    skew_vdt = lie.skew(v_hat1 * dts[..., None])
    dp_terms = -RTs @ skew_vdt @ dR_start + RTs @ Hvx * dts[..., None, None]
    dp_di = torch.sum(torch.where(padm, 0.0, dp_terms), dim=1)

    # noise covariance: per-step (Phi, Q) folded by the tree reduction
    def full(x):
        return torch.full((Bsz,), float(x), dtype=dtype, device=dev)

    if type_code == W3D_ANG:
        qd = [full(noise_w**2), full(noise_p**2), full(noise_p**2),
              full(noise_w**2), full(noise_p**2), full(noise_p**2)]
    elif type_code == W3D_LIN:
        qd = [noise_v**2 / b[:, 0] ** 2, full(noise_p**2), full(noise_p**2),
              full(noise_v**2 / 4.0), full(noise_p**2), full(noise_p**2)]
    else:
        qd = [full(noise_w**2), full(noise_p**2), full(noise_p**2),
              full(noise_v**2), full(noise_p**2), full(noise_p**2)]
    qdiag = torch.stack(qd, dim=-1)  # (B,6)

    dloc = _mv(RTs, ps - p_start)
    Z3 = torch.zeros_like(R_start)
    I3 = eye3.expand(R_start.shape)
    Phi_tr = _blocks([[R_end @ RTs, Z3], [-RTs @ lie.skew(dloc), I3]])
    dtm = dts[..., None, None]
    Phi_ns = _blocks([[dtm * I3, Z3], [Z3, RTs * dtm]])
    Qd = Phi_ns @ (qdiag[:, None, :, None] / dt_safe[..., None, None]
                   * Phi_ns.transpose(-1, -2))
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    Phi_tr = torch.where(padm, eye6, Phi_tr)
    Qd = torch.where(padm, 0.0, Qd)
    _, Cov = tree_fold(Phi_tr, Qd)

    return (R_end[:, -1].to(F64), ps[:, -1].to(F64), Cov.to(F64),
            dR_di.to(F64), dp_di.to(F64))


def _relative_pose_system(clone_q, clone_p, clone_q_fej, clone_p_fej, slot0, slot1,
                          wheel_q, wheel_p):
    """The relative odometry-frame motion between two clones at the
    estimates, (R_O0toO1 (B,3,3), p_O1inO0 (B,3)), and its FEJ Jacobian
    blocks (B,6,6) wrt each clone's [dtheta, dp] (rows: rotation, position;
    UpdaterWheel.cpp:328-422), with the FEJ R_O0toO1 and the extrinsic."""
    R_ItoO = lie.quat_2_rot(wheel_q)
    RIT = R_ItoO.transpose(-1, -2)
    p_OinI = -_mv(RIT, wheel_p)

    R0 = lie.quat_2_rot(gather_slots(clone_q, slot0))
    R1 = lie.quat_2_rot(gather_slots(clone_q, slot1))
    p0, p1 = gather_slots(clone_p, slot0), gather_slots(clone_p, slot1)
    R0T, R1T = R0.transpose(-1, -2), R1.transpose(-1, -2)
    R_est = R_ItoO @ R1 @ R0T @ RIT
    p_est = _mv(R_ItoO @ R0, p1 + _mv(R1T, p_OinI) - p0 - _mv(R0T, p_OinI))

    R0f = lie.quat_2_rot(gather_slots(clone_q_fej, slot0))
    R1f = lie.quat_2_rot(gather_slots(clone_q_fej, slot1))
    p0f, p1f = gather_slots(clone_p_fej, slot0), gather_slots(clone_p_fej, slot1)
    R1fT = R1f.transpose(-1, -2)
    Z3 = torch.zeros_like(R0f)
    dzr_dth0 = -R_ItoO @ R1f @ R0f.transpose(-1, -2)
    dzp_dth0 = R_ItoO @ lie.skew(_mv(R0f, p1f) + _mv(R0f @ R1fT, p_OinI) - _mv(R0f, p0f))
    dzp_dp0 = -R_ItoO @ R0f
    dzp_dth1 = -R_ItoO @ R0f @ R1fT @ lie.skew(p_OinI)
    dzp_dp1 = R_ItoO @ R0f
    block0 = _blocks([[dzr_dth0, Z3], [dzp_dth0, dzp_dp0]])
    block1 = _blocks([[R_ItoO, Z3], [dzp_dth1, dzp_dp1]])
    R_f = R_ItoO @ R1f @ R0f.transpose(-1, -2) @ RIT
    return R_est, p_est, block0, block1, R_f, R_ItoO, R0f, p0f, p1f


def _clone_band(block0, block1, slot0, slot1, n_clones, clone_off, D):
    """Two clones' Jacobian blocks (B,n,6) placed in a zero (B,n,D) row stack."""
    oh0 = one_hot(slot0, n_clones, block0.dtype)
    oh1 = one_hot(slot1, n_clones, block0.dtype)
    Hc = (oh0[:, None, :, None] * block0[:, :, None, :]
          + oh1[:, None, :, None] * block1[:, :, None, :]).flatten(-2)
    B, n = Hc.shape[:2]
    return torch.cat([Hc.new_zeros(B, n, clone_off), Hc,
                      Hc.new_zeros(B, n, D - clone_off - 6 * n_clones)], dim=-1)


def _dt_column(block0, block1, w0, v0, w1, v1):
    """The time-offset column: the clone-rate chain J0 [w0; v0] + J1 [w1; v1]
    with (w_i, v_i) (B,3) the IMU body rate and global velocity recorded at
    the clone times (UpdaterWheel.cpp:302-315, 400-414)."""
    return (_mv(block0, torch.cat([w0, v0], dim=-1))
            + _mv(block1, torch.cat([w1, v1], dim=-1)))


def linear_system_3d(clone_q, clone_p, clone_q_fej, clone_p_fej, slot0, slot1,
                     wheel_q, wheel_p, R_meas, p_meas, dR_di, dp_di,
                     n_clones: int, clone_off: int, D: int,
                     wheel_ext_off: int = 0, wheel_int_off: int = 0,
                     do_calib_ext: bool = False, do_calib_int: bool = False,
                     wheel_dt_off: int = 0, do_calib_dt: bool = False,
                     w0=None, v0=None, w1=None, v1=None):
    """FEJ linear system of the 3D relative-pose wheel measurement
    (reference: compute_linear_system_3D, UpdaterWheel.cpp:328-422).

    Clone rings (B,C,.), slot0/slot1 (B,), wheel_q (B,4), wheel_p (B,3),
    R_meas (B,3,3), p_meas (B,3).  With do_calib_dt, the time-offset column
    at wheel_dt_off is the clone-rate chain of `_dt_column` (w0, v0, w1, v1
    (B,3)).  Returns H (B,6,D), res (B,6)."""
    R_est, p_est, block0, block1, RO0toO1, R_ItoO, R0f, p0f, p1f = _relative_pose_system(
        clone_q, clone_p, clone_q_fej, clone_p_fej, slot0, slot1, wheel_q, wheel_p)
    res_r = -lie.log_so3(R_meas @ R_est.transpose(-1, -2))
    res = torch.cat([res_r, p_meas - p_est], dim=-1)
    H = _clone_band(block0, block1, slot0, slot1, n_clones, clone_off, D)
    RO1toO0 = RO0toO1.transpose(-1, -2)
    p_IinO = wheel_p
    if do_calib_ext:
        eye = torch.eye(3, dtype=F64, device=H.device)
        H[:, 0:3, wheel_ext_off:wheel_ext_off + 3] = eye - RO0toO1
        H[:, 3:6, wheel_ext_off:wheel_ext_off + 3] = (
            lie.skew(_mv(R_ItoO @ R0f, p1f - p0f) - _mv(RO1toO0, p_IinO))
            + RO1toO0 @ lie.skew(p_IinO))
        H[:, 3:6, wheel_ext_off + 3:wheel_ext_off + 6] = -RO1toO0 + eye
    if do_calib_int:
        H[:, 0:3, wheel_int_off:wheel_int_off + 3] = -dR_di
        H[:, 3:6, wheel_int_off:wheel_int_off + 3] = -dp_di
    if do_calib_dt:
        H[:, :, wheel_dt_off] = _dt_column(block0, block1, w0, v0, w1, v1)
    return H, res


def preintegrate_2d(ts, m1s, m2s, intr, noise_w, noise_v, noise_p, type_code: int):
    """2D unicycle preintegration (reference: preintegration_2D,
    UpdaterWheel.cpp:504-646): RK4 on (theta, x, y) with the frame-rotation
    sign convention theta_dot = -w, x/y in the O0 frame.

    Each step's RK4 increments depend on its samples only, so they run for
    every step at once; the heading is their prefix sum, the position the
    prefix sum of the increments rotated by the heading before the step,
    and the covariance the binary-tree fold of the per-step (Phi, G Q G^T)
    (the JAX package runs one sequential scan).  ts/m1s/m2s (B,N+1) padded
    by repeating the last sample (dt = 0 steps are no-ops), intr (B,3).
    Returns float64 (th (B,), xy (B,2), Cov (B,3,3))."""
    dts = ts[:, 1:] - ts[:, :-1]
    pad = dts <= 0
    dt_safe = torch.where(pad, 1.0, dts)
    w1, v1 = _wv_from_meas(m1s[:, :-1], m2s[:, :-1], intr, type_code)
    w2, v2 = _wv_from_meas(m1s[:, 1:], m2s[:, 1:], intr, type_code)
    w_alpha = (w2 - w1) / dt_safe
    v_jerk = (v2 - v1) / dt_safe

    # RK4 (the reference's k1..k4 structure), carry-free
    k1_th, k1_x = -w1 * dts, v1 * dts
    w_h = w1 + 0.5 * w_alpha * dts
    v_h = v1 + 0.5 * v_jerk * dts
    th2 = 0.5 * k1_th
    k2_th = -w_h * dts
    k2_x, k2_y = v_h * torch.cos(th2) * dts, -v_h * torch.sin(th2) * dts
    th3 = 0.5 * k2_th
    k3_th = -w_h * dts
    k3_x, k3_y = v_h * torch.cos(th3) * dts, -v_h * torch.sin(th3) * dts
    w_h = w1 + w_alpha * dts
    v_h = v1 + v_jerk * dts
    th4 = k3_th
    k4_th = -w_h * dts
    k4_x, k4_y = v_h * torch.cos(th4) * dts, -v_h * torch.sin(th4) * dts
    dth = torch.where(pad, 0.0, (k1_th + 2 * k2_th + 2 * k3_th + k4_th) / 6.0)
    dx_l = torch.where(pad, 0.0, (k1_x + 2 * k2_x + 2 * k3_x + k4_x) / 6.0)
    dy_l = torch.where(pad, 0.0, (0.0 * dts + 2 * k2_y + 2 * k3_y + k4_y) / 6.0)

    # the heading before each step rotates its local increment into O0; th
    # carries the frame-rotation angle (-integral of w), the heading is -th
    th_end = torch.cumsum(dth, dim=1)
    th_prev = torch.cat([torch.zeros_like(th_end[:, :1]), th_end[:, :-1]], dim=1)
    c, s = torch.cos(-th_prev), torch.sin(-th_prev)
    x = torch.sum(c * dx_l - s * dy_l, dim=1)
    y = torch.sum(s * dx_l + c * dy_l, dim=1)

    # noise: transition wrt (th, x, y) and the injected (w, v, p) noise
    one, zero = torch.ones_like(dts), torch.zeros_like(dts)
    Phi = torch.stack([torch.stack([one, zero, zero], -1),
                       torch.stack([-s * dx_l - c * dy_l, one, zero], -1),
                       torch.stack([c * dx_l - s * dy_l, zero, one], -1)], -2)
    if type_code == W2D_CEN:
        qw = torch.full_like(intr[:, 0], noise_w**2)
        qv = torch.full_like(intr[:, 0], noise_v**2)
    else:
        rl, rr, b = intr[:, 0], intr[:, 1], intr[:, 2]
        qw = 2.0 * (noise_w * (rl + rr) / (2 * b)) ** 2 + noise_w**2
        qv = 2.0 * (noise_v * (rl + rr) / 4.0) ** 2 + noise_v**2
    G = torch.stack([torch.stack([dts, zero, zero], -1),
                     torch.stack([zero, c * dts, -s * dts], -1),
                     torch.stack([zero, s * dts, c * dts], -1)], -2)
    qd = torch.stack([qw, qv, torch.full_like(qw, noise_p**2)], -1)  # (B,3)
    GQG = G @ (qd[:, None, :, None] / dt_safe[..., None, None] * G.transpose(-1, -2))
    padm = pad[..., None, None]
    Phi = torch.where(padm, torch.eye(3, dtype=F64, device=ts.device), Phi)
    GQG = torch.where(padm, 0.0, 0.5 * (GQG + GQG.transpose(-1, -2)))
    _, Cov = tree_fold(Phi, GQG)
    return th_end[:, -1], torch.stack([x, y], dim=-1), Cov


def linear_system_2d(clone_q, clone_p, clone_q_fej, clone_p_fej, slot0, slot1,
                     wheel_q, wheel_p, th_meas, xy_meas,
                     n_clones: int, clone_off: int, D: int,
                     wheel_dt_off: int = 0, do_calib_dt: bool = False,
                     w0=None, v0=None, w1=None, v1=None):
    """3-row FEJ linear system of the planar relative-motion measurement
    (reference: compute_linear_system_2D, UpdaterWheel.cpp:223-322): rows
    [theta_z, x, y] of the 3D relative pose, h = [e3 . log(R_O0toO1),
    (p_O1inO0)_xy].  The JAX package takes the Jacobian with `jax.jacfwd`;
    in closed form, with w = log(R_O0toO1) at the FEJ clones,
    dtheta/dtheta_0 = e3^T Jl^-1(w)^T R_ItoO and dtheta/dtheta_1 =
    -e3^T Jl^-1(w) R_ItoO; the position rows are the 3D system's.  The
    optional time-offset column as `linear_system_3d`'s.  th_meas (B,),
    xy_meas (B,2).  Returns H (B,3,D), res (B,3)."""
    R_est, p_est, block0, block1, R_f, R_ItoO, _, _, _ = _relative_pose_system(
        clone_q, clone_p, clone_q_fej, clone_p_fej, slot0, slot1, wheel_q, wheel_p)
    pred = torch.cat([lie.log_so3(R_est)[:, 2:3], p_est[:, :2]], dim=-1)
    res = torch.cat([th_meas[:, None], xy_meas], dim=-1) - pred
    Jli = lie.jl_so3_inv(lie.log_so3(R_f))
    Z = torch.zeros_like(R_ItoO[:, 2:3])
    J0 = torch.cat([torch.cat([(Jli.transpose(-1, -2) @ R_ItoO)[:, 2:3], Z], -1),
                    block0[:, 3:5]], dim=-2)
    J1 = torch.cat([torch.cat([-(Jli @ R_ItoO)[:, 2:3], Z], -1), block1[:, 3:5]], dim=-2)
    H = _clone_band(J0, J1, slot0, slot1, n_clones, clone_off, D)
    if do_calib_dt:
        H[:, :, wheel_dt_off] = _dt_column(J0, J1, w0, v0, w1, v1)
    return H, res


class WheelBuffer:
    """Host-side wheel measurement buffer with split/interpolated selection
    (reference: select_wheel_data, UpdaterWheel.cpp:142-217)."""

    def __init__(self):
        self.t = np.zeros(0)
        self.m1 = np.zeros(0)
        self.m2 = np.zeros(0)

    def feed(self, t, m1, m2):
        self.t = np.append(self.t, t)
        self.m1 = np.append(self.m1, m1)
        self.m2 = np.append(self.m2, m2)

    def prune(self, t_min):
        keep = np.searchsorted(self.t, t_min, side="left")
        keep = max(keep - 1, 0)
        self.t, self.m1, self.m2 = self.t[keep:], self.m1[keep:], self.m2[keep:]

    def _interp(self, i, j, t):
        lam = (t - self.t[i]) / (self.t[j] - self.t[i])
        return ((1 - lam) * self.m1[i] + lam * self.m1[j],
                (1 - lam) * self.m2[i] + lam * self.m2[j])

    def select(self, t0, t1, pad_to=None):
        # coverage: a sample landing EXACTLY on t1 suffices (strict <, like
        # ImuBuffer.select) — the end boundary is taken directly, not
        # interpolated, when t[i1] == t1
        if len(self.t) < 2 or self.t[0] > t0 or self.t[-1] < t1 or t1 <= t0:
            return None
        ts, m1s, m2s = [t0], [], []
        i0 = int(np.searchsorted(self.t, t0, side="right") - 1)
        if self.t[i0] == t0:
            m1s.append(self.m1[i0]); m2s.append(self.m2[i0])
        else:
            a, b = self._interp(i0, i0 + 1, t0)
            m1s.append(a); m2s.append(b)
        mid = (self.t > t0) & (self.t < t1)
        for i in np.nonzero(mid)[0]:
            ts.append(self.t[i]); m1s.append(self.m1[i]); m2s.append(self.m2[i])
        i1 = int(np.searchsorted(self.t, t1, side="right") - 1)
        if self.t[i1] == t1:
            a, b = self.m1[i1], self.m2[i1]
        else:
            a, b = self._interp(i1, i1 + 1, t1)
        ts.append(t1); m1s.append(a); m2s.append(b)
        t_arr, m1_arr, m2_arr = np.asarray(ts), np.asarray(m1s), np.asarray(m2s)
        if pad_to is not None:
            n = len(t_arr)
            if n > pad_to:
                return None
            reps = pad_to - n
            t_arr = np.concatenate([t_arr, np.full(reps, t_arr[-1])])
            m1_arr = np.concatenate([m1_arr, np.full(reps, m1_arr[-1])])
            m2_arr = np.concatenate([m2_arr, np.full(reps, m2_arr[-1])])
        return t_arr, m1_arr, m2_arr
