"""Continuous preintegration (port of plviwo_tpu/core/cpi.py).

The bias-linearized relative motion between a clone anchor and later times
(the reference's `ov_core::CpiV1` / `CpiV2`, used by its CPI-based
interpolation, State.cpp:1138-1155):

    R_k2tau  : rotation anchor -> tau (JPL frame map)
    alpha    : position preintegral  (p_tau = p_k + v_k dt - 0.5 g dt^2 +
               R_GtoIk^T alpha)
    beta     : velocity preintegral  (v_tau = v_k - g dt + R_GtoIk^T beta)

with the first-order bias Jacobians J_q = dR/dbg, J_a = dalpha/dba,
J_b = dalpha/dbg, H_a = dbeta/dba, H_b = dbeta/dbg.

JAX scans one window; here the windows are batch-first: imu_t (..., N),
imu_w / imu_a (..., N, 3) with any leading axes.  What a step needs from
its own samples (dt, the midpoint rates, exp, the SO(3) Jacobians, skews)
is computed for every step of every window at once; a Python loop then
walks the N - 1 steps of the recursion, each step batched over the
windows.  A dt <= 0 step (the repeated-last padding) keeps the carry as it
is through `torch.where`, so padding is a bit-identical no-op, as in JAX.
Each step's increments and bias Jacobians use the step-start rotation's
transpose (R, not R_new).
"""

from __future__ import annotations

import torch

from ..ops import lie

KEYS = ("R_k2tau", "alpha", "beta", "dt", "J_q", "J_a", "J_b", "H_a", "H_b", "w_tau")


def _steps(imu_t, imu_w, imu_a, bg_lin, ba_lin):
    """Per-step inputs for every step at once: dt (..., N-1), the midpoint
    w_hat, a_hat (..., N-1, 3), and w2 - bg_lin (the rate at each step's
    end)."""
    dt = imu_t[..., 1:] - imu_t[..., :-1]
    w2 = imu_w[..., 1:, :]
    w_hat = 0.5 * (imu_w[..., :-1, :] + w2) - bg_lin[..., None, :]
    a_hat = 0.5 * (imu_a[..., :-1, :] + imu_a[..., 1:, :]) - ba_lin[..., None, :]
    return dt, w_hat, a_hat, w2 - bg_lin[..., None, :]


def _scan(imu_t, imu_w, imu_a, bg_lin, ba_lin, v2: bool, last_only: bool = False):
    """The recursion over the window's N - 1 sample pairs.  Returns the dict
    of per-step stacks (..., N-1, .), or with last_only the last entries
    (..., .)."""
    lead = torch.broadcast_shapes(imu_t.shape[:-1], bg_lin.shape[:-1], ba_lin.shape[:-1])
    imu_t = imu_t.expand(lead + imu_t.shape[-1:])
    bg_lin, ba_lin = bg_lin.expand(lead + (3,)), ba_lin.expand(lead + (3,))
    dt, w_hat, a_hat, w_tau = _steps(imu_t, imu_w, imu_a, bg_lin, ba_lin)
    dtc, dtm = dt[..., None], dt[..., None, None]
    u = w_hat * dtc
    R_step = lie.exp_so3(-u)  # frame map tau -> tau + dt
    JrDt = lie.jr_so3(-u) * dtm
    sk_a = lie.skew(a_hat)
    if v2:  # the exact integrals of each step (CpiV2)
        Jl = lie.jl_so3(u)
        G2 = lie.gamma2_so3(u)
        Jla = (Jl @ a_hat[..., None])[..., 0]
        beta_inc = (Jla * dtc)[..., None]  # step-start-frame increments
        alpha_inc = ((G2 @ a_hat[..., None])[..., 0] * dtc * dtc)[..., None]
        sk_b = lie.skew(Jla)
        JlDt, G2Dt2 = Jl * dtm, G2 * dtm * dtm
        half_sk_a = sk_a * (0.5 * dtm)
        per_step = (dt, dtc, dtm, R_step, JrDt, sk_b, beta_inc, alpha_inc, JlDt, G2Dt2, half_sk_a)
    else:  # the midpoint rule (CpiV1)
        per_step = (dt, dtc, dtm, R_step, JrDt, sk_a, a_hat[..., None])
    axis = len(lead)
    per_step = [torch.unbind(x, dim=axis) for x in per_step]
    pads = torch.unbind(dt <= 0, dim=axis)

    dtype, dev = imu_w.dtype, imu_w.device
    R = torch.eye(3, dtype=dtype, device=dev).expand(lead + (3, 3))
    z3 = torch.zeros(lead + (3,), dtype=dtype, device=dev)
    z33 = torch.zeros(lead + (3, 3), dtype=dtype, device=dev)
    alpha, beta, J_q, J_a, J_b, H_a, H_b = z3, z3, z33, z33, z33, z33, z33
    DT = torch.zeros(lead, dtype=dtype, device=dev)
    outs = {k: [] for k in KEYS if k != "w_tau"}
    for i, pad in enumerate(pads):
        d, dc, dm, Rs, JrD, sk, *rest = (x[i] for x in per_step)
        Rt = R.transpose(-1, -2)  # anchor <- tau, at the step's start
        if v2:
            b_inc, a_inc, JlD, G2D2, hska = rest
            alpha_new = alpha + beta * dc + (Rt @ a_inc)[..., 0]
            beta_new = beta + (Rt @ b_inc)[..., 0]
            H_a_new = H_a - Rt @ JlD
            dRt_dbg = -Rt @ sk @ (-J_q) + Rt @ hska
            J_a_new = J_a + H_a * dm - Rt @ G2D2
        else:
            a_anchor = (Rt @ rest[0])[..., 0]
            alpha_new = alpha + beta * dc + 0.5 * a_anchor * dc * dc
            beta_new = beta + a_anchor * dc
            H_a_new = H_a - Rt * dm
            dRt_dbg = -Rt @ sk @ (-J_q)  # d(R^T a)/dtheta dtheta/dbg
            J_a_new = J_a + H_a * dm - 0.5 * Rt * dm * dm
        J_b_new = J_b + H_b * dm + 0.5 * dRt_dbg * dm * dm
        H_b_new = H_b + dRt_dbg * dm
        J_q_new = Rs @ J_q + JrD
        p3, p33 = pad[..., None], pad[..., None, None]
        R = torch.where(p33, R, Rs @ R)
        alpha, beta = torch.where(p3, alpha, alpha_new), torch.where(p3, beta, beta_new)
        J_q, J_a, J_b = (torch.where(p33, J_q, J_q_new), torch.where(p33, J_a, J_a_new),
                         torch.where(p33, J_b, J_b_new))
        H_a, H_b = torch.where(p33, H_a, H_a_new), torch.where(p33, H_b, H_b_new)
        DT = DT + torch.where(pad, 0.0, d)
        if not last_only:
            for k, v in zip(KEYS, (R, alpha, beta, DT, J_q, J_a, J_b, H_a, H_b)):
                outs[k].append(v)
    if last_only:
        return dict(zip(KEYS, (R, alpha, beta, DT, J_q, J_a, J_b, H_a, H_b,
                               w_tau.select(axis, -1))))
    out = {k: torch.stack(v, dim=axis) for k, v in outs.items()}
    out["w_tau"] = w_tau
    return out


def cpi_v1(imu_t, imu_w, imu_a, bg_lin, ba_lin):
    """CPI means and bias Jacobians over padded IMU windows, midpoint rule.

    imu_t (..., N), imu_w / imu_a (..., N, 3): windows starting at the
    clone anchor (boundary-interpolated, repeated-last padding); bg_lin,
    ba_lin (..., 3) (or broadcastable) the bias linearization points.
    Returns a dict of per-step stacks, entry i the state at imu_t[..., i+1]:
    R_k2tau (..., N-1, 3, 3), alpha, beta, w_tau (..., N-1, 3), dt
    (..., N-1), J_q, J_a, J_b, H_a, H_b (..., N-1, 3, 3)."""
    return _scan(imu_t, imu_w, imu_a, bg_lin, ba_lin, v2=False)


def cpi_v2(imu_t, imu_w, imu_a, bg_lin, ba_lin):
    """`cpi_v1` with the exact SO(3) integrals of each step (the CpiV2 idea,
    ov_core cpi/CpiV2.cpp):

        Dbeta = R^T [dt Jl(w dt)] a,     Dalpha = R^T [dt^2 Gamma2(w dt)] a,

    accurate at coarse sample rates where the midpoint rule degrades; the
    same outputs, and the bias Jacobians carry V1's recursions plus the
    within-step sensitivity of Jl(w dt) a to bg."""
    return _scan(imu_t, imu_w, imu_a, bg_lin, ba_lin, v2=True)


def cpi_v1_last(imu_t, imu_w, imu_a, bg_lin, ba_lin):
    """The last entry of each of `cpi_v1`'s stacks (..., .), without the
    stacks."""
    return _scan(imu_t, imu_w, imu_a, bg_lin, ba_lin, v2=False, last_only=True)


def predict_from_cpi(q_k, p_k, v_k, cpi_i, gravity):
    """The pose and velocity at tau from the anchor state and one CPI entry
    (the identity of the reference's Propagator.cpp:73).  q_k (..., 4),
    p_k, v_k (..., 3), cpi_i a dict of single entries.  Returns (R_GtoItau,
    p_tau, v_tau)."""
    R_GtoIk = lie.quat_2_rot(q_k)
    dt = cpi_i["dt"][..., None]
    RkT = R_GtoIk.transpose(-1, -2)
    p_tau = p_k + v_k * dt - 0.5 * gravity * dt * dt + (RkT @ cpi_i["alpha"][..., None])[..., 0]
    v_tau = v_k - gravity * dt + (RkT @ cpi_i["beta"][..., None])[..., 0]
    return cpi_i["R_k2tau"] @ R_GtoIk, p_tau, v_tau


def correct_for_bias(cpi_i, dbg, dba):
    """First-order re-linearization of one CPI entry for the bias deltas
    (the J/H Jacobians of the reference's CpiBase).  Returns the corrected
    (R_k2tau, alpha, beta)."""
    def mv(A, x):
        return (A @ x[..., None])[..., 0]

    R = lie.exp_so3(-mv(cpi_i["J_q"], dbg)) @ cpi_i["R_k2tau"]
    alpha = cpi_i["alpha"] + mv(cpi_i["J_a"], dba) + mv(cpi_i["J_b"], dbg)
    beta = cpi_i["beta"] + mv(cpi_i["H_a"], dba) + mv(cpi_i["H_b"], dbg)
    return R, alpha, beta
