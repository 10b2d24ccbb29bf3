"""On-manifold pose interpolation between clones (port of
plviwo_tpu/core/interp.py: the linear and polynomial interpolations, their
Jacobians and the per-track path's interpolation table).

The linear interpolation serves the GPS rows and the images-in frame's
dynamic-cloning point rows, which spread a measurement at an arbitrary time
over its two bounding clones.  The polynomial interpolation of order n
(`polynomial_pose`) fits n + 1 clones; `build_interp_table` evaluates it at
every measurement time of a per-track MSCKF update, with its Jacobian with
respect to the support clones and to the evaluation time.  The JAX package
takes those Jacobians by `jax.jacfwd`; here they are written in closed form
(`interpolate_rotation_jacobian`, `_poly_jacobian`), since a forward-mode
pass through `log_so3` and `exp_so3` costs hundreds of host operators a
call.  `build_cpi_table` is the IMU-preintegrated alternative to the
polynomial table (`use_imu_res`), with the same row format.
`bounding_clones` has no caller on a ported path (the rows find their
clones with `core/step._bound_times`).
"""

from __future__ import annotations

import torch

from ..ops import lie


def interpolate_pose_linear(q0, p0, q1, p1, lam):
    """Geodesic interpolation between two JPL poses (...,4), (...,3) at
    fraction lam (...,) in [0, 1]:

        R(lam) = exp(lam log(R1 R0^T)) R0,   p(lam) = (1 - lam) p0 + lam p1.

    Returns (R (...,3,3), p (...,3))."""
    R0 = lie.quat_2_rot(q0)
    R1 = lie.quat_2_rot(q1)
    w = lie.log_so3(R1 @ R0.transpose(-1, -2))
    R_t = lie.exp_so3(lam[..., None] * w) @ R0
    p_t = (1.0 - lam[..., None]) * p0 + lam[..., None] * p1
    return R_t, p_t


def interpolate_rotation_jacobian(q0, q1, lam):
    """The interpolated rotation R(lam) and how it moves with the two
    clones' JPL attitude errors (R_i' = (I - [dtheta_i]x) R_i).

    With w = log(R1 R0^T) and E = exp(lam w), a left perturbation psi of
    R(lam) (R(lam)' = exp(psi) R(lam)) is

      psi = (lam Jl(lam w) Jr^-1(w) - E) dtheta0 - lam Jl(lam w) Jl^-1(w) dtheta1

    (Jr^-1(w) = Jl^-1(w)^T); the position p(lam) moves by (1 - lam) dp0 +
    lam dp1.  q0, q1 (...,4), lam (...,).  Returns (R (...,3,3),
    J0 (...,3,3), J1 (...,3,3)) with psi = J0 dtheta0 + J1 dtheta1."""
    R0 = lie.quat_2_rot(q0)
    w = lie.log_so3(lie.quat_2_rot(q1) @ R0.transpose(-1, -2))
    lw = lam[..., None] * w
    E = lie.exp_so3(lw)
    lJ = lam[..., None, None] * lie.jl_so3(lw)
    Jli = lie.jl_so3_inv(w)
    return E @ R0, lJ @ Jli.transpose(-1, -2) - E, -(lJ @ Jli)


def _powers(x, n: int):
    """[x^0, x^1, ..., x^n] (...,n+1) by repeated products.

    Each product is correctly rounded on every device, so the card and the
    CPU build the same Vandermonde bit for bit.  A `pow` with a tensor
    exponent is not correctly rounded on the card (x ** 1.0 is not always
    x), and through these weights its rounding about doubled the per-track
    filter's trajectory error on the card without wheel rows (ROADMAP.md,
    hazards)."""
    out = [torch.ones_like(x)]
    for _ in range(n):
        out.append(out[-1] * x)
    return torch.stack(out, dim=-1)


def _poly_weights(dts, dt_eval):
    """Weights of the order-n polynomial through the n clones after the
    anchor, and their time derivative: with the Vandermonde V (tau_i^j) in
    normalized time tau = dt / dts[-1], the fitted curve at dt_eval is
    sum_i a_i x_i for the clones' offsets x_i from the anchor, a = ev V^-1
    with ev = (dt_eval / dts[-1])^j, j = 1..n.  dts (...,n), dt_eval (...).
    Returns (a (...,n), da/d(dt_eval) (...,n))."""
    n = dts.shape[-1]
    scale = torch.clamp(dts[..., -1:], min=1e-9)
    j = torch.arange(1, n + 1, dtype=dts.dtype, device=dts.device)
    V = _powers(dts / scale, n)[..., 1:]  # (...,n,n)
    xp = _powers(dt_eval / scale[..., 0], n)
    ev = xp[..., 1:]
    dev = j * xp[..., :-1] / scale
    V_inv, _ = torch.linalg.inv_ex(V)  # no singularity check, so no host sync
    return (ev[..., None, :] @ V_inv)[..., 0, :], (dev[..., None, :] @ V_inv)[..., 0, :]


def polynomial_pose(q0, p0, qs, ps, dts, dt_eval):
    """Order-n on-manifold polynomial interpolation (MINS-style; reference:
    State::add_polynomial, State.cpp:725-798): theta(dt) = sum_i c_i dt^i
    through the SO(3) log-differences of n later clones from the anchor
    (q0, p0), likewise for position,

        R(dt) = exp(theta(dt)) R_0,   p(dt) = p_0 + sum_i d_i dt^i,

    with the Vandermonde in normalized time (condition number O(1) for any
    clone spacing).  q0 (...,4), p0 (...,3), qs (...,n,4), ps (...,n,3),
    dts (...,n) offsets from the anchor, dt_eval (...).  Returns
    (R_t (...,3,3), p_t (...,3))."""
    R0 = lie.quat_2_rot(q0)
    th = lie.log_so3(lie.quat_2_rot(qs) @ R0[..., None, :, :].transpose(-1, -2))  # (...,n,3)
    a, _ = _poly_weights(dts, dt_eval)
    th_t = (a[..., None, :] @ th)[..., 0, :]
    p_t = p0 + (a[..., None, :] @ (ps - p0[..., None, :]))[..., 0, :]
    return lie.exp_so3(th_t) @ R0, p_t


def _poly_k(q_sup, p_sup, dts, dt_eval):
    """`polynomial_pose` over a (...,K) support set whose first clone is the
    anchor (dts[..., 0] = 0).  Returns (R_t, p_t)."""
    return polynomial_pose(q_sup[..., 0, :], p_sup[..., 0, :], q_sup[..., 1:, :],
                           p_sup[..., 1:, :], dts[..., 1:], dt_eval)


def _poly_jacobian(q_sup, p_sup, dts, dt_eval):
    """The interpolated pose of `_poly_k` and its Jacobian in closed form.

    The output's rotation error psi and each support clone's attitude error
    dtheta_k are JPL left-multiplicative (R' = (I - [psi]x) R), positions
    additive.  With w_i = log(R_i R_0^T), th = sum_i a_i w_i and
    E = exp(th):

      dpsi/dtheta_0 = E - Jl(th) sum_i a_i Jl^-1(w_i)^T,
      dpsi/dtheta_i = a_i Jl(th) Jl^-1(w_i),
      dp/dp_0 = (1 - sum_i a_i) I,   dp/dp_i = a_i I,
      d[psi, p]/d(dt_eval) = [-Jl(th) sum_i a'_i w_i, sum_i a'_i (p_i - p_0)].

    Returns (R_t (...,3,3), p_t (...,3), J (...,6,K,6), Jt (...,6))."""
    R0 = lie.quat_2_rot(q_sup[..., 0, :])
    w = lie.log_so3(lie.quat_2_rot(q_sup[..., 1:, :]) @ R0[..., None, :, :].transpose(-1, -2))
    a, da = _poly_weights(dts[..., 1:], dt_eval)
    th = (a[..., None, :] @ w)[..., 0, :]
    dp = p_sup[..., 1:, :] - p_sup[..., :1, :]
    E = lie.exp_so3(th)
    Jl = lie.jl_so3(th)
    Jli = lie.jl_so3_inv(w)  # (...,n,3,3)
    aJ = Jl[..., None, :, :] @ (a[..., None, None] * Jli)  # (...,n,3,3)
    rot0 = E - Jl @ torch.sum(a[..., None, None] * Jli.transpose(-1, -2), dim=-3)
    rot = torch.cat([rot0[..., None, :, :], aJ], dim=-3)  # (...,K,3,3)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    wpos = torch.cat([1.0 - torch.sum(a, -1, keepdim=True), a], dim=-1)  # (...,K)
    pos = wpos[..., None, None] * eye  # (...,K,3,3)
    zero = torch.zeros_like(pos)
    J = torch.cat([torch.cat([rot, zero], -1), torch.cat([zero, pos], -1)], -2)  # (...,K,6,6)
    Jt = torch.cat([-(Jl @ (da[..., None, :] @ w)[..., 0, :, None])[..., 0],
                    (da[..., None, :] @ dp)[..., 0, :]], dim=-1)
    p_t = p_sup[..., 0, :] + (a[..., None, :] @ dp)[..., 0, :]
    return E @ R0, p_t, J.transpose(-3, -2), Jt


def build_interp_table(clone_q, clone_p, clone_q_fej, clone_p_fej, sup_slot, sup_dt, dt_eval,
                       K: int, n_clones: int):
    """Interpolated poses and FEJ Jacobians for a table of measurement times
    (reference: the cached get_interpolated_jacobian per time,
    State.cpp:833-973): the per-feature camera chain then multiplies
    against a cached 6 x 6C block.

    clone_q/p (B,C,4)/(B,C,3) and their FEJ mirrors; sup_slot (B,T,K) long,
    the support clones of each time ascending in time; sup_dt (B,T,K) their
    offsets from sup_slot[..., 0] (sup_dt[..., 0] = 0); dt_eval (B,T) the
    evaluation offset from that anchor; K = order + 1.  Returns tq (B,T,4),
    tp (B,T,3) at the estimates (residuals), tq_f, tp_f at the FEJ values,
    tJ (B,T,6,6C) d[psi, p]/d[clone errors] in the clone band, and tJt
    (B,T,6) d[psi, p]/d(dt_eval)."""
    def at(ring):
        bidx = torch.arange(ring.shape[0], device=ring.device)[:, None, None]
        return ring[bidx, sup_slot]  # (B,T,K,.)

    R_t, p_t = _poly_k(at(clone_q), at(clone_p), sup_dt, dt_eval)
    R_tf, p_tf, J, Jt = _poly_jacobian(at(clone_q_fej), at(clone_p_fej), sup_dt, dt_eval)
    onehot = (sup_slot[..., None] == torch.arange(n_clones, device=sup_slot.device)).to(J.dtype)
    tJ = torch.einsum("btokj,btkc->btocj", J, onehot).reshape(J.shape[:3] + (6 * n_clones,))
    return lie.rot_2_quat(R_t), p_t, lie.rot_2_quat(R_tf), p_tf, tJ, Jt


def build_cpi_table(clone_q, clone_p, clone_q_fej, clone_p_fej, anchor_slot, anchor_v,
                    imu_t, imu_w, imu_a, bg, ba, gravity, n_clones: int):
    """The CPI-interpolated pose table, `use_imu_res`'s alternative to
    `build_interp_table` (reference: State::get_interpolated_pose_imu and the
    CPI side-band, State.cpp:1138-1155, Propagator.cpp:63-82).

    Each time anchors at the clone at or before it; its pose is the CPI
    preintegral (`cpi.cpi_v1`, its last entry) from the anchor over that time's IMU window:
        R_t = R_k2tau R_a,   p_t = p_a + v_a dt - 0.5 g dt^2 + R_a^T alpha.
    The FEJ Jacobian with respect to the anchor clone is the 6 x 6 block
    dtheta_t/dtheta_a = R_k2tau, dp_t/dp_a = I, dp_t/dtheta_a =
    -R_a(fej)^T [alpha]x, placed in the clone band by the anchor's one-hot;
    the anchor velocity is the recorded propagated estimate, not a state.

    clone_q/p (B,C,4)/(B,C,3) and their FEJ mirrors; anchor_slot (B,T) long,
    anchor_v (B,T,3); imu_t (B,T,N), imu_w / imu_a (B,T,N,3) the padded
    windows from the anchor time to each time; bg, ba (B,3); gravity (3,).
    Returns the row format of `build_interp_table`: tq (B,T,4), tp (B,T,3),
    tq_f, tp_f, tJ (B,T,6,6C), tJt (B,T,6) (the body rate and velocity at
    the time)."""
    from .cpi import cpi_v1_last

    cpi = cpi_v1_last(imu_t, imu_w, imu_a, bg[:, None], ba[:, None])
    R_rel, alpha, beta, dt, w_tau = (cpi[k] for k in ("R_k2tau", "alpha", "beta", "dt", "w_tau"))
    bidx = torch.arange(clone_q.shape[0], device=clone_q.device)[:, None]
    dtc = dt[..., None]
    fall = 0.5 * gravity * dtc * dtc

    def pose(q_ring, p_ring):
        R_a = lie.quat_2_rot(q_ring[bidx, anchor_slot])
        RaT = R_a.transpose(-1, -2)
        p_t = p_ring[bidx, anchor_slot] + anchor_v * dtc - fall + (RaT @ alpha[..., None])[..., 0]
        return R_rel @ R_a, p_t, RaT

    R_t, p_t, RaT = pose(clone_q, clone_p)
    R_tf, p_tf, RafT = pose(clone_q_fej, clone_p_fej)
    eye = torch.eye(3, dtype=R_rel.dtype, device=R_rel.device).expand(R_rel.shape)
    zero = torch.zeros_like(R_rel)
    block = torch.cat([torch.cat([R_rel, zero], -1),
                       torch.cat([-RafT @ lie.skew(alpha), eye], -1)], -2)  # (B,T,6,6)
    onehot = (anchor_slot[..., None] == torch.arange(n_clones, device=anchor_slot.device))
    tJ = (onehot.to(block.dtype)[..., None, :, None] * block[..., :, None, :]).reshape(
        block.shape[:2] + (6, 6 * n_clones))
    v_t = anchor_v - gravity * dtc + (RaT @ beta[..., None])[..., 0]
    Jt = torch.cat([w_tau, v_t], dim=-1)
    return lie.rot_2_quat(R_t), p_t, lie.rot_2_quat(R_tf), p_tf, tJ, Jt


def bounding_clones(clone_t, clone_valid, t):
    """Slots of the clones bounding times t (B,) among clone_t / clone_valid
    (B,C) (masked argmax / argmin, first index among ties).

    Returns (slot0, slot1, lam, ok), each (B,): t(slot0) <= t <= t(slot1);
    when t matches a clone exactly, slot0 == slot1 and lam == 0."""
    t = t[..., None]
    t_arr = torch.where(clone_valid, clone_t, torch.inf)
    older = torch.where(t_arr <= t, t_arr, -torch.inf)
    slot0 = torch.argmax(older, dim=-1)
    t0 = torch.gather(older, -1, slot0[..., None])[..., 0]
    newer = torch.where(t_arr >= t, t_arr, torch.inf)
    slot1 = torch.argmin(newer, dim=-1)
    t1 = torch.gather(newer, -1, slot1[..., None])[..., 0]
    t = t[..., 0]
    ok = torch.isfinite(t0) & torch.isfinite(t1)
    denom = torch.where(t1 > t0, t1 - t0, torch.ones_like(t))
    lam = torch.where(t1 > t0, (t - t0) / denom, torch.zeros_like(t))
    return slot0, slot1, lam, ok
