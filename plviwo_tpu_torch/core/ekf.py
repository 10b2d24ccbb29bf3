"""EKF primitives (port of plviwo_tpu/core/ekf.py), batch-first.

Every function takes the leading sequence axis B on its tensors.  Padded or
rejected measurement rows are masked with `torch.where` (never multiplied
away), so a NaN in a masked row cannot poison the update.  Factorizations
run in native float64.
"""

from __future__ import annotations

import torch

from ..ops import lie
from ..ops.linalg import chol_equilibrated, chol_unrolled, inv_small, solve_psd
from .state import FilterState, free_clone_slot


def _sym(A):
    return 0.5 * (A + A.transpose(-1, -2))


def propagate_cov(cov, phi15, qd15):
    """IMU-block covariance propagation: P_II' = Phi P_II Phi^T + Qd,
    P_Ix' = Phi P_Ix.  cov (B,D,D), phi15/qd15 (B,15,15)."""
    pii = cov[:, :15, :15]
    new_pix = phi15 @ cov[:, :15, :]
    cov = cov.clone()
    cov[:, :15, :] = new_pix
    cov[:, :, :15] = new_pix.transpose(-1, -2)
    cov[:, :15, :15] = phi15 @ pii @ phi15.transpose(-1, -2) + qd15
    return _sym(cov)


def ekf_update(cov, H, r, r_diag, mask):
    """Masked EKF update.  cov (B,D,D), H (B,M,D), r/r_diag/mask (B,M).
    Returns (dx (B,D), new_cov (B,D,D))."""
    Hm = torch.where(mask[..., None], H, 0.0)
    rm = torch.where(mask, r, 0.0)
    Rm = torch.where(mask, r_diag, 1.0)
    PHt = cov @ Hm.transpose(-1, -2)  # (B,D,M)
    S = _sym(Hm @ PHt + torch.diag_embed(Rm))
    # Y = S^-1 [PHt^T | r] in one solve, then PHt Y = [K H P | dx] in one
    # matrix-matrix product: a separate matrix-vector product for dx sums in
    # another order at B = 1 than at B > 1 on the CPU
    Y = solve_psd(S, torch.cat([PHt.transpose(-1, -2), rm[..., None]], dim=-1))  # (B,M,D+1)
    P = PHt @ Y
    D = cov.shape[-1]
    return P[..., D], _sym(cov - P[..., :D])


def whiten(H, r, R_full):
    """Whiten a small dense-noise system to unit noise: (H', r') with
    L [H' r'] = [H r], L = chol(R_full).  H (B,n,D), r (B,n), R_full (B,n,n)."""
    L = chol_unrolled(R_full)
    n = L.shape[-1]
    Bm = torch.cat([H, r[..., None]], dim=-1)
    ys = []
    for j in range(n):
        acc = Bm[..., j, :]
        for i in range(j):
            acc = acc - L[..., j, i, None] * ys[i]
        ys.append(acc / L[..., j, j, None])
    Y = torch.stack(ys, dim=-2)
    return Y[..., :-1], Y[..., -1]


def chi2(cov, H, r, r_diag, mask):
    """chi^2 = r^T (H P H^T + R)^-1 r over the masked rows, per sequence."""
    Hm = torch.where(mask[..., None], H, 0.0)
    rm = torch.where(mask, r, 0.0)
    Rm = torch.where(mask, r_diag, 1.0)
    S = _sym(Hm @ cov @ Hm.transpose(-1, -2) + torch.diag_embed(Rm))
    return torch.sum(rm * solve_psd(S, rm), dim=-1)


def _dq(th):
    """Small-angle JPL error quaternion [th/2, 1], normalized. th: (...,3)."""
    return lie.quat_norm(torch.cat([0.5 * th, torch.ones_like(th[..., :1])], dim=-1))


def apply_dx(state: FilterState, dx) -> FilterState:
    """Apply an error-state correction dx (B,D) to the mean (FEJ untouched);
    quaternions take the JPL left-multiplicative update q' = dq (x) q."""
    lo = state.layout
    B, C = dx.shape[0], lo.n_clones
    out = dict(
        q=lie.quat_multiply(_dq(dx[:, lo.IMU_TH:lo.IMU_TH + 3]), state.q),
        p=state.p + dx[:, lo.IMU_P:lo.IMU_P + 3],
        v=state.v + dx[:, lo.IMU_V:lo.IMU_V + 3],
        bg=state.bg + dx[:, lo.IMU_BG:lo.IMU_BG + 3],
        ba=state.ba + dx[:, lo.IMU_BA:lo.IMU_BA + 3],
    )
    dclone = dx[:, lo.clone_off:lo.clone_off + 6 * C].reshape(B, C, 6)
    out["clone_q"] = lie.quat_multiply(_dq(dclone[..., 0:3]), state.clone_q)
    out["clone_p"] = state.clone_p + dclone[..., 3:6]

    ccd = lo.CAM_CALIB_DIM
    dcam = dx[:, lo.cam_off:lo.cam_off + ccd * lo.n_cams].reshape(B, lo.n_cams, ccd)
    out["cam_dt"] = state.cam_dt + dcam[..., 0]
    out["cam_q"] = lie.quat_multiply(_dq(dcam[..., 1:4]), state.cam_q)
    out["cam_p"] = state.cam_p + dcam[..., 4:7]
    out["cam_k"] = state.cam_k + dcam[..., 7:15]

    if lo.use_wheel:
        out["wheel_dt"] = state.wheel_dt + dx[:, lo.wheel_dt]
        out["wheel_q"] = lie.quat_multiply(
            _dq(dx[:, lo.wheel_ext:lo.wheel_ext + 3]), state.wheel_q)
        out["wheel_p"] = state.wheel_p + dx[:, lo.wheel_ext + 3:lo.wheel_ext + 6]
        out["wheel_k"] = state.wheel_k + dx[:, lo.wheel_int:lo.wheel_int + 3]
    if lo.n_gps > 0:
        gcd = lo.GPS_CALIB_DIM
        dgps = dx[:, lo.gps_off:lo.gps_off + gcd * lo.n_gps].reshape(B, lo.n_gps, gcd)
        out["gps_dt"] = state.gps_dt + dgps[..., 0]
        out["gps_p"] = state.gps_p + dgps[..., 1:4]
        out["wtoe_th"] = state.wtoe_th + dx[:, lo.wtoe_off]
        out["wtoe_p"] = state.wtoe_p + dx[:, lo.wtoe_off + 1:lo.wtoe_off + 4]
    if lo.max_slam > 0:
        dslam = dx[:, lo.slam_off:lo.slam_off + 3 * lo.max_slam]
        out["slam_p"] = state.slam_p + dslam.reshape(B, lo.max_slam, 3)
    return state.replace(**out)


def update(state: FilterState, H, r, r_diag, mask) -> FilterState:
    """Full EKF update: covariance + mean."""
    dx, new_cov = ekf_update(state.cov, H, r, r_diag, mask)
    return apply_dx(state, dx).replace(cov=new_cov)


def augment_clone(state: FilterState) -> FilterState:
    """Insert a stochastic clone of the current IMU pose into each sequence's
    first free slot (the caller marginalizes first so one exists)."""
    lo = state.layout
    cov = state.cov
    B, D = cov.shape[0], cov.shape[-1]
    slot = free_clone_slot(state)  # (B,)
    idx = lo.clone_off + 6 * slot[:, None] + torch.arange(6, device=cov.device)  # (B,6)
    cov = cov.scatter(1, idx[:, :, None].expand(B, 6, D), cov[:, 0:6, :])
    # the first 6 columns, read after the row write, include the new rows
    cov = cov.scatter(2, idx[:, None, :].expand(B, D, 6), cov[:, :, 0:6])

    sel = torch.arange(lo.n_clones, device=cov.device)[None, :] == slot[:, None]  # (B,C)
    s3 = sel[..., None]
    return state.replace(
        clone_q=torch.where(s3, state.q[:, None, :], state.clone_q),
        clone_p=torch.where(s3, state.p[:, None, :], state.clone_p),
        clone_q_fej=torch.where(s3, state.q_fej[:, None, :], state.clone_q_fej),
        clone_p_fej=torch.where(s3, state.p_fej[:, None, :], state.clone_p_fej),
        clone_t=torch.where(sel, state.time[:, None], state.clone_t),
        clone_valid=state.clone_valid | sel,
        clone_keyframe=state.clone_keyframe & ~sel,
        cov=cov,
    )


def marginalize_clone(state: FilterState, slot) -> FilterState:
    """Drop a clone per sequence: zero its covariance rows and columns and
    free the slot (reference: StateHelper::marginalize,
    StateHelper.cpp:235-303; there the matrix shrinks, here the slot is
    zeroed and recycled).  slot: int, the same in every sequence."""
    lo = state.layout
    dev = state.cov.device
    sel = (torch.arange(lo.n_clones, device=dev) == slot).expand(state.clone_valid.shape)
    band = torch.zeros(state.cov.shape[:2], dtype=torch.bool, device=dev)
    band[:, lo.clone_off:lo.clone_off + 6 * lo.n_clones] = torch.repeat_interleave(sel, 6, dim=1)
    cov = torch.where(band[:, :, None] | band[:, None, :], 0.0, state.cov)
    return state.replace(
        clone_valid=state.clone_valid & ~sel,
        clone_keyframe=state.clone_keyframe & ~sel,
        clone_t=torch.where(sel, torch.inf, state.clone_t),
        cov=cov,
    )


def marginalize_slam_slot(state: FilterState, slot) -> FilterState:
    """Free a SLAM landmark slot per sequence (reference: marginalize_slam,
    StateHelper.cpp:202-213): zero its covariance rows and columns, mark it
    invalid and its id -1.  slot: int, the same in every sequence."""
    lo = state.layout
    dev = state.cov.device
    sel = (torch.arange(lo.max_slam, device=dev) == slot).expand(state.slam_valid.shape)
    band = torch.zeros(state.cov.shape[:2], dtype=torch.bool, device=dev)
    band[:, lo.slam_off:] = torch.repeat_interleave(sel, 3, dim=1)
    return state.replace(
        slam_valid=state.slam_valid & ~sel,
        slam_id=torch.where(sel, -1, state.slam_id),
        cov=torch.where(band[:, :, None] | band[:, None, :], 0.0, state.cov),
    )


def nullspace_project(Hf, Hx, r):
    """Project per-feature linear systems onto the left nullspace of Hf.

    Hf (B,M,k) feature Jacobians, Hx (B,M,D), r (B,M).  Returns (Hx' (B,M,D),
    r' (B,M), row_valid (B,M) bool): a complete QR of Hf gives Q, the system
    is left-multiplied by Q^T, and the M - k rows of the nullspace part are
    rolled to the top, the k rows of Hf's range (invalid) to the bottom, so
    the output keeps its fixed size (reference: in-place Givens,
    StateHelper.cpp:616-629).  No ported path calls it: the gate/Gram kernel
    projects with its own reflectors."""
    M, k = Hf.shape[-2:]
    Q, _ = torch.linalg.qr(Hf, mode="complete")  # (B,M,M)
    Qt = Q.transpose(-1, -2)
    Hx2 = torch.roll(Qt @ Hx, -k, dims=-2)
    r2 = torch.roll((Qt @ r[..., None])[..., 0], -k, dims=-1)
    valid = torch.roll(torch.arange(M, device=Hf.device) >= k, -k).expand(r2.shape)
    return Hx2, r2, valid


def measurement_compress(H, r, mask):
    """Compress a tall stacked system to at most D rows (reference:
    measurement_compress_inplace, StateHelper.cpp:602-614): the masked rows'
    Gram system G = H^T H, c = H^T r through `compress_from_gram`, so
    H'^T H' = G and H'^T r' = c.  H (B,M,D), r and mask (B,M).  Returns
    (H', r', valid); a system of M <= D rows comes back masked and
    uncompressed, as in the JAX package."""
    Hm = torch.where(mask[..., None], H, 0.0)  # select, not multiply: NaN-safe
    rm = torch.where(mask, r, 0.0)
    if Hm.shape[-2] <= Hm.shape[-1]:
        return Hm, rm, mask
    G = Hm.transpose(-1, -2) @ Hm
    c = (Hm.transpose(-1, -2) @ rm[..., None])[..., 0]
    return compress_from_gram(G, c)


def compress_from_gram(G, c):
    """(G = H^T H, c = H^T r) -> compressed rows (H' = L^T, r' = L^-1 c).

    G (B,D,D), c (B,D), float64.  The equilibrated, jittered factor
    regularizes null directions; those rows get rc = 0 and are masked
    invalid (exact no-ops in the update)."""
    L, valid = chol_equilibrated(G)
    rc = torch.linalg.solve_triangular(L, c[..., None], upper=False)[..., 0]
    rc = torch.where(valid & torch.isfinite(rc), rc, 0.0)
    Hc = L.transpose(-1, -2) * valid[..., None, :].to(G.dtype)
    return Hc, rc, valid


def delayed_init(cov, H_x, H_n, r, r_diag, target_start: int, target_dim: int):
    """Initialize a new k-dof variable block from a linear system
    r = H_x dx + H_n dn + n, n ~ N(0, diag(r_diag)), dn the new variable's
    error (reference: StateHelper::initialize / initialize_invertible,
    StateHelper.cpp:357-600): rotate the system by the complete QR of H_n so
    its top k rows have an invertible H_n1, initialize the block from those,
    and update the existing states with the remaining rows.

    Batch-first, float64: cov (B,D,D), H_x (B,M,D), H_n (B,M,k), r and
    r_diag (B,M) (isotropic: r_diag[:, 0] is taken for every row, as the
    reference asserts).  Returns (new_cov, dx_full (B,D), dn (B,k), H_up,
    r_up, mask_up): the correction of the existing states from the update
    rows, the new variable's correction, and the residual system already
    applied."""
    k = target_dim
    ts = target_start
    Q, _ = torch.linalg.qr(H_n, mode="complete")
    Qt = Q.transpose(-1, -2)
    Hx2, Hn2, r2 = Qt @ H_x, Qt @ H_n, (Qt @ r[..., None])[..., 0]
    Hx1, Hn1, r1 = Hx2[:, :k], Hn2[:, :k], r2[:, :k]
    Hx_up, r_up = Hx2[:, k:], r2[:, k:]

    Hn1_inv = inv_small(Hn1)
    sigma = r_diag[:, :1]
    PxHt = cov @ Hx1.transpose(-1, -2)  # (B,D,k)
    eye = torch.eye(k, dtype=cov.dtype, device=cov.device)
    S1 = Hx1 @ PxHt + sigma[..., None] * eye
    P_nn = Hn1_inv @ S1 @ Hn1_inv.transpose(-1, -2)
    P_xn = -PxHt @ Hn1_inv.transpose(-1, -2)
    dn = (Hn1_inv @ r1[..., None])[..., 0]

    new_cov = cov.clone()
    new_cov[:, :, ts:ts + k] = P_xn
    new_cov[:, ts:ts + k, :] = P_xn.transpose(-1, -2)
    new_cov[:, ts:ts + k, ts:ts + k] = P_nn
    new_cov = _sym(new_cov)

    mask_up = torch.ones(r_up.shape, dtype=torch.bool, device=cov.device)
    dx_full, new_cov = ekf_update(new_cov, Hx_up, r_up, sigma.expand(r_up.shape), mask_up)
    return new_cov, dx_full, dn, Hx_up, r_up, mask_up
