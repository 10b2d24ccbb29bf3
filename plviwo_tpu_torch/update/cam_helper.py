"""Camera point-measurement math (port of plviwo_tpu/update/cam_helper.py).

Batch-first: every tensor carries the sequence axis B in front of the JAX
shapes, e.g. observations are (B, F, O, ...) and clone rings (B, C, ...).

Conventions: clone pose q_GtoI (JPL), p_IinG; extrinsic q_ItoC, p_IinC;
p_C = R_ItoC R_GtoI (p_f - p_I) + p_IinC; residual r = uv_meas - distort(p_C)
in raw pixels.  Jacobians are evaluated at the clone FEJ values.
"""

from __future__ import annotations

import torch

from ..core.interp import interpolate_pose_linear, interpolate_rotation_jacobian
from ..ops import cam as cam_ops
from ..ops import lie
from ..ops.linalg import chi2_quadform, eigvals_sym3x3, solve3x3


# landmark error-state representations (reference: LandmarkRepresentation and
# CamHelper.cpp:21-56, GLOBAL_3D / GLOBAL_FULL_INVERSE_DEPTH)
REP_GLOBAL_3D = 0
REP_GLOBAL_INVERSE_DEPTH = 1
REP_CODES = {"GLOBAL_3D": REP_GLOBAL_3D, "GLOBAL_FULL_INVERSE_DEPTH": REP_GLOBAL_INVERSE_DEPTH}


def _nonzero(x):
    return torch.where(torch.abs(x) < 1e-12, 1e-12, x)


def rep_to_xyz(rep_p, rep: int):
    """Representation vector (...,3) -> global xyz; inverse depth
    (a, b, rho) -> (a/rho, b/rho, 1/rho)."""
    if rep == REP_GLOBAL_3D:
        return rep_p
    rho = rep_p[..., 2:3]
    return torch.cat([rep_p[..., 0:2], torch.ones_like(rho)], -1) / _nonzero(rho)


def xyz_to_rep(p, rep: int):
    """Global xyz (...,3) -> the representation vector (rep_to_xyz's inverse)."""
    if rep == REP_GLOBAL_3D:
        return p
    z = _nonzero(p[..., 2:3])
    return torch.cat([p[..., 0:2] / z, torch.ones_like(z) / z], -1)


def rep_jacobian(rep_p, rep: int):
    """d(xyz)/d(rep) (...,3,3) at the representation value (the chain the
    reference inserts at CamHelper.cpp:21-56)."""
    if rep == REP_GLOBAL_3D:
        return torch.eye(3, dtype=rep_p.dtype, device=rep_p.device).expand(rep_p.shape + (3,))
    a, b = rep_p[..., 0], rep_p[..., 1]
    inv = 1.0 / _nonzero(rep_p[..., 2])
    inv2 = inv * inv
    z = torch.zeros_like(a)
    return torch.stack([torch.stack([inv, z, -a * inv2], -1),
                        torch.stack([z, inv, -b * inv2], -1),
                        torch.stack([z, z, -inv2], -1)], -2)


def _mv(A, x):
    """Batched matrix-vector product with broadcasting: (...,n,m) (...,m)."""
    return (A @ x[..., None])[..., 0]


def _eye3(like):
    return torch.eye(3, dtype=like.dtype, device=like.device)


def one_hot(idx, n: int, dtype):
    """(...,) integer indices -> (...,n) one-hot rows (a comparison, so no
    index check reads back to the host)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def repeat_each(x, n: int):
    """Repeat every entry of the last axis n times: (...,K) -> (...,nK)."""
    return x[..., None].expand(x.shape + (n,)).reshape(x.shape[:-1] + (-1,))


def gather_slots(ring, slot):
    """ring (B,C,...) indexed by slot (B,...) -> (B,...,...)."""
    bidx = torch.arange(ring.shape[0], device=ring.device)
    bidx = bidx.view((-1,) + (1,) * (slot.ndim - 1))
    return ring[bidx, slot]


def _cam_pose_in_g(q_clone, p_clone, cam_q, cam_p):
    """R_GtoC (...,3,3) and camera center c in G (...,3)."""
    R_GtoC = lie.quat_2_rot(cam_q) @ lie.quat_2_rot(q_clone)
    return R_GtoC, p_clone - _mv(R_GtoC.transpose(-1, -2), cam_p)


def triangulate_batch(obs_uvn, obs_q, obs_p, obs_valid, cam_q, cam_p,
                      min_dist=0.1, max_dist=200.0, max_cond=10000.0,
                      gn_iters: int = 5):
    """Batched linear triangulation + fixed-iteration Gauss-Newton refine.

    obs_uvn (B,F,O,2), obs_q (B,F,O,4), obs_p (B,F,O,3), obs_valid (B,F,O);
    the camera extrinsics cam_q, cam_p either one per sequence, (B,4) and
    (B,3), or one per observation, (B,F,O,4) and (B,F,O,3) (stereo).
    Returns p_f (B,F,3), ok (B,F), avg_err (B,F)."""
    cq = cam_q if cam_q.ndim == 4 else cam_q[:, None, None, :]
    cp = cam_p if cam_p.ndim == 4 else cam_p[:, None, None, :]
    R_GtoC, c = _cam_pose_in_g(obs_q, obs_p, cq, cp)
    b_C = torch.cat([obs_uvn, torch.ones_like(obs_uvn[..., :1])], dim=-1)
    b_C = b_C / torch.linalg.vector_norm(b_C, dim=-1, keepdim=True)
    b_G = _mv(R_GtoC.transpose(-1, -2), b_C)

    eye = _eye3(obs_uvn)
    m = obs_valid[..., None, None]
    P_perp = torch.where(m, eye - b_G[..., :, None] * b_G[..., None, :], 0.0)
    A = torch.sum(P_perp, dim=2)
    rhs = torch.sum(_mv(P_perp, c), dim=2)

    eigs = eigvals_sym3x3(A)
    cond = eigs[..., 2] / torch.clamp(eigs[..., 0], min=1e-12)
    p_f = solve3x3(A + 1e-9 * eye, rhs)

    vmask = obs_valid[..., None]

    def reproj_err(p_f):
        p_C = _mv(R_GtoC, p_f[:, :, None, :] - obs_p) + cp
        z = torch.clamp(p_C[..., 2], min=1e-6)
        e = torch.where(vmask, p_C[..., :2] / z[..., None] - obs_uvn, 0.0)
        return e, p_C

    for _ in range(gn_iters):
        e, p_C = reproj_err(p_f)
        z = torch.clamp(p_C[..., 2], min=1e-6)
        x, y = p_C[..., 0], p_C[..., 1]
        zero = torch.zeros_like(z)
        dzn = torch.stack([
            torch.stack([1.0 / z, zero, -x / z**2], -1),
            torch.stack([zero, 1.0 / z, -y / z**2], -1),
        ], -2)
        J = torch.where(obs_valid[..., None, None], dzn @ R_GtoC, 0.0)  # (B,F,O,2,3)
        JtJ = torch.einsum("bfoik,bfoil->bfkl", J, J) + 1e-6 * eye
        Jte = torch.einsum("bfoik,bfoi->bfk", J, e)
        p_f = p_f - solve3x3(JtJ, Jte)

    e, p_C = reproj_err(p_f)
    n_valid = torch.sum(obs_valid, dim=2)
    avg_err = (torch.sum(torch.linalg.vector_norm(e, dim=-1), dim=2)
               / torch.clamp(n_valid, min=1))
    depths = p_C[..., 2]
    depth_ok = torch.all(
        torch.where(obs_valid, (depths > min_dist) & (depths < max_dist), True), dim=2)
    ok = depth_ok & (cond < max_cond) & (n_valid >= 2)
    ok = ok & torch.all(torch.isfinite(p_f), dim=-1)
    return p_f, ok, avg_err


def _scatter_clone_band(block, slot, n_clones, clone_off, D, block1=None, slot1=None):
    """Place per-observation clone Jacobian blocks (...,R,6) at their slot's
    columns of a zero (...,R,D) row stack (one-hot over the clone ring).
    With block1 and slot1 a second block is placed the same way and the two
    are summed (an interpolated pose's two bounding clones; they add up
    where the slots coincide)."""
    def band(b, s):  # (...,R,C,6)
        return one_hot(s, n_clones, b.dtype)[..., None, :, None] * b[..., :, None, :]

    Hc = band(block, slot) if block1 is None else band(block, slot) + band(block1, slot1)
    Hc = Hc.flatten(-2)  # (...,R,6C)
    pre = block.new_zeros(Hc.shape[:-1] + (clone_off,))
    post = block.new_zeros(Hc.shape[:-1] + (D - clone_off - 6 * n_clones,))
    return torch.cat([pre, Hc, post], dim=-1)


def _dzn_dpc(p_C, z):
    """d(zn)/d(p_C) (...,2,3) of zn = p_C[:2] / z."""
    x, y = p_C[..., 0], p_C[..., 1]
    zero = torch.zeros_like(z)
    return torch.stack([
        torch.stack([1.0 / z, zero, -x / z**2], -1),
        torch.stack([zero, 1.0 / z, -y / z**2], -1),
    ], -2)


def _duv_dzn(zn, ck, model):
    """d(pixel)/d(zn) (...,2,2) in closed form: the focal lengths times the
    distortion model's d(distorted zn)/d(zn) (the intrinsics Jacobian of
    cam_ops.distort_jacobian is taken only where calibration rows need it)."""
    jac = cam_ops._jac_radtan if model == cam_ops.RADTAN else cam_ops._jac_equi
    return ck[..., 0:2, None] * jac(zn, ck)


def _point_systems(p_f, obs_uv, obs_slot, obs_valid, clone_q, clone_p, clone_q_fej,
                   clone_p_fej, R_ItoC, cp, ck, model, n_clones, clone_off, D):
    """`point_systems_batch` with the camera's R_ItoC (...,3,3), p_IinC
    (...,3) and intrinsics (...,8) broadcast against (B,F,O)."""
    B, F, O = obs_slot.shape
    pf = p_f[:, :, None, :]
    q_cl, p_cl = gather_slots(clone_q, obs_slot), gather_slots(clone_p, obs_slot)
    q_fe, p_fe = gather_slots(clone_q_fej, obs_slot), gather_slots(clone_p_fej, obs_slot)

    # residual at the estimates
    p_C = _mv(R_ItoC @ lie.quat_2_rot(q_cl), pf - p_cl) + cp
    z = torch.clamp(p_C[..., 2], min=1e-6)
    uv_pred = cam_ops.distort(p_C[..., :2] / z[..., None], ck, model)
    r = (obs_uv - uv_pred).reshape(B, F, 2 * O)

    # Jacobians at the FEJ values
    R_GtoI_f = lie.quat_2_rot(q_fe)
    R_GtoC_f = R_ItoC @ R_GtoI_f
    p_C_f = _mv(R_GtoC_f, pf - p_fe) + cp
    z_f = torch.clamp(p_C_f[..., 2], min=1e-6)
    dpix = _duv_dzn(p_C_f[..., :2] / z_f[..., None], ck, model) @ _dzn_dpc(p_C_f, z_f)

    pf_in_I = _mv(R_GtoI_f, pf - p_fe)
    H_th = dpix @ (R_ItoC @ lie.skew(pf_in_I))
    H_p = dpix @ (-R_GtoC_f)
    Hf = dpix @ R_GtoC_f

    block = torch.cat([H_th, H_p], dim=-1)  # (B,F,O,2,6)
    Hx = _scatter_clone_band(block, obs_slot, n_clones, clone_off, D)
    rowmask = repeat_each(obs_valid, 2)
    return (Hx.reshape(B, F, 2 * O, D), Hf.reshape(B, F, 2 * O, 3), r, rowmask)


def point_systems_batch(p_f, obs_uv, obs_slot, obs_valid,
                        clone_q, clone_p, clone_q_fej, clone_p_fej,
                        cam_q, cam_p, cam_k, model: int, n_clones: int,
                        clone_off: int, D: int):
    """Per-feature MSCKF linear systems (port of `_point_system_single`
    mapped over features).  p_f (B,F,3), obs_uv (B,F,O,2), obs_slot/valid
    (B,F,O), clone rings (B,C,.), cam_q (B,4), cam_p (B,3), cam_k (B,8).
    Returns Hx (B,F,2O,D), Hf (B,F,2O,3), r (B,F,2O), rowmask (B,F,2O)."""
    R_ItoC = lie.quat_2_rot(cam_q)[:, None, None]  # (B,1,1,3,3)
    return _point_systems(p_f, obs_uv, obs_slot, obs_valid, clone_q, clone_p, clone_q_fej,
                          clone_p_fej, R_ItoC, cam_p[:, None, None, :], cam_k[:, None, None, :],
                          model, n_clones, clone_off, D)


def point_systems_batch_multicam(p_f, obs_uv, obs_slot, obs_cam, obs_valid,
                                 clone_q, clone_p, clone_q_fej, clone_p_fej,
                                 cam_q_all, cam_p_all, cam_k_all, model: int, n_clones: int,
                                 clone_off: int, D: int):
    """`point_systems_batch` with a camera index per observation (port of
    `_point_system_single_multicam`, the stereo frame's row builder): obs_cam
    (B,F,O) int indexes cam_q_all (B,n_cams,4), cam_p_all (B,n_cams,3) and
    cam_k_all (B,n_cams,8).  Same returns."""
    cq, cp, ck = (gather_slots(a, obs_cam) for a in (cam_q_all, cam_p_all, cam_k_all))
    return _point_systems(p_f, obs_uv, obs_slot, obs_valid, clone_q, clone_p, clone_q_fej,
                          clone_p_fej, lie.quat_2_rot(cq), cp, ck, model, n_clones, clone_off, D)


def point_systems_interp_batch(p_f, obs_uv, obs_slot0, obs_slot1, obs_lam, obs_valid,
                               clone_q, clone_p, clone_q_fej, clone_p_fej,
                               cam_q, cam_p, cam_k, model: int, n_clones: int,
                               clone_off: int, D: int):
    """Per-feature MSCKF systems at interpolated poses (port of
    `_point_system_interp_single` mapped over features): each observation
    is bracketed by clone slots obs_slot0 <= obs_slot1 in time with
    fraction obs_lam (B,F,O), its pose is `interpolate_pose_linear` between
    them, and its clone Jacobian spreads over both: the projection's
    d(pixel)/d(p_C) chained through `interpolate_rotation_jacobian` (closed
    form; the JAX package uses `jax.jacfwd`), at the FEJ clones.  The other
    arguments and the returns are `point_systems_batch`'s."""
    B, F, O = obs_slot0.shape
    R_ItoC = lie.quat_2_rot(cam_q)[:, None, None]
    cp, ck = cam_p[:, None, None, :], cam_k[:, None, None, :]
    pf = p_f[:, :, None, :]

    def at(ring, slot):
        return gather_slots(ring, slot)

    # residual at the interpolated estimates
    R_t, p_t = interpolate_pose_linear(at(clone_q, obs_slot0), at(clone_p, obs_slot0),
                                       at(clone_q, obs_slot1), at(clone_p, obs_slot1), obs_lam)
    p_C = _mv(R_ItoC, _mv(R_t, pf - p_t)) + cp
    z = torch.clamp(p_C[..., 2], min=1e-6)
    r = (obs_uv - cam_ops.distort(p_C[..., :2] / z[..., None], ck, model)).reshape(B, F, 2 * O)

    # Jacobians at the interpolated FEJ pose
    R_f, J0, J1 = interpolate_rotation_jacobian(at(clone_q_fej, obs_slot0),
                                                at(clone_q_fej, obs_slot1), obs_lam)
    lam = obs_lam[..., None, None]
    p_f_t = (1.0 - lam[..., 0]) * at(clone_p_fej, obs_slot0) + lam[..., 0] * at(clone_p_fej,
                                                                              obs_slot1)
    pf_in_I = _mv(R_f, pf - p_f_t)
    R_GtoC_f = R_ItoC @ R_f
    p_C_f = _mv(R_ItoC, pf_in_I) + cp
    z_f = torch.clamp(p_C_f[..., 2], min=1e-6)
    dzn = _dzn_dpc(p_C_f, z_f)
    # jax.jacfwd through the depth clamp: no depth derivative below it
    dzn = dzn * torch.stack([torch.ones_like(z_f), torch.ones_like(z_f),
                             (p_C_f[..., 2] > 1e-6).to(z_f.dtype)], -1)[..., None, :]
    dpix = _duv_dzn(p_C_f[..., :2] / z_f[..., None], ck, model) @ dzn
    # d(pixel)/d(psi) with R(lam)' = exp(psi) R(lam); d(pixel)/d(p(lam))
    H_psi = dpix @ (R_ItoC @ -lie.skew(pf_in_I))
    H_p = dpix @ (-R_GtoC_f)
    block0 = torch.cat([H_psi @ J0, (1.0 - lam) * H_p], dim=-1)  # (B,F,O,2,6)
    block1 = torch.cat([H_psi @ J1, lam * H_p], dim=-1)
    Hx = _scatter_clone_band(block0, obs_slot0, n_clones, clone_off, D, block1, obs_slot1)
    Hf = dpix @ R_GtoC_f
    rowmask = repeat_each(obs_valid, 2)
    return (Hx.reshape(B, F, 2 * O, D), Hf.reshape(B, F, 2 * O, 3), r, rowmask)


def slam_systems_batch(slam_xyz, slam_slot, obs_uv, obs_slot, obs_valid,
                       clone_q, clone_p, clone_q_fej, clone_p_fej, cam_q, cam_p, cam_k,
                       model: int, n_clones: int, clone_off: int, slam_off: int, D: int,
                       rep_jac=None):
    """Linear systems of in-state SLAM landmarks (reference: slam_update,
    UpdaterCamera.cpp:296-338): `point_systems_interp_batch` at each
    landmark's global xyz with every observation at a clone (s0 = s1,
    lam = 0, as the JAX driver calls it), the landmark's Jacobian chained
    through rep_jac (B,S,3,3) = d(xyz)/d(rep) (identity when None) and placed
    in the columns of its slot; no nullspace projection.

    slam_xyz (B,S,3), slam_slot (B,S) long, obs_uv (B,S,O,2), obs_slot and
    obs_valid (B,S,O), the rest as `point_systems_interp_batch`.  Returns
    Hx (B,S,2O,D), r (B,S,2O), rowmask (B,S,2O)."""
    Hx, Hf, r, rowmask = point_systems_interp_batch(
        slam_xyz, obs_uv, obs_slot, obs_slot, torch.zeros_like(obs_uv[..., 0]), obs_valid,
        clone_q, clone_p, clone_q_fej, clone_p_fej, cam_q, cam_p, cam_k, model, n_clones,
        clone_off, D)
    Hl = Hf if rep_jac is None else Hf @ rep_jac
    n_slam = (D - slam_off) // 3
    band = one_hot(slam_slot, n_slam, Hl.dtype)[:, :, None, :, None] * Hl[..., None, :]
    Hx[..., slam_off:] += band.flatten(-2)  # (B,S,2O,3 n_slam)
    return Hx, r, rowmask


def point_systems_table_batch(p_f, obs_uv, obs_tidx, obs_valid, obs_cam0,
                              tq, tp, tq_f, tp_f, tJ, tJt, cam_q, cam_p, cam_k,
                              model: int, clone_off: int, D: int,
                              dt_col: int = -1, ext_col: int = -1, int_col: int = -1):
    """Per-feature MSCKF systems against the interpolated-pose table (port of
    `_point_system_table_single` mapped over features, the per-track
    update's row builder).

    Each observation indexes a table row (tq/tp: the pose at the estimates,
    for the residual; tq_f/tp_f with tJ/tJt: the FEJ pose and its Jacobians
    with respect to the clones and the evaluation time) and carries its own
    camera's extrinsic and intrinsic row, so stereo observations mix cameras
    inside one feature.  The projection's Jacobians (pose, feature,
    extrinsic, intrinsic) are in closed form where the JAX package takes
    `jax.jacfwd` through a JPL-perturbed projection; the clone band is
    J_pose @ tJ[tidx] (reference: CamHelper.cpp:58-267, State.cpp:833-973).
    The calibration columns (dt_col, ext_col, int_col >= 0: reference
    CamHelper.cpp:77-102,139-167) are filled on camera-0 rows only
    (obs_cam0); the dt column is J_pose @ tJt[tidx].

    p_f (B,F,3), obs_uv (B,F,O,2), obs_tidx (B,F,O) long, obs_valid and
    obs_cam0 (B,F,O) bool, the table (B,T,.) as `core.interp.
    build_interp_table` returns it, cam_q/cam_p/cam_k (B,F,O,4/3/8).
    Returns Hx (B,F,2O,D), Hf (B,F,2O,3), r (B,F,2O), rowmask (B,F,2O)."""
    B, F, O = obs_tidx.shape
    pf = p_f[:, :, None, :]
    R_ItoC = lie.quat_2_rot(cam_q)

    # residual at the interpolated estimates
    R_t = lie.quat_2_rot(gather_slots(tq, obs_tidx))
    p_C = _mv(R_ItoC, _mv(R_t, pf - gather_slots(tp, obs_tidx))) + cam_p
    z = torch.clamp(p_C[..., 2], min=1e-6)
    r = (obs_uv - cam_ops.distort(p_C[..., :2] / z[..., None], cam_k, model)).reshape(B, F, 2 * O)

    # Jacobians at the interpolated FEJ pose
    R_f = lie.quat_2_rot(gather_slots(tq_f, obs_tidx))
    pf_in_I = _mv(R_f, pf - gather_slots(tp_f, obs_tidx))
    pf_in_C = _mv(R_ItoC, pf_in_I)
    p_C_f = pf_in_C + cam_p
    z_f = torch.clamp(p_C_f[..., 2], min=1e-6)
    dzn = _dzn_dpc(p_C_f, z_f)
    # jax.jacfwd through the depth clamp: no depth derivative below it
    dzn = dzn * torch.stack([torch.ones_like(z_f), torch.ones_like(z_f),
                             (p_C_f[..., 2] > 1e-6).to(z_f.dtype)], -1)[..., None, :]
    zn_f = p_C_f[..., :2] / z_f[..., None]
    dpix = _duv_dzn(zn_f, cam_k, model) @ dzn  # (B,F,O,2,3)
    R_GtoC_f = R_ItoC @ R_f
    Jp = torch.cat([dpix @ (R_ItoC @ lie.skew(pf_in_I)), dpix @ -R_GtoC_f], dim=-1)  # (..,2,6)
    Hf = dpix @ R_GtoC_f
    Hc = Jp @ gather_slots(tJ, obs_tidx)  # (B,F,O,2,6C)

    Hx = Hc.new_zeros((B, F, O, 2, D))
    Hx[..., clone_off:clone_off + Hc.shape[-1]] = Hc
    c0 = obs_cam0.to(Hx.dtype)[..., None, None]  # calibration columns: camera-0 rows only
    if dt_col >= 0:
        Hx[..., dt_col] = (Jp @ gather_slots(tJt, obs_tidx)[..., None])[..., 0] * c0[..., 0]
    if ext_col >= 0:
        eye = torch.eye(3, dtype=Hx.dtype, device=Hx.device).expand(dpix.shape[:-2] + (3, 3))
        Je = torch.cat([dpix @ lie.skew(pf_in_C), dpix @ eye], dim=-1)
        Hx[..., ext_col:ext_col + 6] = Je * c0
    if int_col >= 0:
        _, Ji = cam_ops.distort_jacobian(zn_f, cam_k, model)
        Hx[..., int_col:int_col + 8] = Ji * c0
    rowmask = repeat_each(obs_valid, 2)
    return Hx.reshape(B, F, 2 * O, D), Hf.reshape(B, F, 2 * O, 3), r, rowmask


def _nullspace(Hf, Hx, r):
    """Left-nullspace projection of (Hx, r) against Hf (...,M,k) by k
    Householder reflectors.  Returns (Hx2, r2, valid) with the M-k projected
    rows rolled to the top and the trailing k rows marked invalid."""
    M, k = Hf.shape[-2], Hf.shape[-1]
    A = torch.cat([Hf, Hx, r[..., None]], dim=-1)
    idx = torch.arange(M, device=A.device)
    for j in range(k):
        x = torch.where(idx >= j, A[..., :, j], 0.0)
        nx = torch.linalg.vector_norm(x, dim=-1)
        # never a zero sign: a zero pivot entry must still give alpha = -|x|
        # (see plviwo_tpu.update.cam_helper._nullspace)
        sgn = torch.where(x[..., j] >= 0.0, 1.0, -1.0).to(A.dtype)
        alpha = -sgn * nx
        v = x - alpha[..., None] * (idx == j).to(A.dtype)
        nv = torch.linalg.vector_norm(v, dim=-1)
        small = nv < 1e-12
        v = v / torch.where(small, torch.ones_like(nv), nv)[..., None]
        scale = torch.where(small, 0.0, 2.0).to(A.dtype)
        A = A - scale[..., None, None] * v[..., :, None] * (v[..., None, :] @ A)
    Hx2 = torch.roll(A[..., k:-1], -k, dims=-2)
    r2 = torch.roll(A[..., -1], -k, dims=-1)
    valid = torch.roll(idx >= k, -k, dims=0).expand(r2.shape)
    return Hx2, r2, valid


def msckf_project_and_gate(Hx, Hf, r, rowmask, cov, sigma2, chi2_table, chi2_mult):
    """Nullspace-project each feature system and chi2-gate it — the plain
    composition the gate kernel replaces, kept as a cross-check.

    Hx (B,F,M,D), Hf (B,F,M,k), r/rowmask (B,F,M), cov (B,D,D); sigma2 a
    scalar or a (B,F,M) per-row variance (the output is then pre-whitened);
    chi2_table (K,) 0.95 quantiles by dof.  Returns Hn (B,F,M,D),
    rn (B,F,M), rowvalid (B,F,M), feat_ok (B,F)."""
    per_row = torch.is_tensor(sigma2) and sigma2.ndim == 3
    Hx = torch.where(rowmask[..., None], Hx, 0.0)
    Hf = torch.where(rowmask[..., None], Hf, 0.0)
    r_m = torch.where(rowmask, r, 0.0)
    if per_row:
        w = 1.0 / torch.sqrt(torch.clamp(torch.where(rowmask, sigma2, 1.0), min=1e-12))
        Hx, Hf, r_m = Hx * w[..., None], Hf * w[..., None], r_m * w
        s_unit = 1.0
    else:
        s_unit = sigma2
    Hn, rn, valid = _nullspace(Hf, Hx, r_m)
    Hv = torch.where(valid[..., None], Hn, 0.0)
    rv = torch.where(valid, rn, 0.0)
    M = Hv.shape[-2]
    eye = torch.eye(M, dtype=Hv.dtype, device=Hv.device)
    S = Hv @ cov[:, None] @ Hv.transpose(-1, -2) + s_unit * eye
    chi = chi2_quadform(S, rv)
    k = Hf.shape[-1]
    n_rows = torch.sum(rowmask, dim=-1)
    dof = torch.clamp(n_rows - k, min=1, max=chi2_table.shape[0] - 1)
    ok = (chi < chi2_table[dof] * chi2_mult) & (n_rows >= k + 2)
    ok = ok & (torch.amax(torch.abs(r_m), dim=-1) < (15.0 if per_row else 20.0))
    return Hv, rv, valid & ok[..., None], ok
