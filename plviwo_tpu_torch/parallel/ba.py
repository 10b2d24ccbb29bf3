"""Landmark-sharded Schur-complement bundle adjustment (port of
plviwo_tpu/parallel/ba.py).

Landmarks are the parallel axis: each rank owns a contiguous shard and
computes its landmarks' Gauss-Newton blocks (H_ll, H_lp, b_l) from padded
observation lists; the landmark-marginalized reduced camera system

    H_red = sum_l (H_pp^l - H_pl H_ll^-1 H_lp),
    b_red = sum_l (b_p^l  - H_pl H_ll^-1 b_l)

is summed over the ranks with one all_reduce (JAX: a `psum` over the mesh);
the (6K) reduced system is solved on every rank, and each rank
back-substitutes its own landmarks.  Gauge: pose 0 is held fixed (its 6
columns are masked).

Keyframe poses are JPL (q_GtoI, p_IinG); observations are undistorted
normalized image coordinates.  Everything is float64, batch-first over
(landmarks, observations).  The Jacobians are in closed form (JAX takes
them with `jacfwd` at a zero perturbation): a pose perturbation is
q <- quat_multiply(normalize([0.5 dtheta, 1]), q), p <- p + dp, so
dR(q)/dtheta = -[dtheta]x R(q) to first order; the projection divides by
max(z, 1e-6), whose derivative in z is 1 above the clamp, 1/2 on it (JAX's
`maximum` splits ties) and 0 below.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..core.state import CUDA, checked_device
from ..ops import lie
from ..ops.linalg import solve3x3, solve_psd
from .replay import gather_rows

F64 = torch.float64
Z_MIN = 1e-6  # the projection's depth clamp


def _lm_blocks(lms, obs_k, obs_uvn, obs_mask, poses_q, poses_p, cam_q, cam_p):
    """Per-observation pieces of a landmark shard's Gauss-Newton blocks.

    lms (L,3), obs_k (L,O) keyframe index, obs_uvn (L,O,2), obs_mask (L,O).
    Returns J_p (L,O,2,6) [dtheta, dp], J_l (L,O,2,3) and r (L,O,2) =
    uvn - h, each multiplied by the mask (as JAX does: a non-finite
    prediction of a masked observation stays non-finite)."""
    R_q = lie.quat_2_rot(poses_q[obs_k])  # (L,O,3,3)
    R_c = lie.quat_2_rot(cam_q)
    p_I = (R_q @ (lms[:, None, :] - poses_p[obs_k])[..., None])[..., 0]
    p_C = (R_c @ p_I[..., None])[..., 0] + cam_p
    x, y, zc = p_C[..., 0], p_C[..., 1], p_C[..., 2]
    z = torch.clamp(zc, min=Z_MIN)
    dz = torch.where(zc > Z_MIN, 1.0, torch.where(zc == Z_MIN, 0.5, 0.0)).to(F64)
    zero = torch.zeros_like(z)
    dproj = torch.stack([torch.stack([1.0 / z, zero, -x * dz / z**2], -1),
                         torch.stack([zero, 1.0 / z, -y * dz / z**2], -1)], -2)
    A = dproj @ R_c  # d(uv)/d(p_I)
    J_l = A @ R_q
    J_p = torch.cat([A @ lie.skew(p_I), -J_l], dim=-1)
    m = obs_mask.to(F64)
    r = (obs_uvn - p_C[..., :2] / z[..., None]) * m[..., None]
    return J_p * m[..., None, None], J_l * m[..., None, None], r


def _reduced_system_shard(lms, obs_k, obs_uvn, obs_mask, poses_q, poses_p, cam_q, cam_p,
                          n_kf: int, damping: float = 1e-6):
    """Landmark-marginalized contributions of one landmark shard.

    lms (Ls,3); obs_k (Ls,O) int; obs_uvn (Ls,O,2); obs_mask (Ls,O).
    Returns (H_red (6K,6K), b_red (6K,), H_ll (Ls,3,3), b_l (Ls,3),
    H_pl (Ls,6K,3)); the last three for local back-substitution.  Each
    observation's pose blocks are added to its keyframe's 6 rows with
    `index_add_` (JAX: a one-hot product), so sums differ from JAX's only
    in rounding."""
    J_p, J_l, r = _lm_blocks(lms, obs_k, obs_uvn, obs_mask, poses_q, poses_p, cam_q, cam_p)
    Ls, O = obs_k.shape
    J_pT = J_p.transpose(-1, -2)
    k = obs_k.reshape(-1)
    H_pp = torch.zeros((n_kf, 6, 6), dtype=F64, device=lms.device).index_add_(
        0, k, (J_pT @ J_p).reshape(-1, 6, 6))
    b_p = torch.zeros((n_kf, 6), dtype=F64, device=lms.device).index_add_(
        0, k, (J_pT @ r[..., None]).reshape(-1, 6))
    row = (torch.arange(Ls, device=lms.device)[:, None] * n_kf + obs_k).reshape(-1)
    H_pl = torch.zeros((Ls * n_kf, 6, 3), dtype=F64, device=lms.device).index_add_(
        0, row, (J_pT @ J_l).reshape(-1, 6, 3)).reshape(Ls, 6 * n_kf, 3)
    eye3 = torch.eye(3, dtype=F64, device=lms.device)
    H_ll = torch.einsum("noik,noij->nkj", J_l, J_l) + damping * eye3
    b_l = torch.einsum("noik,noi->nk", J_l, r)
    # Schur complement of each landmark, summed over the shard
    X = solve_psd(H_ll, H_pl.transpose(-1, -2))  # (Ls,3,6K)
    y = solve_psd(H_ll, b_l)
    H_red = torch.block_diag(*H_pp) - torch.einsum("lpi,liq->pq", H_pl, X)
    b_red = b_p.reshape(-1) - torch.einsum("lpi,li->p", H_pl, y)
    return H_red, b_red, H_ll, b_l, H_pl


def _dq(dtheta):
    """The JPL perturbation normalize([0.5 dtheta, 1]) (...,4)."""
    return lie.quat_norm(torch.cat([0.5 * dtheta, torch.ones_like(dtheta[..., :1])], -1))


def ba_refine(poses_q, poses_p, lms, obs_k, obs_uvn, obs_mask, cam_q, cam_p,
              group=None, iters: int = 5, damping: float = 1e-4, device=CUDA):
    """Gauss-Newton BA with landmark Schur marginalization.

    Args:
      poses_q (K,4), poses_p (K,3): keyframe poses (JPL q_GtoI, p_IinG).
      lms (L,3): landmarks; obs_k (L,O) keyframe index per observation;
      obs_uvn (L,O,2) normalized observations; obs_mask (L,O).
      cam_q (4,), cam_p (3,): the camera extrinsics (q_ItoC, p_IinC).
      group: a `replay.RankGroup` (every rank calls with the same
      arguments): the landmarks, padded with masked rows to a multiple of
      the world size, shard over its ranks and the reduced system is summed
      with one all_reduce an iteration; None runs on `device` alone.
    Returns (poses_q, poses_p, lms (L,3) on every rank, {"gain": (iters,)})
    on the group's device, the gain b_red . dx of each iteration."""
    dev = group.device if group is not None else checked_device(device)

    def f64(x):
        return torch.as_tensor(x, dtype=F64).to(dev)

    K, L = poses_q.shape[0], lms.shape[0]
    world, rank = (group.world, group.rank) if group is not None else (1, 0)
    Ls = -(-L // world)
    pad = Ls * world - L
    sl = slice(rank * Ls, (rank + 1) * Ls)
    lm = torch.nn.functional.pad(f64(lms), (0, 0, 0, pad))[sl]
    o_k = torch.nn.functional.pad(torch.as_tensor(obs_k).to(dev, torch.int64),
                                  (0, 0, 0, pad))[sl]
    o_uvn = torch.nn.functional.pad(f64(obs_uvn), (0, 0, 0, 0, 0, pad))[sl]
    o_m = torch.nn.functional.pad(torch.as_tensor(obs_mask).to(dev, torch.bool),
                                  (0, 0, 0, pad))[sl]
    pq, pp, cq, cp = f64(poses_q), f64(poses_p), f64(cam_q), f64(cam_p)

    gauge = torch.ones(6 * K, dtype=F64, device=dev)
    gauge[:6] = 0.0
    fixed = torch.diag(torch.where(gauge > 0, torch.full_like(gauge, damping),
                                   torch.ones_like(gauge)))
    gains = []
    for _ in range(iters):
        H_red, b_red, H_ll, b_l, H_pl = _reduced_system_shard(
            lm, o_k, o_uvn, o_m, pq, pp, cq, cp, K)
        if group is not None:
            buf = torch.cat([H_red.reshape(-1), b_red])
            dist.all_reduce(buf)
            H_red, b_red = buf[:-6 * K].reshape(6 * K, 6 * K), buf[-6 * K:]
        # fix the gauge and damp; every rank solves the same reduced system
        H_red = H_red * gauge[:, None] * gauge[None, :] + fixed
        b_red = b_red * gauge
        dx = solve_psd(H_red, b_red)
        dxp = dx.reshape(K, 6)
        pq = lie.quat_multiply(_dq(dxp[:, :3]), pq)
        pp = pp + dxp[:, 3:]
        # landmark back-substitution, local to each shard
        lm = lm + solve3x3(H_ll, b_l - torch.einsum("lpi,p->li", H_pl, dx))
        gains.append(torch.sum(b_red * dx))
    if group is not None:
        lm = gather_rows(group, lm)
    return pq, pp, lm[:L], {"gain": torch.stack(gains)}
