"""Line measurement backend (port of plviwo_tpu/update/lines.py), batch-first.

Two-plane Plücker triangulation and the endpoint-to-projected-line FEJ
linear systems.  Jacobians come from one batched forward-mode pass
(`ops.jac.jacfwd_batched`, a `torch.func.jvp`) of the residual; the JAX
version uses `jax.jacfwd`.  No kernel runs inside it.  The
point-line-coupled rows (`line_systems_batch_plc`), direction-constrained
triangulation and line classification are not ported yet.
"""

from __future__ import annotations

import torch

from ..ops import lie, plucker
from ..ops.jac import jacfwd_batched
from .cam_helper import _cam_pose_in_g as _cam_pose
from .cam_helper import _mv, _scatter_clone_band, gather_slots, repeat_each


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def _norm(x, keepdim=True):
    return torch.linalg.vector_norm(x, dim=-1, keepdim=keepdim)


def triangulate_two_plane(seg_uvn, obs_q, obs_p, obs_valid, cam_q, cam_p,
                          parallel_cos=0.99995):
    """Two-plane Plücker triangulation, anchored at observation 0.

    seg_uvn (B,L,O,4) normalized endpoints [x1 y1 x2 y2], obs_q/obs_p
    (B,L,O,4/3), obs_valid (B,L,O), cam_q (B,4), cam_p (B,3).
    Returns n_G (B,L,3), v_G (B,L,3), ok (B,L), pair count (B,L)."""
    R_GtoC, c = _cam_pose(obs_q, obs_p, cam_q[:, None, None], cam_p[:, None, None])
    R_CtoG = R_GtoC.transpose(-1, -2)
    one = torch.ones_like(seg_uvn[..., :1])
    d1G = _mv(R_CtoG, torch.cat([seg_uvn[..., 0:2], one], -1))
    d2G = _mv(R_CtoG, torch.cat([seg_uvn[..., 2:4], one], -1))
    a = _cross(d1G, d2G)
    a = a / torch.clamp(_norm(a), min=1e-12)
    d = -torch.sum(a * c, dim=-1)  # (B,L,O)

    a0 = a[:, :, 0:1, :]
    d0 = d[:, :, 0:1]
    v_pair = _cross(a[:, :, 1:, :], a0)
    n_pair = d[:, :, 1:, None] * a0 - d0[..., None] * a[:, :, 1:, :]

    cosang = torch.abs(torch.sum(a[:, :, 1:, :] * a0, dim=-1))
    pair_ok = (cosang < parallel_cos) & obs_valid[:, :, 1:] & obs_valid[:, :, 0:1]

    v_unit = v_pair / torch.clamp(_norm(v_pair), min=1e-12)
    ref = v_unit[:, :, 0:1, :]
    sign = torch.where(torch.sum(v_unit * ref, dim=-1, keepdim=True) < 0, -1.0, 1.0)
    sign = sign.to(seg_uvn.dtype)
    w = pair_ok[..., None]
    v_sum = torch.sum(torch.where(w, v_pair * sign, 0.0), dim=2)
    n_sum = torch.sum(torch.where(w, n_pair * sign, 0.0), dim=2)
    n_pairs = torch.sum(pair_ok, dim=2)

    scale = torch.clamp(_norm(v_sum), min=1e-12)
    v_G = v_sum / scale
    n_G = n_sum / scale
    ok = (n_pairs >= 1) & (_norm(v_sum, keepdim=False) > 1e-9)
    return n_G, v_G, ok, torch.clamp(n_pairs, min=1)


def _line_residual(n_G, v_G, q_clone, p_clone, cam_q, cam_p, cam_k, seg_uv):
    """Distances (...,2) of both measured endpoints from the projected line."""
    R_GtoC, c = _cam_pose(q_clone, p_clone, cam_q, cam_p)
    n_C, _ = plucker.transform(n_G, v_G, R_GtoC, c)
    l = plucker.project(n_C, cam_k)
    return torch.stack([plucker.point_line_distance(seg_uv[..., 0:2], l),
                        plucker.point_line_distance(seg_uv[..., 2:4], l)], dim=-1)


def _h(dx6, d4, n_G, v_G, q, p, cam_q, cam_p, cam_k, seg_uv):
    """The line measurement at the perturbed pose / line, batched over (...)."""
    dq = lie.quat_norm(torch.cat([0.5 * dx6[..., 0:3], torch.ones_like(dx6[..., :1])], -1))
    n2, v2 = plucker.apply_orthonormal_delta(n_G, v_G, d4)
    return _line_residual(n2, v2, lie.quat_multiply(dq, q), p + dx6[..., 3:6],
                          cam_q, cam_p, cam_k, seg_uv)


def line_systems_batch(n_G, v_G, seg_uv, obs_slot, obs_valid,
                       clone_q, clone_p, clone_q_fej, clone_p_fej,
                       cam_q, cam_p, cam_k, n_clones: int, clone_off: int, D: int):
    """Per-line linear systems, 2 rows per observation.

    n_G/v_G (B,L,3), seg_uv (B,L,O,4), obs_slot/valid (B,L,O), clone rings
    (B,C,.), cam_q (B,4), cam_p (B,3), cam_k (B,8).  Returns Hx (B,L,2O,D),
    Hl (B,L,2O,4), r (B,L,2O), rowmask (B,L,2O), with r = 0 - h(x_hat) and
    H = +dh/dx at the FEJ values."""
    B, L, O = obs_slot.shape
    shp = (B, L, O)
    n = n_G[:, :, None].expand(shp + (3,))
    v = v_G[:, :, None].expand(shp + (3,))
    cq = cam_q[:, None, None].expand(shp + (4,))
    cp = cam_p[:, None, None].expand(shp + (3,))
    ck = cam_k[:, None, None].expand(shp + (8,))

    res = -_line_residual(n, v, gather_slots(clone_q, obs_slot),
                          gather_slots(clone_p, obs_slot), cq, cp, ck, seg_uv)

    Jp, Jl = jacfwd_batched(
        _h, (n.new_zeros(shp + (6,)), n.new_zeros(shp + (4,)), n, v,
             gather_slots(clone_q_fej, obs_slot), gather_slots(clone_p_fej, obs_slot),
             cq, cp, ck, seg_uv), (0, 1))  # (B,L,O,2,6), (B,L,O,2,4)
    Hx = _scatter_clone_band(Jp, obs_slot, n_clones, clone_off, D)
    rowmask = repeat_each(obs_valid, 2)
    return (Hx.reshape(B, L, 2 * O, D), Jl.reshape(B, L, 2 * O, 4),
            res.reshape(B, L, 2 * O), rowmask)
