"""Line measurement backend (port of plviwo_tpu/update/lines.py), batch-first.

Line triangulation (two-plane Plücker; direction-constrained least squares
for a line whose world axis is known; a known direction through a point),
the endpoint-to-projected-line FEJ linear systems with optional
point-line-coupled (PLC) rows, the vanishing points of the world axes with
the per-segment classification against them, and the point-to-segment
assignment.  Jacobians come from one batched forward-mode pass
(`ops.jac.jacfwd_batched`, a `torch.func.jvp`) of the residual; the JAX
version uses `jax.jacfwd`.  No kernel runs inside it.  Every function is
ported; the host line tracker (`update/line_tracker.py`) attaches points
with `assign_points_to_lines`.
"""

from __future__ import annotations

import math

import torch

from ..ops import lie, plucker
from ..ops.jac import jacfwd_batched
from ..ops.linalg import solve3x3
from .cam_helper import _cam_pose_in_g as _cam_pose
from .cam_helper import _mv, _scatter_clone_band, gather_slots, repeat_each


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def _norm(x, keepdim=True):
    return torch.linalg.vector_norm(x, dim=-1, keepdim=keepdim)


def _planes(seg_uvn, obs_q, obs_p, cam_q, cam_p):
    """Each observation's back-projected plane in G: unit normal a (...,3)
    and offset d (...,) with a . x + d = 0 (cam_q (B,4), cam_p (B,3))."""
    R_GtoC, c = _cam_pose(obs_q, obs_p, cam_q[:, None, None], cam_p[:, None, None])
    R_CtoG = R_GtoC.transpose(-1, -2)
    one = torch.ones_like(seg_uvn[..., :1])
    a = _cross(_mv(R_CtoG, torch.cat([seg_uvn[..., 0:2], one], -1)),
               _mv(R_CtoG, torch.cat([seg_uvn[..., 2:4], one], -1)))
    a = a / torch.clamp(_norm(a), min=1e-12)
    return a, -torch.sum(a * c, dim=-1)


def triangulate_two_plane(seg_uvn, obs_q, obs_p, obs_valid, cam_q, cam_p,
                          parallel_cos=0.99995):
    """Two-plane Plücker triangulation, anchored at observation 0.

    seg_uvn (B,L,O,4) normalized endpoints [x1 y1 x2 y2], obs_q/obs_p
    (B,L,O,4/3), obs_valid (B,L,O), cam_q (B,4), cam_p (B,3).
    Returns n_G (B,L,3), v_G (B,L,3), ok (B,L), pair count (B,L)."""
    a, d = _planes(seg_uvn, obs_q, obs_p, cam_q, cam_p)  # (B,L,O,3), (B,L,O)
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


def triangulate_direction_ls(seg_uvn, obs_q, obs_p, obs_valid, cam_q, cam_p, direction_G):
    """Least-squares triangulation of a line of known world direction (a
    classified line): each observation's plane (a_i, d_i) contains the line,
    so n . (a_i x v) = -d_i, plus n . v = 0 with weight 100; the 3x3 normal
    equations by `ops.linalg.solve3x3`.

    seg_uvn (B,L,O,4), obs_q/obs_p (B,L,O,4/3), obs_valid (B,L,O), cam_q
    (B,4), cam_p (B,3), direction_G (B,L,3).  Returns n_G, v_G (B,L,3) and
    ok (B,L): at least two observations and a finite moment."""
    a, d = _planes(seg_uvn, obs_q, obs_p, cam_q, cam_p)
    v = direction_G / torch.clamp(_norm(direction_G), min=1e-12)
    w = obs_valid[..., None].to(seg_uvn.dtype)
    rows = _cross(a, v[:, :, None, :]) * w  # (B,L,O,3)
    A = torch.einsum("bloi,bloj->blij", rows, rows)
    b = torch.einsum("bloi,blo->bli", rows, -d * obs_valid.to(d.dtype))
    A = A + 100.0 * v[..., :, None] * v[..., None, :]
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    n = solve3x3(A + 1e-9 * eye, b)
    ok = (torch.sum(obs_valid, dim=-1) >= 2) & torch.all(torch.isfinite(n), dim=-1)
    return n, v, ok


def triangulate_from_direction(direction_G, point_G):
    """A line of known world direction through a point (reference:
    line_triangulation_from_points_and_direction, LineHelper.cpp:231-293):
    n = p x d with d normalized.  (...,3) each; returns (n, d)."""
    d = direction_G / torch.clamp(_norm(direction_G), min=1e-12)
    return _cross(point_G, d), d


def _line_residual(n_G, v_G, q_clone, p_clone, cam_q, cam_p, cam_k, seg_uv, plc_uv):
    """Distances (...,2+P) of both measured endpoints, then of the P attached
    points' measured pixels plc_uv (...,2P) (the PLC rows: reference
    LineHelper.cpp:879-890), from the projected line."""
    R_GtoC, c = _cam_pose(q_clone, p_clone, cam_q, cam_p)
    n_C, _ = plucker.transform(n_G, v_G, R_GtoC, c)
    l = plucker.project(n_C, cam_k)
    d_end = torch.stack([plucker.point_line_distance(seg_uv[..., 0:2], l),
                         plucker.point_line_distance(seg_uv[..., 2:4], l)], dim=-1)
    if plc_uv.shape[-1] == 0:
        return d_end
    plc = plc_uv.unflatten(-1, (-1, 2))
    return torch.cat([d_end, plucker.point_line_distance(plc, l[..., None, :])], dim=-1)


def _h(dx6, d4, n_G, v_G, q, p, cam_q, cam_p, cam_k, seg_uv, plc_uv):
    """The line measurement at the perturbed pose / line, batched over (...)."""
    dq = lie.quat_norm(torch.cat([0.5 * dx6[..., 0:3], torch.ones_like(dx6[..., :1])], -1))
    n2, v2 = plucker.apply_orthonormal_delta(n_G, v_G, d4)
    return _line_residual(n2, v2, lie.quat_multiply(dq, q), p + dx6[..., 3:6],
                          cam_q, cam_p, cam_k, seg_uv, plc_uv)


def line_systems_batch(n_G, v_G, seg_uv, obs_slot, obs_valid,
                       clone_q, clone_p, clone_q_fej, clone_p_fej,
                       cam_q, cam_p, cam_k, n_clones: int, clone_off: int, D: int):
    """Per-line linear systems, 2 rows per observation: `line_systems_batch_plc`
    with no attached points (P = 0)."""
    B, L, O = obs_slot.shape
    return line_systems_batch_plc(
        n_G, v_G, seg_uv, seg_uv.new_zeros((B, L, O, 0, 2)),
        obs_valid.new_zeros((B, L, O, 0)), obs_slot, obs_valid, clone_q, clone_p, clone_q_fej,
        clone_p_fej, cam_q, cam_p, cam_k, n_clones, clone_off, D)


def line_systems_batch_plc(n_G, v_G, seg_uv, plc_uv, plc_valid, obs_slot, obs_valid,
                           clone_q, clone_p, clone_q_fej, clone_p_fej,
                           cam_q, cam_p, cam_k, n_clones: int, clone_off: int, D: int):
    """Per-line linear systems with R = 2 + P rows per observation: the two
    endpoint distances, then P point-line-coupled rows (the distance of each
    attached point's measured pixel from the projected line), observation
    by observation ([end1, end2, plc_0 .. plc_{P-1}] for each).

    n_G/v_G (B,L,3), seg_uv (B,L,O,4), plc_uv (B,L,O,P,2), plc_valid
    (B,L,O,P), obs_slot/valid (B,L,O), clone rings (B,C,.), cam_q (B,4),
    cam_p (B,3), cam_k (B,8).  Returns Hx (B,L,RO,D), Hl (B,L,RO,4),
    r (B,L,RO), rowmask (B,L,RO) (a PLC row counts where its point and its
    observation are valid), with r = 0 - h(x_hat) and H = +dh/dx at the FEJ
    values."""
    B, L, O = obs_slot.shape
    P = plc_uv.shape[-2]
    R = 2 + P
    shp = (B, L, O)
    n = n_G[:, :, None].expand(shp + (3,))
    v = v_G[:, :, None].expand(shp + (3,))
    cq = cam_q[:, None, None].expand(shp + (4,))
    cp = cam_p[:, None, None].expand(shp + (3,))
    ck = cam_k[:, None, None].expand(shp + (8,))
    plc = plc_uv.reshape(shp + (2 * P,))

    res = -_line_residual(n, v, gather_slots(clone_q, obs_slot),
                          gather_slots(clone_p, obs_slot), cq, cp, ck, seg_uv, plc)

    Jp, Jl = jacfwd_batched(
        _h, (n.new_zeros(shp + (6,)), n.new_zeros(shp + (4,)), n, v,
             gather_slots(clone_q_fej, obs_slot), gather_slots(clone_p_fej, obs_slot),
             cq, cp, ck, seg_uv, plc), (0, 1))  # (B,L,O,R,6), (B,L,O,R,4)
    Hx = _scatter_clone_band(Jp, obs_slot, n_clones, clone_off, D)
    rowmask = torch.cat([repeat_each(obs_valid, 2).reshape(shp + (2,)),
                         plc_valid & obs_valid[..., None]], dim=-1)
    return (Hx.reshape(B, L, R * O, D), Jl.reshape(B, L, R * O, 4),
            res.reshape(B, L, R * O), rowmask.reshape(B, L, R * O))


def vanishing_points(q_GtoI, cam_q, cam_k):
    """Pixel vanishing points of the world x, y and z axes (reference:
    LineHelper::Vanishing_Points, LineHelper.cpp:1026-1056; here the pinhole
    points, without distortion, as in the JAX package).  q_GtoI and cam_q
    (B,4), cam_k (B,8).  Returns uv (B,3,2) (possibly far outside the
    image) and valid (B,3): the axis is not nearly parallel to the image
    plane."""
    R_GtoC = lie.quat_2_rot(cam_q) @ lie.quat_2_rot(q_GtoI)
    dirs = R_GtoC.transpose(-1, -2)  # row k: world axis k in camera coordinates
    z = dirs[..., 2]
    valid = torch.abs(z) > 1e-3
    zn = dirs[..., 0:2] / torch.where(valid, z, 1.0)[..., None]
    fx, fy, cx, cy = (cam_k[:, i, None] for i in range(4))
    return torch.stack([fx * zn[..., 0] + cx, fy * zn[..., 1] + cy], dim=-1), valid


def classify_lines(seg_uv, vps, vp_valid, dist_thresh=5.0, ang_thresh=0.35):
    """Each segment's world axis by the vanishing points (reference:
    LineClass/LineClassification, TrackLSD.cpp:318-366): axis k qualifies
    when its point is valid, the direction from it to the segment's
    midpoint is within ang_thresh of the segment's (undirected), and the
    endpoint lies within dist_thresh px of the line from the point through
    the midpoint; the qualifying axis of least angle wins (the first on a
    tie).  seg_uv (B,L,4), vps (B,3,2), vp_valid (B,3).  Returns (B,L)
    int64 in {0 (none), 1 (x), 2 (y), 3 (z)}."""
    p1, p2 = seg_uv[..., 0:2], seg_uv[..., 2:4]
    mid = 0.5 * (p1 + p2)
    seg_dir = p2 - p1
    seg_ang = torch.atan2(seg_dir[..., 1], seg_dir[..., 0])
    vp_dir = mid[:, :, None, :] - vps[:, None, :, :]  # (B,L,3,2)
    vp_ang = torch.atan2(vp_dir[..., 1], vp_dir[..., 0])
    diff = seg_ang[..., None] - vp_ang
    dang = torch.abs(torch.atan2(torch.sin(diff), torch.cos(diff)))
    dang = torch.minimum(dang, math.pi - dang)
    nrm = torch.stack([-vp_dir[..., 1], vp_dir[..., 0]], dim=-1)
    nrm = nrm / torch.clamp(_norm(nrm), min=1e-9)
    d_end = torch.abs(torch.sum((p1 - mid)[:, :, None, :] * nrm, dim=-1))
    ok = (dang < ang_thresh) & (d_end < dist_thresh) & vp_valid[:, None, :]
    scores = torch.where(ok, dang, torch.inf)
    best = torch.argmin(scores, dim=-1)
    none = ~torch.isfinite(torch.amin(scores, dim=-1))
    return torch.where(none, 0, best + 1)


def assign_points_to_lines(seg_uv, pts_uv, pts_valid, dist_thresh=5.0, margin=5.0):
    """Point-to-segment assignment (reference: AssignPointToLines,
    TrackLSD.cpp:744-792): a point attaches to a segment inside the
    segment's bounding box grown by margin and within dist_thresh of its
    line.  seg_uv (B,L,4), pts_uv (B,P,2), pts_valid (B,P).  Returns
    (B,L,P) bool."""
    p1, p2 = seg_uv[:, :, None, 0:2], seg_uv[:, :, None, 2:4]
    q = pts_uv[:, None, :, :]
    inbox = torch.all((q >= torch.minimum(p1, p2) - margin)
                      & (q <= torch.maximum(p1, p2) + margin), dim=-1)
    d = p2 - p1
    t = torch.sum((q - p1) * d, dim=-1) / torch.clamp(torch.sum(d * d, dim=-1), min=1e-9)
    dist = _norm(q - (p1 + t[..., None] * d), keepdim=False)
    return inbox & (dist <= dist_thresh) & pts_valid[:, None, :]
