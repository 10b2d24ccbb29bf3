"""Fused per-frame filter step (port of plviwo_tpu/core/step.py), batch-first.

One frame for B sequences at once: IMU propagation -> window
marginalization -> clone augmentation -> point rows (triangulate, systems,
gate/Gram kernel, k = 3) + line rows (two-plane triangulation, systems,
gate/Gram kernel, k = 4) + wheel rows (preintegration, FEJ system, chi2
gate) + GPS rows (images-in frame only) -> one summed Gram system -> one
compression -> one EKF update.  The images-in frame's two other point-row
builders live here too: stereo (each feature's left and right series
concatenated, a camera per observation) and dynamic cloning (each
observation at the pose interpolated between the clones that bracket its
time); both gate through the same kernel.

All control flow is masked; nothing in the step reads a value back to the
host, so metrics come back as (B,) tensors.  The gate always goes through
`ops.msckf_kernel.gram_gate` (the CUDA kernel on the card, its plain
version on the CPU), through `utils/graphs.call`, so that it stays an
eager call, looked up by this module's name, when the images-in frame runs
as CUDA graphs; the JAX package's XLA gate path and its `use_pallas` switch
are not ported.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..ops.chi2 import _TABLE as _CHI2_NP
from ..ops.msckf_kernel import gram_gate
from ..ops import lie
from ..update import cam_helper
from ..update import gps as gps_up
from ..update import lines as line_up
from ..update import wheel as wheel_up
from ..utils import graphs
from . import ekf, propagator
from .interp import interpolate_pose_linear
from .layout import StateLayout
from .state import FilterState, newest_clone_slot

F64 = torch.float64
F32 = torch.float32


def marginalize_mask(state: FilterState, drop) -> FilterState:
    """Zero the covariance rows/cols of every dropped clone slot; drop (B,C)."""
    lo = state.layout
    keep_clone = cam_helper.repeat_each(~drop, 6).to(state.cov.dtype)
    B = drop.shape[0]
    ones = state.cov.new_ones
    keep = torch.cat([ones(B, lo.clone_off), keep_clone,
                      ones(B, lo.dim - lo.clone_off - 6 * lo.n_clones)], dim=-1)
    return state.replace(
        clone_valid=state.clone_valid & ~drop,
        clone_keyframe=state.clone_keyframe & ~drop,
        clone_t=torch.where(drop, torch.inf, state.clone_t),
        cov=state.cov * keep[:, :, None] * keep[:, None, :],
    )


def _auto_marginalize(state: FilterState, t_now, window_size) -> FilterState:
    """Drop clones outside the time window; ensure at least one free slot."""
    valid = state.clone_valid
    drop = valid & (state.clone_t < (t_now - window_size)[:, None]) & ~state.clone_keyframe
    remaining = torch.sum(valid & ~drop, dim=-1)
    t_for_old = torch.where(valid & ~drop & ~state.clone_keyframe, state.clone_t, torch.inf)
    oldest = torch.argmin(t_for_old, dim=-1)  # first index among ties, as jnp
    need_slot = remaining >= state.layout.n_clones
    ar = torch.arange(drop.shape[1], device=drop.device)
    drop = drop | (need_slot[:, None] & (ar[None, :] == oldest[:, None]))
    return marginalize_mask(state, drop)


@functools.cache
def _chi2_table32(device: torch.device):
    """The 0.95 chi2 table as float32 on `device`, copied there once (a copy
    from host memory inside the step would wait for the device)."""
    return torch.as_tensor(_CHI2_NP, device=device).to(F32)


def _gram_rows(Hx, Hf, r, rowmask, cov, sigma, chi2_mult, resid_cap):
    """Whitened gate + gated Gram through the kernel.  Returns the unit-noise
    Gram pair (G (B,D,D) f64, c (B,D) f64), feat_ok (B,F), n_rows (B,)."""
    M = Hx.shape[-2]
    # float32 arithmetic as the JAX version does it: f32(table) * f32(mult)
    # (a python scalar is cast to the tensor's float32) and 1 / f32(sigma)
    gate_vec = _chi2_table32(Hx.device)[:M + 1] * chi2_mult
    w = torch.full(r.shape, float(np.float32(1.0) / np.float32(sigma)),
                   dtype=F32, device=Hx.device)
    # the kernel runs outside any CUDA graph, called through this module's name
    G, c, feat_ok, _chi = graphs.call(
        lambda: gram_gate, Hx.contiguous(), Hf.contiguous(), r.contiguous(),
        rowmask.contiguous(), w, cov.to(F32).contiguous(), gate_vec, resid_cap)
    n_rows = torch.sum(rowmask & feat_ok[..., None], dim=(-2, -1))
    return G.to(F64), c.to(F64), feat_ok, n_rows


def _rows_to_gram(H, r, mask):
    """(G, c) of masked unit-noise rows H (B,M,D), r (B,M)."""
    Hm = torch.where(mask[..., None], H, 0.0)
    rm = torch.where(mask, r, 0.0)
    return Hm.transpose(-1, -2) @ Hm, (Hm.transpose(-1, -2) @ rm[..., None])[..., 0]


def _cam(state, cd):
    return (state.cam_q[:, 0].to(cd), state.cam_p[:, 0].to(cd),
            state.cam_k[:, 0].to(cd))


def _point_gram(state: FilterState, Hx, Hf, r, rowmask, ok, avg_err, sigma_pix, chi2_mult):
    """The point rows' gate: rows of features that triangulated well,
    whitened by sigma_pix, through the gate/Gram kernel (k = 3).  Returns
    (G, c, metrics)."""
    rowmask = rowmask & ok[..., None]
    sigma = math.sqrt(sigma_pix**2)
    # whitened rows: the raw-residual cap of 20 px becomes 20/sigma
    G, c, feat_ok, n_rows = _gram_rows(Hx, Hf, r, rowmask, state.cov, sigma,
                                       chi2_mult, 20.0 / sigma)
    metrics = {
        "accepted": torch.sum(feat_ok, dim=-1),
        "rows": n_rows,
        "avg_reproj": torch.mean(torch.where(ok, avg_err, 0.0), dim=-1),
    }
    return G, c, metrics


def _camera_msckf_rows(state: FilterState, obs_uv, obs_uvn, obs_slot, obs_valid,
                       sigma_pix, chi2_mult, model: int, cam_dtype):
    """Point-MSCKF slice: triangulate -> systems -> gate/Gram kernel (k = 3).
    Returns (G, c, metrics) of the unit-noise Gram system."""
    lo: StateLayout = state.layout
    cd = cam_dtype
    cam_q, cam_p, cam_k = _cam(state, cd)
    cq = cam_helper.gather_slots(state.clone_q, obs_slot).to(cd)
    cp = cam_helper.gather_slots(state.clone_p, obs_slot).to(cd)
    p_f, ok, avg_err = cam_helper.triangulate_batch(
        obs_uvn.to(cd), cq, cp, obs_valid, cam_q, cam_p)
    fx = state.cam_k[:, 0, 0].to(cd)
    ok = ok & (avg_err < (3.0 / fx)[:, None])

    Hx, Hf, r, rowmask = cam_helper.point_systems_batch(
        p_f, obs_uv.to(cd), obs_slot, obs_valid,
        state.clone_q.to(cd), state.clone_p.to(cd),
        state.clone_q_fej.to(cd), state.clone_p_fej.to(cd),
        cam_q, cam_p, cam_k, model, lo.n_clones, lo.clone_off, lo.dim)
    return _point_gram(state, Hx, Hf, r, rowmask, ok, avg_err, sigma_pix, chi2_mult)


def _bound_times(state: FilterState, ts):
    """Bounding clone slots of arbitrary times over the clone ring.

    ts (B,...) f64.  Returns (slot0, slot1, lam, covered), each shaped like
    ts: the newest valid clone at or before t and the oldest at or after it
    (the first slot among equal times, as JAX's argmax/argmin take it), the
    interpolation fraction, and whether t is bracketed at all.  Where it is
    not, lam is 0 (JAX leaves it NaN there; every caller masks those
    entries)."""
    B = ts.shape[0]
    t = ts.reshape(B, -1, 1)
    cv, ct = state.clone_valid[:, None], state.clone_t[:, None]  # (B,1,C)
    le, ge = cv & (ct <= t), cv & (ct >= t)
    t_le = torch.where(le, ct, -torch.inf)
    t_ge = torch.where(ge, ct, torch.inf)
    s0 = torch.argmax(t_le, dim=-1)  # (B,T)
    s1 = torch.argmin(t_ge, dim=-1)
    covered = torch.any(le, dim=-1) & torch.any(ge, dim=-1)
    t0 = torch.gather(t_le, -1, s0[..., None])[..., 0]
    t1 = torch.gather(t_ge, -1, s1[..., None])[..., 0]
    t = t[..., 0]
    lam = torch.where(covered & (t1 > t0), (t - t0) / torch.clamp(t1 - t0, min=1e-9), 0.0)
    return (s0.reshape(ts.shape), s1.reshape(ts.shape), lam.reshape(ts.shape),
            covered.reshape(ts.shape))


def _camera_msckf_rows_interp(state: FilterState, obs_uv, obs_uvn, obs_t, obs_valid,
                              sigma_pix, chi2_mult, model: int, cam_dtype):
    """Point rows at interpolated poses (dynamic cloning): each
    observation's time obs_t (B,F,O) f64 is bracketed by clone ring slots
    (`_bound_times`), its pose is the linear interpolation between them,
    and its Jacobian spreads over both clones
    (`cam_helper.point_systems_interp_batch`).  Observations the clone
    window does not bracket are masked, and a feature with any history
    entry older than the oldest clone is rejected, as in JAX.  Then the
    gate/Gram kernel, k = 3, as the mono rows.  Returns (G, c, metrics)."""
    lo: StateLayout = state.layout
    cd = cam_dtype
    s0, s1, lam, covered = _bound_times(state, obs_t)
    valid = obs_valid & covered
    gs = cam_helper.gather_slots
    R_t, p_t = interpolate_pose_linear(gs(state.clone_q, s0), gs(state.clone_p, s0),
                                       gs(state.clone_q, s1), gs(state.clone_p, s1), lam)
    cam_q, cam_p, cam_k = _cam(state, cd)
    p_f, ok, avg_err = cam_helper.triangulate_batch(
        obs_uvn.to(cd), lie.rot_2_quat(R_t).to(cd), p_t.to(cd), valid, cam_q, cam_p)
    fx = state.cam_k[:, 0, 0].to(cd)
    ok = ok & (avg_err < (3.0 / fx)[:, None])
    # JAX's interpolation fraction is NaN for an entry with no valid clone at
    # or before its time (the history's -inf padding included), and that NaN
    # fails the whole feature's triangulation: such features are rejected
    t_first = torch.amin(torch.where(state.clone_valid, state.clone_t, torch.inf), dim=-1)
    ok = ok & torch.all(obs_t >= t_first[:, None, None], dim=-1)

    Hx, Hf, r, rowmask = cam_helper.point_systems_interp_batch(
        p_f, obs_uv.to(cd), s0, s1, lam.to(cd), valid,
        state.clone_q.to(cd), state.clone_p.to(cd),
        state.clone_q_fej.to(cd), state.clone_p_fej.to(cd),
        cam_q, cam_p, cam_k, model, lo.n_clones, lo.clone_off, lo.dim)
    return _point_gram(state, Hx, Hf, r, rowmask, ok, avg_err, sigma_pix, chi2_mult)


def _camera_msckf_rows_stereo(state: FilterState, obs_uv, obs_uvn, obs_slot, obs_valid,
                              r_uv, r_uvn, r_valid, sigma_pix, chi2_mult, model: int,
                              cam_dtype):
    """Stereo point rows: each feature's left (B,F,O) and right
    observation series (r_*, at the left ones' clone slots) concatenated
    along the observation axis, M = 4 O rows, with camera 0 for the left
    and camera 1 (clipped to n_cams - 1) for the right, triangulated and
    linearized jointly (`cam_helper.point_systems_batch_multicam`), then
    the gate/Gram kernel, k = 3, as the mono rows.  Returns (G, c,
    metrics)."""
    lo: StateLayout = state.layout
    cd = cam_dtype
    uv2 = torch.cat([obs_uv, r_uv], dim=2)
    uvn2 = torch.cat([obs_uvn, r_uvn], dim=2)
    slot2 = torch.cat([obs_slot, obs_slot], dim=2)
    valid2 = torch.cat([obs_valid, r_valid], dim=2)
    cam2 = torch.cat([torch.zeros_like(obs_slot),
                      torch.full_like(obs_slot, min(1, lo.n_cams - 1))], dim=2)
    gs = cam_helper.gather_slots
    p_f, ok, avg_err = cam_helper.triangulate_batch(
        uvn2.to(cd), gs(state.clone_q, slot2).to(cd), gs(state.clone_p, slot2).to(cd), valid2,
        gs(state.cam_q, cam2).to(cd), gs(state.cam_p, cam2).to(cd))
    fx = state.cam_k[:, 0, 0].to(cd)
    ok = ok & (avg_err < (3.0 / fx)[:, None])

    Hx, Hf, r, rowmask = cam_helper.point_systems_batch_multicam(
        p_f, uv2.to(cd), slot2, cam2, valid2,
        state.clone_q.to(cd), state.clone_p.to(cd),
        state.clone_q_fej.to(cd), state.clone_p_fej.to(cd),
        state.cam_q.to(cd), state.cam_p.to(cd), state.cam_k.to(cd),
        model, lo.n_clones, lo.clone_off, lo.dim)
    return _point_gram(state, Hx, Hf, r, rowmask, ok, avg_err, sigma_pix, chi2_mult)


def _line_msckf_rows(state: FilterState, line_uv, line_uvn, line_slot, line_valid,
                     sigma_line, chi2_mult, cam_dtype=F64):
    """Line slice: two-plane triangulation (f64) -> 2-rows-per-obs systems
    (cam_dtype) -> reprojection pre-gate -> gate/Gram kernel (k = 4).
    Returns (G, c, n_accepted (B,))."""
    lo: StateLayout = state.layout
    cd = cam_dtype
    n_G, v_G, ok, pair_count = line_up.triangulate_two_plane(
        line_uvn, cam_helper.gather_slots(state.clone_q, line_slot),
        cam_helper.gather_slots(state.clone_p, line_slot), line_valid,
        state.cam_q[:, 0], state.cam_p[:, 0])
    ok = ok & (pair_count >= 3)

    cam_q, cam_p, cam_k = _cam(state, cd)
    Hx, Hl, r, rowmask = line_up.line_systems_batch(
        n_G.to(cd), v_G.to(cd), line_uv.to(cd), line_slot, line_valid,
        state.clone_q.to(cd), state.clone_p.to(cd),
        state.clone_q_fej.to(cd), state.clone_p_fej.to(cd),
        cam_q, cam_p, cam_k, lo.n_clones, lo.clone_off, lo.dim)
    rowmask = rowmask & ok[..., None]
    # reprojection-quality gate: mean |r| over the line's rows < 2.5 sigma
    absr = torch.where(rowmask, torch.abs(r), 0.0)
    r_mean = torch.sum(absr, dim=-1) / torch.clamp(torch.sum(rowmask, dim=-1), min=1)
    rowmask = rowmask & (r_mean < 2.5 * sigma_line)[..., None]
    sigma = math.sqrt(sigma_line**2)
    G, c, line_ok, _ = _gram_rows(Hx, Hl, r, rowmask, state.cov, sigma,
                                  chi2_mult, 20.0 / sigma)
    return G, c, torch.sum(line_ok, dim=-1)


def _wheel_rows(state: FilterState, slot0, slot1, wheel_t, wheel_m1, wheel_m2,
                wheel_valid, wheel_noise, chi2_mult, wheel_type: int,
                preint_dtype=F64):
    """Wheel slice: 3D preintegration between clones slot0 -> slot1, FEJ
    system, whitening, chi2 gate as a row mask.
    Returns (Hw (B,6,D), rw (B,6), mask (B,6), accepted (B,) int32)."""
    lo: StateLayout = state.layout
    nw, nv, npp = wheel_noise
    R_m, p_m, Cov, dR_di, dp_di = wheel_up.preintegrate_3d(
        wheel_t, wheel_m1, wheel_m2, state.wheel_k, nw, nv, npp, wheel_type,
        dtype=preint_dtype)
    H, res = wheel_up.linear_system_3d(
        state.clone_q, state.clone_p, state.clone_q_fej, state.clone_p_fej,
        slot0, slot1, state.wheel_q, state.wheel_p, R_m, p_m, dR_di, dp_di,
        lo.n_clones, lo.clone_off, lo.dim,
        lo.wheel_ext if lo.use_wheel else 0, lo.wheel_int if lo.use_wheel else 0,
        False, False)
    Cov_reg = Cov + 1e-12 * torch.eye(6, dtype=F64, device=Cov.device)
    Hw, rw = ekf.whiten(H, res, Cov_reg)
    ones = torch.ones_like(rw)
    mask = wheel_valid[:, None].expand(rw.shape)
    chi = ekf.chi2(state.cov, Hw, rw, ones, mask)
    accept = (chi < float(_CHI2_NP[6]) * chi2_mult) & wheel_valid
    return Hw, rw, mask & accept[:, None], accept.to(torch.int32)


def _gps_rows(state: FilterState, gps_t, gps_p, gps_valid, sigma_gps, chi2_mult):
    """GPS slice: per fix a 3-row position system at the pose interpolated
    between its bounding clones (the newest clone at or before the fix and
    the oldest at or after it), whitened by sigma_gps and chi2-gated per fix.
    The world frame is taken to be the ENU frame.

    gps_t (B,Ng) f64, gps_p (B,Ng,3), gps_valid (B,Ng) bool.  Returns
    (H (B,3Ng,D), r (B,3Ng), mask (B,3Ng), accepted (B,) int32)."""
    lo: StateLayout = state.layout
    B, Ng = gps_t.shape
    ext_p = state.gps_p[:, 0] if lo.n_gps > 0 else state.p.new_zeros(B, 3)
    slot0, slot1, lam, covered = _bound_times(state, gps_t)  # (B,Ng)
    H6, res = gps_up.gps_linear_system(state.clone_q, state.clone_p, state.clone_q_fej,
                                       state.clone_p_fej, slot0, slot1, lam, ext_p, gps_p)
    # the two 6-column blocks into D columns by one-hot products, summed
    # (slot0 equals slot1 when a fix lands on a clone time)
    ar6 = torch.arange(6, device=gps_t.device)
    S0 = cam_helper.one_hot(lo.clone_off + 6 * slot0[..., None] + ar6, lo.dim, F64)
    S1 = cam_helper.one_hot(lo.clone_off + 6 * slot1[..., None] + ar6, lo.dim, F64)
    Hw = (H6[..., :6] @ S0 + H6[..., 6:] @ S1) / sigma_gps  # (B,Ng,3,D)
    rw = res / sigma_gps
    m = (gps_valid & covered)[..., None].expand(B, Ng, 3)
    chi = ekf.chi2(state.cov[:, None], Hw, rw, torch.ones_like(rw), m)
    accept = gps_valid & covered & (chi < float(_CHI2_NP[3]) * chi2_mult)
    mask = accept[..., None].expand(B, Ng, 3).reshape(B, 3 * Ng)
    return (Hw.reshape(B, 3 * Ng, lo.dim), rw.reshape(B, 3 * Ng), mask,
            torch.sum(accept, dim=-1, dtype=torch.int32))


def fused_step(state: FilterState, imu_t, imu_w, imu_a, t_new,
               obs_uv, obs_uvn, obs_slot, obs_valid,
               gravity, sigmas, sigma_pix, chi2_mult,
               model: int = 0, window_size: float = 1.0, cam_dtype=F64):
    """One points-only frame: propagate + clone + MSCKF update.

    Batch-first inputs: imu_t (B,N), imu_w/imu_a (B,N,3), t_new (B,),
    obs_uv/obs_uvn (B,F,O,2), obs_slot/obs_valid (B,F,O).  obs_slot refers
    to clone slots after this frame's clone insertion.  Returns
    (state, metrics of (B,) tensors)."""
    state = propagator.propagate(state, imu_t, imu_w, imu_a, t_new, gravity, sigmas)
    state = _auto_marginalize(state, state.time, window_size)
    state = ekf.augment_clone(state)
    G, c, metrics = _camera_msckf_rows(
        state, obs_uv, obs_uvn, obs_slot, obs_valid, sigma_pix, chi2_mult,
        model, cam_dtype)
    Hc, rc, cmask = ekf.compress_from_gram(G, c)
    state = ekf.update(state, Hc, rc, torch.ones_like(rc), cmask)
    return state, metrics


def fused_step_full(state: FilterState, imu_t, imu_w, imu_a, t_new,
                    obs_uv, obs_uvn, obs_slot, obs_valid,
                    line_uv, line_uvn, line_slot, line_valid,
                    wheel_t, wheel_m1, wheel_m2, wheel_valid,
                    gravity, sigmas, sigma_pix, chi2_mult, sigma_line, wheel_noise,
                    model: int = 0, window_size: float = 1.0, cam_dtype=F64,
                    wheel_type: int = wheel_up.W3D_ANG):
    """One full PL-VIWO frame: propagate + clone + point, line and wheel rows
    summed into one Gram system + one EKF update.

    Beyond `fused_step`: line_uv/line_uvn (B,L,O,4), line_slot/line_valid
    (B,L,O), wheel_t/wheel_m1/wheel_m2 (B,Nw) covering [t(newest clone),
    t_new], wheel_valid (B,) bool, sigma_line (px), wheel_noise
    (noise_w, noise_v, noise_p)."""
    state = propagator.propagate(state, imu_t, imu_w, imu_a, t_new, gravity, sigmas)
    state = _auto_marginalize(state, state.time, window_size)
    slot0 = newest_clone_slot(state)  # wheel interval start clone
    state = ekf.augment_clone(state)
    slot1 = newest_clone_slot(state)  # the clone just inserted

    # joint update: all sensors' unit-noise Gram systems at the same
    # pre-update state, summed and factored once
    G1, c1, metrics = _camera_msckf_rows(
        state, obs_uv, obs_uvn, obs_slot, obs_valid, sigma_pix, chi2_mult,
        model, cam_dtype)
    G2, c2, lines_accepted = _line_msckf_rows(
        state, line_uv, line_uvn, line_slot, line_valid, sigma_line, chi2_mult,
        cam_dtype=cam_dtype)
    Hw, rw, mw, wheel_accepted = _wheel_rows(
        state, slot0, slot1, wheel_t, wheel_m1, wheel_m2, wheel_valid,
        wheel_noise, chi2_mult, wheel_type, preint_dtype=cam_dtype)
    Gw, cw = _rows_to_gram(Hw, rw, mw)

    Hj, rj, mj = ekf.compress_from_gram(G1 + G2 + Gw, c1 + c2 + cw)
    state = ekf.update(state, Hj, rj, torch.ones_like(rj), mj)
    metrics = dict(metrics)
    metrics["lines_accepted"] = lines_accepted
    metrics["wheel_accepted"] = wheel_accepted
    return state, metrics
