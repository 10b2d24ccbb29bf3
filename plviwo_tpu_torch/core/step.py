"""Fused per-frame filter step (port of plviwo_tpu/core/step.py), batch-first.

One frame for B sequences at once: IMU propagation -> window
marginalization -> clone augmentation -> point rows (triangulate, systems,
gate/Gram kernel, k = 3) + line rows (two-plane triangulation, systems,
gate/Gram kernel, k = 4) + wheel rows (preintegration, FEJ system, chi2
gate) -> one summed Gram system -> one compression -> one EKF update.

All control flow is masked; nothing in the step reads a value back to the
host, so metrics come back as (B,) tensors.  The gate always goes through
`ops.msckf_kernel.gram_gate` (the CUDA kernel on the card, its plain
version on the CPU); the JAX package's XLA gate path and its
`use_pallas` switch are not ported.  Stereo, dynamic cloning and GPS rows
are not ported yet.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..ops.chi2 import _TABLE as _CHI2_NP
from ..ops.msckf_kernel import gram_gate
from ..update import cam_helper
from ..update import lines as line_up
from ..update import wheel as wheel_up
from . import ekf, propagator
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
    G, c, feat_ok, _chi = gram_gate(
        Hx.contiguous(), Hf.contiguous(), r.contiguous(), rowmask.contiguous(),
        w, cov.to(F32).contiguous(), gate_vec, resid_cap)
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
