"""Images-in fused frame (port of plviwo_tpu/core/frame.py), batch-first.

One frame for B sequences: hist-equalize -> pyramid -> pyramidal LK (the
hand kernel `csrc/lk_pyramid.cu` on the card) -> undistort -> RANSAC gate
-> per-slot observation histories -> grid re-detect into free slots ->
track harvest -> IMU propagate -> marginalize -> clone -> point rows (the
gate/Gram kernel) + wheel rows -> ONE joint EKF update.

This is the configuration `VioSystem.feed_image` runs by default (mono
points and wheel, `CamOptions.use_lines = False`).  A feature IS its slot:
a tracked point keeps a fixed slot for its lifetime; its observation
history carries (clone slot, time) pairs, used at harvest only while the
clone ring slot still holds the same timestamp.

Not ported yet, and refused with NotImplementedError rather than skipped:
the line front-end (ROADMAP A6b), GPS rows (A7), stereo and dynamic
cloning (A8).  The pyramid has the JAX package's fixed three levels.
Nothing in a frame reads a value back to the host; metrics are (B,)
tensors.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops import cam as cam_ops
from ..ops import image as image_ops
from ..ops import klt as klt_ops
from ..ops import lk_kernel
from ..update import wheel as wheel_up
from . import ekf, propagator
from .state import CUDA, FilterState, checked_device, newest_clone_slot
from .step import _auto_marginalize, _camera_msckf_rows, _rows_to_gram, _wheel_rows

F32 = torch.float32
F64 = torch.float64
LEVELS = 3  # pyramid levels (TrackState holds pyr0..pyr2)


@dataclasses.dataclass
class TrackState:
    """Front-end state of B sequences (fixed shapes)."""

    pyr0: torch.Tensor      # (B,H,W) f32 previous image pyramid
    pyr1: torch.Tensor      # (B,H/2,W/2)
    pyr2: torch.Tensor      # (B,H/4,W/4)
    has_prev: torch.Tensor  # (B,) bool
    uv: torch.Tensor        # (B,N,2) f32 current raw pixel positions
    valid: torch.Tensor     # (B,N) bool
    hist_uv: torch.Tensor   # (B,N,O,2) f32 raw observation history
    hist_uvn: torch.Tensor  # (B,N,O,2) f32 undistorted-normalized history
    hist_t: torch.Tensor    # (B,N,O) f64 observation times
    hist_slot: torch.Tensor  # (B,N,O) int64 clone ring slot per observation
    n_obs: torch.Tensor     # (B,N) int64
    key: torch.Tensor       # (B,) int64 RANSAC key per sequence (the JAX package's `key`)
    counter: torch.Tensor   # (B,) int64 frames tracked: with `key`, what RANSAC draws from

    def replace(self, **kw) -> "TrackState":
        return dataclasses.replace(self, **kw)


def make_track_state(height: int, width: int, n_pts: int = 128, max_lines: int = 24,
                     max_obs: int = 10, seed: int = 0, *, batch: int = 1,
                     device=CUDA) -> TrackState:
    """Empty front-end state of `batch` sequences on `device`, with the JAX
    package's positional signature.  Sequence b's RANSAC key is seed + b
    (JAX's bench gives sequence b `PRNGKey(b)`), its frame counter 0.
    `max_lines` is accepted as in JAX; no line fields are allocated until
    the line front-end is ported (ROADMAP A6b)."""
    dev = checked_device(device)
    B, N, O = batch, n_pts, max_obs

    def z(*shape, dtype=F32):
        return torch.zeros((B,) + shape, dtype=dtype, device=dev)

    return TrackState(
        pyr0=z(height, width), pyr1=z(height // 2, width // 2),
        pyr2=z(height // 4, width // 4), has_prev=z(dtype=torch.bool),
        uv=z(N, 2), valid=z(N, dtype=torch.bool),
        hist_uv=z(N, O, 2), hist_uvn=z(N, O, 2),
        hist_t=torch.full((B, N, O), -torch.inf, dtype=F64, device=dev),
        hist_slot=z(N, O, dtype=torch.int64), n_obs=z(N, dtype=torch.int64),
        key=seed + torch.arange(B, dtype=torch.int64, device=dev), counter=z(dtype=torch.int64))


def _fill_free_slots(free, cand_ok):
    """Rank-match candidates to free slots, both orderings kept: the k-th
    free slot takes the k-th valid candidate.

    free (B,N), cand_ok (B,M) bool.  Returns (take (B,N) candidate index per
    slot, filled (B,N)); `take` is meaningful only where `filled`.  The
    candidate of rank r is found by a search over the rank cumsum (the JAX
    package scatters ranks, writing every non-candidate to index 0; a search
    has no duplicate writes, so it is deterministic on the card too)."""
    M = cand_ok.shape[-1]
    free_rank = torch.cumsum(free.to(torch.int64), dim=-1) * free
    cand_rank = torch.cumsum(cand_ok.to(torch.int64), dim=-1)
    take = torch.clamp(torch.searchsorted(cand_rank, free_rank), max=M - 1)
    filled = free & (free_rank >= 1) & (free_rank <= cand_rank[:, -1:])
    return take, filled


def _append_obs(hist_uv, hist_uvn, hist_t, hist_slot, n_obs, mask, uv, uvn, t_new, slot):
    """Write the current observation at each track's n_obs cursor (masked).
    uv, uvn (B,N,2); t_new, slot (B,)."""
    O = hist_uv.shape[2]
    cur = torch.clamp(n_obs, 0, O - 1)
    at = (torch.arange(O, device=cur.device) == cur[..., None]) & mask[..., None]
    hist_uv = torch.where(at[..., None], uv[:, :, None].to(F32), hist_uv)
    hist_uvn = torch.where(at[..., None], uvn[:, :, None].to(F32), hist_uvn)
    hist_t = torch.where(at, t_new[:, None, None], hist_t)
    hist_slot = torch.where(at, slot[:, None, None].to(hist_slot.dtype), hist_slot)
    return hist_uv, hist_uvn, hist_t, hist_slot, torch.where(mask, n_obs + 1, n_obs)


def _restart(hist_uv, hist_uvn, hist_t, hist_slot, n_obs, mask):
    """Empty the histories of the masked tracks."""
    m = mask[..., None]
    return (torch.where(m[..., None], 0.0, hist_uv), torch.where(m[..., None], 0.0, hist_uvn),
            torch.where(m, -torch.inf, hist_t), torch.where(m, 0, hist_slot),
            torch.where(mask, 0, n_obs))


def track_frame(ts: TrackState, img, cam_k, t_new, slot_new, half: int = 7,
                iters: int = 6, grid_x: int = 16, grid_y: int = 12,
                min_px_dist: int = 10, min_track: int = 4, cam_model: int = 0):
    """One tracked camera frame of B sequences, the point front-end only.

    img (B,H,W); cam_k (B,8); t_new (B,) f64; slot_new (B,) the clone slot
    of this frame.  Returns (ts', point_harvest) with point_harvest =
    (obs_uv (B,N,O,2) f32, obs_uvn, obs_slot (B,N,O), obs_mask (B,N,O),
    hist_t (B,N,O) f64); obs_mask folds the per-track harvest decision, the
    caller adds the clone ring liveness test.  The JAX `track_frame` also
    runs the line block; with lines off nothing it computes reaches the
    point fields or the filter, so it is not run here."""
    N = ts.uv.shape[1]
    O = ts.hist_uv.shape[2]
    kb = cam_k[:, None, :]

    img = image_ops.hist_equalize_quantile(img.to(F32))
    pyr = image_ops.build_pyramid(img, LEVELS)

    # ---- temporal LK + RANSAC ----
    has_prev = ts.has_prev[:, None]
    uv_next, ok = lk_kernel.pyramidal_lk((ts.pyr0, ts.pyr1, ts.pyr2), pyr, ts.uv,
                                         ts.valid & has_prev, LEVELS, half, iters)
    zn = cam_ops.undistort(torch.cat([ts.uv, uv_next], dim=1).to(F64), kb, cam_model)
    zn_prev, zn_next = zn[:, :N], zn[:, N:]
    enough = torch.sum(ok, dim=-1, keepdim=True) >= 12
    inl = klt_ops.ransac_fundamental(zn_prev, zn_next, ok, ts.key, ts.counter)
    ok = ok & torch.where(enough, inl, ok)

    alive = ts.valid & ok & has_prev
    # harvest dead tracks (history as it is, no current observation)
    h_dead = ts.valid & ~alive & (ts.n_obs >= min_track)

    # ---- append the current observation of the survivors ----
    uv_cur = torch.where(alive[..., None], uv_next, ts.uv)
    hist = _append_obs(ts.hist_uv, ts.hist_uvn, ts.hist_t, ts.hist_slot, ts.n_obs, alive,
                       uv_cur, zn_next, t_new, slot_new)
    n_obs = hist[4]

    # ---- harvest full tracks (keep the corner tracked; restart history) ----
    h_full = alive & (n_obs >= O)
    obs_cnt = torch.where(h_dead, ts.n_obs, n_obs)  # dead: pre-append count
    obs_mask = ((torch.arange(O, device=n_obs.device) < obs_cnt[..., None])
                & (h_dead | h_full)[..., None])
    point_harvest = (hist[0], hist[1], hist[3], obs_mask, hist[2])
    hist = _append_obs(*_restart(*hist, h_full), h_full, uv_cur, zn_next, t_new, slot_new)

    # ---- re-detect into free slots: fresh tracks, the detection as first obs ----
    det_uv, det_ok = klt_ops.detect_grid(pyr[0], uv_cur, alive, grid_x, grid_y, N,
                                         min_px_dist=float(min_px_dist))
    take, filled = _fill_free_slots(~alive, det_ok)
    uv_all = torch.where(filled[..., None],
                         torch.gather(det_uv, 1, take[..., None].expand(-1, -1, 2)), uv_cur)
    zn_new = cam_ops.undistort(uv_all.to(F64), kb, cam_model)
    hist = _append_obs(*_restart(*hist, filled), filled, uv_all, zn_new, t_new, slot_new)

    ts2 = ts.replace(
        pyr0=pyr[0], pyr1=pyr[1], pyr2=pyr[2], has_prev=torch.ones_like(ts.has_prev),
        uv=uv_all.to(F32), valid=alive | filled, hist_uv=hist[0], hist_uvn=hist[1],
        hist_t=hist[2], hist_slot=hist[3], n_obs=hist[4], counter=ts.counter + 1)
    return ts2, point_harvest


def _liveness(state: FilterState, hist_slot, hist_t, obs_mask):
    """Drop history entries whose clone ring slot was reused or
    marginalized: an entry is live iff its slot still holds a clone with the
    same timestamp."""
    B = hist_slot.shape[0]
    flat = hist_slot.reshape(B, -1)
    slot_t = torch.gather(state.clone_t, 1, flat).reshape(hist_slot.shape)
    slot_ok = torch.gather(state.clone_valid, 1, flat).reshape(hist_slot.shape)
    return obs_mask & slot_ok & (slot_t == hist_t)


def fused_frame(state: FilterState, ts: TrackState, img,
                imu_t, imu_w, imu_a, t_new,
                wheel_t, wheel_m1, wheel_m2, wheel_valid,
                gravity, sigmas, sigma_pix, chi2_mult, sigma_line, wheel_noise,
                model: int = 0, window_size: float = 1.0, cam_dtype=F32,
                wheel_type: int = wheel_up.W3D_ANG, min_track: int = 4,
                half: int = 7, iters: int = 6, grid_x: int = 16, grid_y: int = 12,
                min_px_dist: int = 10, use_wheel: bool = True, use_lines: bool = True,
                use_gps: bool = False, use_dynamic: bool = False,
                use_stereo: bool = False):
    """One images-in VIWO frame for B sequences: pixels -> tracking ->
    filter, with ONE joint EKF update.

    Batch-first: img (B,H,W) f32; imu_t (B,Ni) f64, imu_w/imu_a (B,Ni,3);
    t_new (B,); wheel_t/wheel_m1/wheel_m2 (B,Nw); wheel_valid (B,) bool;
    gravity (3,) f64 tensor on the device.  Returns (state', ts', metrics
    of (B,) tensors).  `use_lines` defaults to True as in the JAX package
    and must be passed False: the line front-end is not ported yet.
    `sigma_line` is the JAX signature's line noise, unused without lines."""
    if use_lines:
        raise NotImplementedError("use_lines=True: the line front-end is not ported yet "
                                  "(ROADMAP A6b); pass use_lines=False")
    if use_gps:
        raise NotImplementedError("use_gps=True: GPS rows are not ported yet (ROADMAP A7)")
    if use_stereo or use_dynamic:
        raise NotImplementedError("use_stereo / use_dynamic: stereo and dynamic cloning "
                                  "are not ported yet (ROADMAP A8)")
    # --- filter time update ---
    state = propagator.propagate(state, imu_t, imu_w, imu_a, t_new, gravity, sigmas)
    state = _auto_marginalize(state, t_new, window_size)
    slot0 = newest_clone_slot(state)  # wheel interval start clone
    state = ekf.augment_clone(state)
    slot1 = newest_clone_slot(state)  # the clone just inserted

    # --- front-end ---
    ts, (p_uv, p_uvn, p_slot, p_mask, p_t) = track_frame(
        ts, img, state.cam_k[:, 0], t_new, slot1, half=half, iters=iters, grid_x=grid_x,
        grid_y=grid_y, min_px_dist=min_px_dist, min_track=min_track, cam_model=model)
    p_mask = _liveness(state, p_slot, p_t, p_mask)
    p_mask = p_mask & (torch.sum(p_mask, dim=-1, keepdim=True) >= 3)

    # --- rows at the common pre-update state, summed and factored once ---
    G, c, metrics = _camera_msckf_rows(state, p_uv, p_uvn, p_slot, p_mask, sigma_pix,
                                       chi2_mult, model, cam_dtype)
    if use_wheel:
        Hw, rw, mw, wheel_accepted = _wheel_rows(
            state, slot0, slot1, wheel_t, wheel_m1, wheel_m2, wheel_valid, wheel_noise,
            chi2_mult, wheel_type, preint_dtype=cam_dtype)
        Gw, cw = _rows_to_gram(Hw, rw, mw)
        G, c = G + Gw, c + cw
    else:
        wheel_accepted = torch.zeros_like(metrics["accepted"], dtype=torch.int32)
    Hj, rj, mj = ekf.compress_from_gram(G, c)
    state = ekf.update(state, Hj, rj, torch.ones_like(rj), mj)

    metrics = dict(metrics)
    metrics["wheel_accepted"] = wheel_accepted
    metrics["tracked"] = torch.sum(ts.valid, dim=-1)
    metrics["harvested"] = torch.sum(torch.any(p_mask, dim=-1), dim=-1)
    return state, ts, metrics
