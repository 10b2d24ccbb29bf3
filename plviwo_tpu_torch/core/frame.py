"""Images-in fused frame (port of plviwo_tpu/core/frame.py), batch-first.

One frame for B sequences: hist-equalize -> pyramid -> pyramidal LK (the
hand kernel `csrc/lk_pyramid.cu` on the card; with `lk_conv=False` the
gather form `ops/klt.pyramidal_lk` in plain torch, as JAX's frame runs its
gather LK under `cam.fused_lk_conv=False`) -> undistort -> RANSAC gate
-> per-slot observation histories -> grid re-detect into free slots ->
run-length line detection at half resolution -> collinear NMS -> point
attachment -> shared-point line matching -> line histories -> track
harvest -> IMU propagate -> marginalize -> clone -> point rows and line
rows (the gate/Gram kernel, k = 3 and k = 4) + wheel rows + GPS rows ->
ONE joint EKF update.

A feature IS its slot: a tracked point keeps a fixed slot for its
lifetime, and a line is matched to last frame's line by the point slots
both have attached (a product of attach masks, not a dictionary of ids).
Observation histories carry (clone slot, time) pairs, used at harvest only
while the clone ring slot still holds the same timestamp.

Stereo (`use_stereo`, a right image): the left stream keeps slot
identity, and each frame one more LK launch tracks the survivors from the
left pyramid into the right one (the guess at the left position), gated on
the epipolar band; the right observations share the left ones' history
cursors and clone slots, and the point rows take both series, a camera
per observation.  Dynamic cloning (`use_dynamic`, a per-sequence
`do_clone`): marginalize + clone runs under a mask, point observations are
resolved by time against the clone ring and update interpolated poses, and
lines keep the slot liveness test.  With both flags on the dynamic rows
win and the right observations go unused, as in the JAX package.  The
pyramid has the JAX package's fixed three levels.  Nothing in a frame
reads a value back to the host; metrics are (B,) tensors.

Stage spans (`utils/timing.span`, recorded only under a profiler): `frame`
around the call, tiled by `frame.time_update` (propagate, marginalize,
clone, the dynamic select), `frame.frontend` (`track_frame`, with
`frame.frontend.lines` around its line branch), `frame.rows` (liveness and
every row, the gate/Gram kernel included) and `frame.update` (compression
and the EKF update).

On a card `fused_frame` runs as CUDA graphs where its key repeats
(`utils/graphs`: the tensors' shapes and dtypes, the flags and the Python
scalars the operators bake in): at a key's third call the operator chains
between the spans' edges and the kernels' calls are captured, about ten
graphs a frame, and later calls replay them.  The LK and gate/Gram kernels stay eager calls through
their wrappers' module names (`lk_kernel.pyramidal_lk`, `step.gram_gate`),
and every span is entered and left outside the graphs.  What the frame
returns and the kernels' arguments are never graph memory.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch
from torch.utils import _pytree as pytree

from ..ops import cam as cam_ops
from ..ops import image as image_ops
from ..ops import klt as klt_ops
from ..ops import line_detect, lk_kernel
from ..update import wheel as wheel_up
from ..utils import graphs
from . import ekf, propagator
from .state import CUDA, FilterState, checked_device, newest_clone_slot
from .step import (_auto_marginalize, _camera_msckf_rows, _camera_msckf_rows_interp,
                   _camera_msckf_rows_stereo, _gps_rows, _line_msckf_rows, _rows_to_gram,
                   _wheel_rows)

F32 = torch.float32
F64 = torch.float64
LEVELS = 3  # pyramid levels (TrackState holds pyr0..pyr2)
MIN_LINE_LENGTH = 30.0  # px at full resolution, below which NMS drops a candidate
MIN_TRACK_LINE = 3  # observations a lost line needs to be harvested
MAX_Y_DIFF = 6.0  # px: the epipolar band of the L->R association (stereo)


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
    lseg: torch.Tensor      # (B,Lm,4) f32 current raw endpoints [x1 y1 x2 y2]
    lvalid: torch.Tensor    # (B,Lm) bool
    lattach: torch.Tensor   # (B,Lm,N) bool point slots attached (last frame)
    lhist_uv: torch.Tensor  # (B,Lm,O,4) f32
    lhist_uvn: torch.Tensor  # (B,Lm,O,4) f32
    lhist_t: torch.Tensor   # (B,Lm,O) f64
    lhist_slot: torch.Tensor  # (B,Lm,O) int64
    l_nobs: torch.Tensor    # (B,Lm) int64
    uv_r: torch.Tensor      # (B,N,2) f32 stereo: right-camera positions (this frame)
    rvalid: torch.Tensor    # (B,N) bool right association ok
    hist_uv_r: torch.Tensor  # (B,N,O,2) f32 right observations at the left cursors
    hist_uvn_r: torch.Tensor  # (B,N,O,2) f32
    hist_rvalid: torch.Tensor  # (B,N,O) bool
    key: torch.Tensor       # (B,) int64 RANSAC key per sequence (the JAX package's `key`)
    counter: torch.Tensor   # (B,) int64 frames tracked: with `key`, what RANSAC draws from

    def replace(self, **kw) -> "TrackState":
        return dataclasses.replace(self, **kw)


# the frame's states, walked by `utils/graphs` as trees of tensors and values
for _cls in (FilterState, TrackState):
    pytree.register_dataclass(_cls, field_names=[f.name for f in dataclasses.fields(_cls)])


def make_track_state(height: int, width: int, n_pts: int = 128, max_lines: int = 24,
                     max_obs: int = 10, seed: int = 0, *, batch: int = 1,
                     device=CUDA) -> TrackState:
    """Empty front-end state of `batch` sequences on `device`, with the JAX
    package's positional signature.  Sequence b's RANSAC key is seed + b
    (JAX's bench gives sequence b `PRNGKey(b)`), its frame counter 0."""
    dev = checked_device(device)
    B, N, Lm, O = batch, n_pts, max_lines, max_obs

    def z(*shape, dtype=F32):
        return torch.zeros((B,) + shape, dtype=dtype, device=dev)

    return TrackState(
        pyr0=z(height, width), pyr1=z(height // 2, width // 2),
        pyr2=z(height // 4, width // 4), has_prev=z(dtype=torch.bool),
        uv=z(N, 2), valid=z(N, dtype=torch.bool),
        hist_uv=z(N, O, 2), hist_uvn=z(N, O, 2),
        hist_t=torch.full((B, N, O), -torch.inf, dtype=F64, device=dev),
        hist_slot=z(N, O, dtype=torch.int64), n_obs=z(N, dtype=torch.int64),
        lseg=z(Lm, 4), lvalid=z(Lm, dtype=torch.bool), lattach=z(Lm, N, dtype=torch.bool),
        lhist_uv=z(Lm, O, 4), lhist_uvn=z(Lm, O, 4),
        lhist_t=torch.full((B, Lm, O), -torch.inf, dtype=F64, device=dev),
        lhist_slot=z(Lm, O, dtype=torch.int64), l_nobs=z(Lm, dtype=torch.int64),
        uv_r=z(N, 2), rvalid=z(N, dtype=torch.bool), hist_uv_r=z(N, O, 2), hist_uvn_r=z(N, O, 2),
        hist_rvalid=z(N, O, dtype=torch.bool),
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


def _append_r(h_uv, h_uvn, h_rv, cursor, mask, uv_r, uvn_r, rv):
    """Write the right-camera observation at the left append's cursors
    (masked).  uv_r, uvn_r (B,N,2); rv (B,N) bool."""
    O = h_uv.shape[2]
    cur = torch.clamp(cursor, 0, O - 1)
    at = (torch.arange(O, device=cur.device) == cur[..., None]) & mask[..., None]
    return (torch.where(at[..., None], uv_r[:, :, None].to(F32), h_uv),
            torch.where(at[..., None], uvn_r[:, :, None].to(F32), h_uvn),
            torch.where(at, rv[..., None], h_rv))


def _restart(hist_uv, hist_uvn, hist_t, hist_slot, n_obs, mask):
    """Empty the histories of the masked tracks."""
    m = mask[..., None]
    return (torch.where(m[..., None], 0.0, hist_uv), torch.where(m[..., None], 0.0, hist_uvn),
            torch.where(m, -torch.inf, hist_t), torch.where(m, 0, hist_slot),
            torch.where(mask, 0, n_obs))


def _norm2(x, y):
    return torch.sqrt(x * x + y * y)


def _dot2(a, b):
    """Sum over a last axis of 2 (the JAX package's 2-wide einsums and
    matmuls), as two products and one add."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]


def _segment_nms(segs, valid):
    """Collinear merge + dominance NMS of B candidate sets: segment i
    survives iff no longer segment j (the lower index among equal lengths)
    is collinear and overlapping with it, and each survivor extends its
    endpoints over the span of the fragments it suppressed (3 fixed passes
    of span growth).  Segments shorter than MIN_LINE_LENGTH are dropped.
    segs (B,A,4), valid (B,A).  Returns (merged segs (B,A,4), keep (B,A));
    the JAX version also returns the merged lengths, which no caller
    reads."""
    A = segs.shape[1]
    # JAX's default tolerances: angle (rad), perpendicular distance and
    # longitudinal slack (px)
    cos_tol, dist_tol, overlap_slack = math.cos(0.10), 3.0, 10.0
    p1, p2 = segs[..., :2], segs[..., 2:]
    d = p2 - p1
    L = _norm2(d[..., 0], d[..., 1])
    valid = valid & (L >= MIN_LINE_LENGTH)
    dn = d / torch.clamp(L, min=1e-6)[..., None]
    nrm = torch.stack([-dn[..., 1], dn[..., 0]], dim=-1)
    mid = 0.5 * (p1 + p2)

    # pairwise (i, j): angle agreement, perpendicular distance of mid_i to
    # j's line, longitudinal overlap with j
    cosang = torch.abs(_dot2(dn[:, :, None], dn[:, None]))
    relm = mid[:, :, None] - p1[:, None]  # (B,A,A,2): mid_i - a_j
    perp = torch.abs(_dot2(relm, nrm[:, None]))
    t_mid = _dot2(relm, dn[:, None])
    half_i = (0.5 * L)[..., None]
    overlap = ((t_mid + half_i > -overlap_slack)
               & (t_mid - half_i < L[:, None] + overlap_slack))
    dup = (cosang > cos_tol) & (perp < dist_tol) & overlap
    dup = dup & valid[:, :, None] & valid[:, None]
    # j dominates i when longer, the lower index among equal lengths
    ar = torch.arange(A, device=segs.device)
    better = (L[:, None] > L[:, :, None]) | ((L[:, None] == L[:, :, None])
                                             & (ar[None, :] < ar[:, None]))
    keep = valid & ~torch.any(dup & better, dim=-1)

    # span growth in keeper j's frame (anchor a_j, direction d_j): j absorbs
    # every suppressed collinear fragment whose projected span overlaps j's
    # current span
    elig = (keep[:, :, None] & valid[:, None] & ~keep[:, None] & (cosang > cos_tol)
            & (perp.transpose(1, 2) < dist_tol))
    elig = elig | (keep[:, :, None] & torch.eye(A, dtype=torch.bool, device=segs.device))
    t1 = _dot2(p1[:, None] - p1[:, :, None], dn[:, :, None])  # (B,j,i): (p1_i - a_j) . d_j
    t2 = _dot2(p2[:, None] - p1[:, :, None], dn[:, :, None])
    t_lo, t_hi = torch.minimum(t1, t2), torch.maximum(t1, t2)
    span_lo, span_hi = torch.zeros_like(L), L
    for _ in range(3):
        member = (elig & (t_hi > span_lo[..., None] - overlap_slack)
                  & (t_lo < span_hi[..., None] + overlap_slack))
        span_lo = torch.amin(torch.where(member, t_lo, torch.inf), dim=-1)
        span_hi = torch.amax(torch.where(member, t_hi, -torch.inf), dim=-1)
        span_lo = torch.where(torch.isfinite(span_lo), span_lo, 0.0)
        span_hi = torch.where(torch.isfinite(span_hi), span_hi, L)
    merged = torch.cat([p1 + span_lo[..., None] * dn, p1 + span_hi[..., None] * dn], dim=-1)
    return torch.where(keep[..., None], merged, segs), keep


def _attach_points(segs, seg_valid, uv, pt_valid):
    """(B,A,N) bool: point slot n lies within 5 px of segment a and
    longitudinally inside it, 5 px extended (JAX's defaults).  segs
    (B,A,4), uv (B,N,2)."""
    max_dist = long_slack = 5.0
    d = segs[..., 2:] - segs[..., :2]
    L = _norm2(d[..., 0], d[..., 1])
    dn = d / torch.clamp(L, min=1e-6)[..., None]
    nrm = torch.stack([-dn[..., 1], dn[..., 0]], dim=-1)
    rel = uv[:, None] - segs[:, :, None, :2]  # (B,A,N,2)
    perp = torch.abs(_dot2(rel, nrm[:, :, None]))
    t = _dot2(rel, dn[:, :, None])
    inside = (t > -long_slack) & (t < L[..., None] + long_slack)
    return (perp < max_dist) & inside & seg_valid[..., None] & pt_valid[:, None]


def _take(x, idx):
    """x (B,M,...) at indices idx (B,K) along axis 1."""
    return torch.gather(x, 1, idx.reshape(idx.shape + (1,) * (x.ndim - 2)).expand(
        idx.shape + x.shape[2:]))


def _match_lines(ts: TrackState, segs_c, cand_keep, cand_attach, surv):
    """Shared-point matching of candidates to last frame's lines: a pair
    needs 2 shared surviving point slots, or 1 and midpoints within 12 px;
    the best candidate and the best line must choose each other.  Returns
    (mutual_c (B,A), l_matched (B,Lm), c_of_l (B,Lm))."""
    A, Lm = segs_c.shape[1], ts.lseg.shape[1]
    shared = torch.matmul((cand_attach & surv[:, None]).to(F32),
                          (ts.lattach & surv[:, None]).to(F32).transpose(1, 2))  # (B,A,Lm)
    mid_c = 0.5 * (segs_c[..., :2] + segs_c[..., 2:])
    mid_l = 0.5 * (ts.lseg[..., :2] + ts.lseg[..., 2:])
    dm = mid_c[:, :, None] - mid_l[:, None]
    mid_d = _norm2(dm[..., 0], dm[..., 1])
    pair_ok = (shared >= 2.0) | ((shared >= 1.0) & (mid_d < 12.0))
    pair_ok = pair_ok & cand_keep[..., None] & ts.lvalid[:, None]
    score = torch.where(pair_ok, shared - 1e-3 * mid_d, -torch.inf)
    # argmax takes the first maximum: a row or column of -inf gives 0, as in JAX
    best_l = torch.argmax(score, dim=2)  # (B,A) per candidate
    best_c = torch.argmax(score, dim=1)  # (B,Lm) per old line
    ar = torch.arange(A, device=segs_c.device)
    mutual_c = ((torch.gather(best_c, 1, best_l) == ar)
                & torch.isfinite(torch.amax(score, dim=2)))
    # several candidates may name the same line: amax scatters are exact in
    # any order
    z = torch.zeros((segs_c.shape[0], Lm), dtype=torch.int64, device=segs_c.device)
    l_matched = z.scatter_reduce(1, best_l, mutual_c.to(torch.int64), "amax").bool()
    c_of_l = z.scatter_reduce(1, best_l, torch.where(mutual_c, ar, 0), "amax")
    return mutual_c, l_matched, c_of_l


class _LineSlots(NamedTuple):
    """What matching decides for the Lm line slots of B sequences."""

    lseg_cur: torch.Tensor     # (B,Lm,4) matched lines at this frame's candidate, else as before
    lseg_all: torch.Tensor     # (B,Lm,4) lseg_cur with the free slots filled
    l_alive: torch.Tensor      # (B,Lm) lines matched this frame
    lh_dead: torch.Tensor      # (B,Lm) lines lost this frame with enough observations
    lfilled: torch.Tensor      # (B,Lm) free slots given a new line
    ltake: torch.Tensor        # (B,Lm) candidate of each filled slot
    cand_attach: torch.Tensor  # (B,A,N) point slots attached to each kept candidate


def _line_slots(ts: TrackState, segs_h, cand_ok, uv_all, valid_all, alive) -> _LineSlots:
    """NMS of the half-resolution candidates at full-resolution coordinates,
    point attachment (a line with no attached point is dropped), matching
    to last frame's lines on the point slots that survived tracking, and the
    fill of free slots with the unmatched candidates in anchor order."""
    segs_c, cand_keep = _segment_nms(segs_h * 2.0, cand_ok)
    cand_attach = _attach_points(segs_c, cand_keep, uv_all, valid_all)
    cand_keep = cand_keep & torch.any(cand_attach, dim=-1)
    cand_attach = cand_attach & cand_keep[..., None]
    mutual_c, l_matched, c_of_l = _match_lines(ts, segs_c, cand_keep, cand_attach, alive)
    l_alive = ts.lvalid & l_matched
    lseg_cur = torch.where(l_alive[..., None], _take(segs_c, c_of_l), ts.lseg)
    ltake, lfilled = _fill_free_slots(~l_alive, cand_keep & ~mutual_c)
    return _LineSlots(
        lseg_cur=lseg_cur,
        lseg_all=torch.where(lfilled[..., None], _take(segs_c, ltake), lseg_cur),
        l_alive=l_alive, lh_dead=ts.lvalid & ~l_matched & (ts.l_nobs >= MIN_TRACK_LINE),
        lfilled=lfilled, ltake=ltake, cand_attach=cand_attach)


def _line_histories(ts: TrackState, ls: _LineSlots, lseg_n, uv_all, valid_all, t_new, slot_new):
    """Line observation histories: append the matched lines, harvest the
    dead and the full ones, restart the full ones at this frame (the JAX
    package's restart, as it is), start the fresh ones; then the attachment
    of the slots now holding lines.  lseg_n (B,Lm,4) are lseg_all's
    undistorted endpoints.  Returns (histories, line_harvest, lattach)."""
    O = ts.lhist_uv.shape[2]
    lhist = _append_obs(ts.lhist_uv, ts.lhist_uvn, ts.lhist_t, ts.lhist_slot, ts.l_nobs,
                        ls.l_alive, ls.lseg_cur, lseg_n, t_new, slot_new)
    lh_full = ls.l_alive & (lhist[4] >= O)
    l_cnt = torch.where(ls.lh_dead, ts.l_nobs, lhist[4])
    l_obs_mask = ((torch.arange(O, device=l_cnt.device) < l_cnt[..., None])
                  & (ls.lh_dead | lh_full)[..., None])
    line_harvest = (lhist[0], lhist[1], lhist[3], l_obs_mask, lhist[2])
    lhist = _append_obs(*_restart(*lhist, lh_full), lh_full, ls.lseg_cur, lseg_n, t_new, slot_new)
    lhist = _append_obs(*_restart(*lhist, ls.lfilled), ls.lfilled, ls.lseg_all, lseg_n, t_new,
                        slot_new)
    lattach = torch.where(ls.l_alive[..., None],
                          _attach_points(ls.lseg_cur, ls.l_alive, uv_all, valid_all), False)
    lattach = torch.where(ls.lfilled[..., None], _take(ls.cand_attach, ls.ltake), lattach)
    return lhist, line_harvest, lattach


def track_frame(ts: TrackState, img, cam_k, t_new, slot_new, half: int = 7,
                iters: int = 6, grid_x: int = 16, grid_y: int = 12,
                min_px_dist: int = 10, min_track: int = 4, cam_model: int = 0,
                lines: bool = True, img_r=None, cam_k_r=None, lk_conv: bool = True):
    """One tracked camera frame of B sequences: points and, with `lines`,
    lines.

    img (B,H,W); cam_k (B,8); t_new (B,) f64; slot_new (B,) the clone slot
    of this frame.  Returns (ts', point_harvest, line_harvest) with
    point_harvest = (obs_uv (B,N,O,2) f32, obs_uvn, obs_slot (B,N,O),
    obs_mask (B,N,O), hist_t (B,N,O) f64) and line_harvest the same with
    4-wide endpoint rows over the Lm line slots; each obs_mask folds the
    per-track harvest decision, the caller adds the clone ring liveness
    test.  Without `lines` the line block is skipped: the line fields of
    ts are returned as they came and line_harvest is None (the JAX package
    always runs it; nothing of it reaches the filter without line rows).

    With a right image img_r (B,H,W) (stereo; cam_k_r (B,8) its
    intrinsics) the survivors are tracked from this frame's left pyramid
    into the right one (a second LK launch, the guess at the left
    position), kept where |v_r - v_l| < MAX_Y_DIFF, and written at the
    left append's cursors; fresh detections carry no right observation.
    point_harvest then has three more entries, (obs_uv_r, obs_uvn_r,
    obs_mask & right valid), as the JAX package's.  lk_conv: both LK passes
    through the LK kernel (conv form); else through the gather form."""
    N = ts.uv.shape[1]
    O = ts.hist_uv.shape[2]
    B, Lm = ts.lseg.shape[:2]
    kb = cam_k[:, None, :]

    img = image_ops.hist_equalize_quantile(img.to(F32))
    pyr = image_ops.build_pyramid(img, LEVELS)

    # ---- temporal LK + RANSAC ----
    has_prev = ts.has_prev[:, None]

    def lk(*args):
        # the kernel runs outside any CUDA graph, called through its module name
        if lk_conv:
            return graphs.call(lambda: lk_kernel.pyramidal_lk, *args)
        return klt_ops.pyramidal_lk(*args)

    uv_next, ok = lk((ts.pyr0, ts.pyr1, ts.pyr2), pyr, ts.uv, ts.valid & has_prev, LEVELS,
                     half, iters)
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

    # ---- stereo: one L->R LK pass per frame under slot identity ----
    stereo = img_r is not None
    if stereo:
        pyr_r = image_ops.build_pyramid(image_ops.hist_equalize_quantile(img_r.to(F32)),
                                        LEVELS)
        uv_r, ok_r = lk(pyr, pyr_r, uv_cur, alive, LEVELS, half, iters)
        ok_r = ok_r & (torch.abs(uv_r[..., 1] - uv_cur[..., 1]) < MAX_Y_DIFF)
        uvn_r = cam_ops.undistort(uv_r.to(F64), cam_k_r[:, None, :], cam_model)
        hist_r = _append_r(ts.hist_uv_r, ts.hist_uvn_r, ts.hist_rvalid, ts.n_obs, alive, uv_r,
                           uvn_r, ok_r)

    # ---- harvest full tracks (keep the corner tracked; restart history) ----
    h_full = alive & (n_obs >= O)
    obs_cnt = torch.where(h_dead, ts.n_obs, n_obs)  # dead: pre-append count
    obs_mask = ((torch.arange(O, device=n_obs.device) < obs_cnt[..., None])
                & (h_dead | h_full)[..., None])
    point_harvest = (hist[0], hist[1], hist[3], obs_mask, hist[2])
    hist = _append_obs(*_restart(*hist, h_full), h_full, uv_cur, zn_next, t_new, slot_new)
    if stereo:
        point_harvest += (hist_r[0], hist_r[1], obs_mask & hist_r[2])
        full = h_full[..., None]
        hist_r = _append_r(torch.where(full[..., None], 0.0, hist_r[0]),
                           torch.where(full[..., None], 0.0, hist_r[1]),
                           torch.where(full, False, hist_r[2]), torch.zeros_like(n_obs),
                           h_full, uv_r, uvn_r, ok_r)

    # ---- re-detect into free slots: fresh tracks, the detection as first obs ----
    det_uv, det_ok = klt_ops.detect_grid(pyr[0], uv_cur, alive, grid_x, grid_y, N,
                                         min_px_dist=float(min_px_dist))
    take, filled = _fill_free_slots(~alive, det_ok)
    uv_all = torch.where(filled[..., None], _take(det_uv, take), uv_cur)
    valid_all = alive | filled
    if lines:
        # ---- lines: detect at half resolution (FLD on pyrDown in the
        # reference), coordinates x2; match to last frame's lines; fill slots ----
        with graphs.span("frame.frontend.lines"):
            segs_h, _, cand_ok = line_detect.detect_segments_runlen(pyr[1])
            ls = _line_slots(ts, segs_h, cand_ok, uv_all, valid_all, alive)
            # one undistort for the point slots and the line endpoints (per
            # point, so it equals JAX's three calls; lseg_all equals lseg_cur
            # where l_alive)
            zn = cam_ops.undistort(torch.cat([uv_all, ls.lseg_all.reshape(B, 2 * Lm, 2)], dim=1)
                                   .to(F64), kb, cam_model)
            zn_new, lseg_n = zn[:, :N], zn[:, N:].reshape(B, Lm, 4)
            lhist, line_harvest, lattach = _line_histories(ts, ls, lseg_n, uv_all, valid_all,
                                                           t_new, slot_new)
            fields = dict(
                lseg=ls.lseg_all.to(F32), lvalid=ls.l_alive | ls.lfilled, lattach=lattach,
                lhist_uv=lhist[0], lhist_uvn=lhist[1], lhist_t=lhist[2], lhist_slot=lhist[3],
                l_nobs=lhist[4])
    else:
        zn_new = cam_ops.undistort(uv_all.to(F64), kb, cam_model)
        line_harvest, fields = None, {}
    hist = _append_obs(*_restart(*hist, filled), filled, uv_all, zn_new, t_new, slot_new)
    if stereo:
        # fresh detections carry no right observation on their first frame
        # (the L->R association runs before the re-detect)
        fresh = filled[..., None]
        fields.update(
            uv_r=uv_r.to(F32), rvalid=alive & ok_r,
            hist_uv_r=torch.where(fresh[..., None], 0.0, hist_r[0]),
            hist_uvn_r=torch.where(fresh[..., None], 0.0, hist_r[1]),
            hist_rvalid=torch.where(fresh, False, hist_r[2]))

    ts2 = ts.replace(
        pyr0=pyr[0], pyr1=pyr[1], pyr2=pyr[2], has_prev=torch.ones_like(ts.has_prev),
        uv=uv_all.to(F32), valid=valid_all, hist_uv=hist[0], hist_uvn=hist[1],
        hist_t=hist[2], hist_slot=hist[3], n_obs=hist[4], counter=ts.counter + 1,
        **fields)
    return ts2, point_harvest, line_harvest


def _liveness(state: FilterState, hist_slot, hist_t, obs_mask):
    """Drop history entries whose clone ring slot was reused or
    marginalized: an entry is live iff its slot still holds a clone with the
    same timestamp."""
    B = hist_slot.shape[0]
    flat = hist_slot.reshape(B, -1)
    slot_t = torch.gather(state.clone_t, 1, flat).reshape(hist_slot.shape)
    slot_ok = torch.gather(state.clone_valid, 1, flat).reshape(hist_slot.shape)
    return obs_mask & slot_ok & (slot_t == hist_t)


def _select(mask, a: FilterState, b: FilterState) -> FilterState:
    """Per sequence, the fields of a where mask (B,) is true, else b's."""
    def pick(x, y):
        return torch.where(mask.view((-1,) + (1,) * (x.ndim - 1)), x, y)

    return a.replace(**{f.name: pick(getattr(a, f.name), getattr(b, f.name))
                        for f in dataclasses.fields(a) if f.name != "layout"})


@graphs.graphed
def fused_frame(state: FilterState, ts: TrackState, img,
                imu_t, imu_w, imu_a, t_new,
                wheel_t, wheel_m1, wheel_m2, wheel_valid,
                gravity, sigmas, sigma_pix, chi2_mult, sigma_line, wheel_noise,
                model: int = 0, window_size: float = 1.0, cam_dtype=F32,
                wheel_type: int = wheel_up.W3D_ANG, min_track: int = 4, half: int = 7,
                iters: int = 6, grid_x: int = 16, grid_y: int = 12, min_px_dist: int = 10,
                use_wheel: bool = True, use_lines: bool = True,
                use_gps: bool = False, gps_t=None, gps_p=None, gps_valid=None,
                sigma_gps: float = 3.0, gps_chi2_mult: float = 1.0,
                use_dynamic: bool = False, do_clone=None, use_stereo: bool = False,
                img_r=None, lk_conv: bool = True):
    """One images-in PL-VIWO frame for B sequences: pixels -> tracking
    (points and lines) -> filter, with ONE joint EKF update of the point,
    line, wheel and GPS rows.

    Batch-first: img (B,H,W) f32; imu_t (B,Ni) f64, imu_w/imu_a (B,Ni,3);
    t_new (B,); wheel_t/wheel_m1/wheel_m2 (B,Nw); wheel_valid (B,) bool;
    gravity (3,) f64 tensor on the device; with use_gps, gps_t (B,Ng) f64,
    gps_p (B,Ng,3), gps_valid (B,Ng) bool, in a world frame that is the ENU
    frame.  Returns (state', ts', metrics of (B,) tensors).  With
    use_lines=False no line rows join the update, as in JAX, and the line
    front-end, whose tracks would reach nothing else, is skipped: the line
    fields of ts stay as they came (JAX runs it all the same).

    use_dynamic: do_clone (B,) bool says per sequence whether a clone lands
    at this frame (the host's rate policy); the point rows update poses
    interpolated between clones, and the wheel rows, clone to clone, count
    only where do_clone.  use_stereo: img_r (B,H,W) the right image, camera
    1 of the state (camera 0 where it has one camera).  lk_conv=False
    tracks with the gather LK instead of the LK kernel (`track_frame`).

    On a card a key's first two calls run eagerly, its third captures the
    frame's CUDA graphs and later ones replay them (module docstring);
    `fused_frame.graphs` counts the calls of each kind."""
    with graphs.span("frame"):
        # --- filter time update ---
        with graphs.span("frame.time_update"):
            state = propagator.propagate(state, imu_t, imu_w, imu_a, t_new, gravity, sigmas)
            state_m = _auto_marginalize(state, t_new, window_size)
            slot0 = newest_clone_slot(state_m)  # wheel interval start clone
            state_c = ekf.augment_clone(state_m)
            slot1 = newest_clone_slot(state_c)  # the clone just inserted
            # dynamic cloning: marginalize + clone under the per-sequence mask
            # (the slots are the cloned variant's, as in JAX)
            state = _select(do_clone, state_c, state) if use_dynamic else state_c

        # --- front-end ---
        with graphs.span("frame.frontend"):
            n_cams = state.cam_k.shape[1]
            ts, point_harvest, line_harvest = track_frame(
                ts, img, state.cam_k[:, 0], t_new, slot1, half=half, iters=iters,
                grid_x=grid_x, grid_y=grid_y, min_px_dist=min_px_dist, min_track=min_track,
                cam_model=model, lines=use_lines, img_r=img_r if use_stereo else None,
                cam_k_r=state.cam_k[:, 1 % n_cams], lk_conv=lk_conv)

        # --- rows at the common pre-update state, summed and factored once ---
        with graphs.span("frame.rows"):
            p_uv, p_uvn, p_slot, p_mask, p_t = point_harvest[:5]
            if not use_dynamic:
                # dynamic: observations are resolved by time in the row builder
                p_mask = _liveness(state, p_slot, p_t, p_mask)
            p_mask = p_mask & (torch.sum(p_mask, dim=-1, keepdim=True) >= 3)
            if use_dynamic:
                G, c, metrics = _camera_msckf_rows_interp(state, p_uv, p_uvn, p_t, p_mask,
                                                          sigma_pix, chi2_mult, model, cam_dtype)
            elif use_stereo:
                r_uv, r_uvn, r_mask = point_harvest[5:]
                G, c, metrics = _camera_msckf_rows_stereo(state, p_uv, p_uvn, p_slot, p_mask,
                                                          r_uv, r_uvn, r_mask & p_mask,
                                                          sigma_pix, chi2_mult, model, cam_dtype)
            else:
                G, c, metrics = _camera_msckf_rows(state, p_uv, p_uvn, p_slot, p_mask, sigma_pix,
                                                   chi2_mult, model, cam_dtype)
            none = torch.zeros_like(metrics["accepted"], dtype=torch.int32)
            lines_accepted = wheel_accepted = gps_accepted = line_harvested = none
            if use_lines:
                l_uv, l_uvn, l_slot, l_mask, l_t = line_harvest
                l_mask = _liveness(state, l_slot, l_t, l_mask)
                l_mask = l_mask & (torch.sum(l_mask, dim=-1, keepdim=True) >= 3)
                line_harvested = torch.sum(torch.any(l_mask, dim=-1), dim=-1)
                G2, c2, lines_accepted = _line_msckf_rows(
                    state, l_uv.to(F64), l_uvn.to(F64), l_slot, l_mask, sigma_line, chi2_mult,
                    cam_dtype=cam_dtype)
                G, c = G + G2, c + c2
            if use_wheel:
                # dynamic cloning: the interval is clone to clone, so rows land
                # only on clone frames (the host's window spans the whole gap)
                Hw, rw, mw, wheel_accepted = _wheel_rows(
                    state, slot0, slot1, wheel_t, wheel_m1, wheel_m2,
                    wheel_valid & do_clone if use_dynamic else wheel_valid, wheel_noise,
                    chi2_mult, wheel_type, preint_dtype=cam_dtype)
                Gw, cw = _rows_to_gram(Hw, rw, mw)
                G, c = G + Gw, c + cw
            if use_gps:
                Hg, rg, mg, gps_accepted = _gps_rows(state, gps_t, gps_p, gps_valid, sigma_gps,
                                                     gps_chi2_mult)
                Gg, cg = _rows_to_gram(Hg, rg, mg)
                G, c = G + Gg, c + cg
        with graphs.span("frame.update"):
            Hj, rj, mj = ekf.compress_from_gram(G, c)
            state = ekf.update(state, Hj, rj, torch.ones_like(rj), mj)

        metrics = dict(metrics)
        metrics["lines_accepted"] = lines_accepted
        metrics["wheel_accepted"] = wheel_accepted
        metrics["gps_accepted"] = gps_accepted
        metrics["tracked"] = torch.sum(ts.valid, dim=-1)
        metrics["line_tracked"] = torch.sum(ts.lvalid, dim=-1)
        metrics["harvested"] = torch.sum(torch.any(p_mask, dim=-1), dim=-1)
        metrics["line_harvested"] = line_harvested
    return state, ts, metrics
