"""KLT point trackers on the host path (port of plviwo_tpu/update/tracker.py).

`KltTracker.feed` is `ov_core::TrackKLT::feed_monocular`
(TrackKLT.cpp:96-200): equalize (the LUT `hist_equalize`), build the
pyramid, track the live features with pyramidal LK, gate them with a
fundamental-matrix RANSAC on undistorted coordinates, and refill the free
slots with grid detections under new ids.  Feature slots are fixed (n_pts)
with validity masks.  `StereoKltTracker.feed_stereo` adds a left->right LK
pass a frame under shared ids.

Every step runs on the tracker's device, B = 1, with the port's ops: LK is
the gather form `klt.pyramidal_lk`, as JAX's host tracker calls it (plain
torch on the card too: JAX runs it in XLA, outside any kernel; the LK
kernel serves the images-in frame's conv form).  The RANSAC draws are the
port's stateless (key, counter) hash (`klt.draw_hypotheses`); the counter
counts the frames that ran RANSAC, as JAX's key is split once for each of
them.  The decisions JAX takes on the host (RANSAC only with >= 12 tracked
features; detections into the free slots in order) are taken on the
device, so a frame reads the device once:
the slots' pixels, validity and ids (and with stereo the right pixels).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..core.state import CUDA, checked_device
from ..ops import cam as cam_ops
from ..ops import image as image_ops
from ..ops import klt as klt_ops

F32 = torch.float32
F64 = torch.float64


class KltTracker:
    def __init__(self, n_pts=150, levels=3, grid_x=12, grid_y=10, min_px_dist=10,
                 half_window=7, iters=10, cam_k=None, distortion_model=0, histogram=True,
                 seed=0, device=CUDA):
        self.device = checked_device(device)
        dev = self.device
        self.n_pts = n_pts
        self.levels = levels
        self.grid_x = grid_x
        self.grid_y = grid_y
        self.min_px_dist = min_px_dist
        self.half = half_window
        self.iters = iters
        self.cam_k = (None if cam_k is None
                      else torch.as_tensor(np.asarray(cam_k, dtype=np.float64), device=dev))
        self.model = distortion_model
        self.histogram = histogram
        self.prev_pyr = None
        # host mirrors of the slots, as the last frame's read left them
        self.uv = np.zeros((n_pts, 2), dtype=np.float64)
        self.valid = np.zeros(n_pts, dtype=bool)
        self.ids = np.full(n_pts, -1, dtype=np.int64)
        # the slots on the device (B = 1) and the next new id
        self._uv = torch.zeros((1, n_pts, 2), dtype=F64, device=dev)
        self._valid = torch.zeros((1, n_pts), dtype=torch.bool, device=dev)
        self._ids = torch.full((1, n_pts), -1, dtype=torch.int64, device=dev)
        self._next_id = torch.zeros((1, 1), dtype=torch.int64, device=dev)
        # the RANSAC draws' key and the count of frames that ran RANSAC
        self.key = torch.tensor([seed], dtype=torch.int64, device=dev)
        self.counter = torch.zeros(1, dtype=torch.int64, device=dev)
        self.last_ms = 0.0  # host ms of the last feed, its read included

    def _pyramid(self, img):
        img = torch.as_tensor(np.asarray(img, dtype=np.float32)).to(self.device,
                                                                 non_blocking=True)[None]
        if self.histogram:
            img = image_ops.hist_equalize(img)
        return image_ops.build_pyramid(img, self.levels)

    def _track(self, img):
        """One frame's device work on the slots: LK from the previous
        pyramid, the RANSAC gate, the refill."""
        pyr = self._pyramid(img)
        uv, valid, ids = self._uv, self._valid, self._ids
        if self.prev_pyr is not None and self.valid.any():
            uv_next, ok = klt_ops.pyramidal_lk(self.prev_pyr, pyr, uv.to(F32), valid,
                                               self.levels, self.half, self.iters)
            uv_next = uv_next.to(F64)
            ok = ok & valid
            if self.cam_k is not None:
                # RANSAC fundamental gate on undistorted normalized coordinates,
                # kept only with >= 12 tracked features (and only then does the
                # draws' counter move, as JAX splits its key)
                k = self.cam_k[None, None]
                zn1 = cam_ops.undistort(uv, k, self.model)
                zn2 = cam_ops.undistort(uv_next, k, self.model)
                inl = klt_ops.ransac_fundamental(zn1, zn2, ok, self.key, self.counter)
                run = ok.sum(-1) >= 12
                ok = torch.where(run[:, None], ok & inl, ok)
                self.counter = self.counter + run.to(torch.int64)
            uv, valid = uv_next, ok
            ids = torch.where(ok, ids, -1)
        # refill: the detections in order, up to the first one that failed,
        # into the free slots in order
        det_uv, det_ok = klt_ops.detect_grid(pyr[0], uv.to(F32), valid, self.grid_x,
                                             self.grid_y, self.n_pts,
                                             min_px_dist=float(self.min_px_dist))
        n_det = torch.cumprod(det_ok.to(torch.int64), dim=-1).sum(-1, keepdim=True)
        free = ~valid
        rank = torch.cumsum(free.to(torch.int64), dim=-1) - 1
        fill = free & (rank < n_det)
        pick = rank.clamp(0, det_uv.shape[1] - 1)
        new_uv = torch.gather(det_uv.to(F64), 1, pick[..., None].expand(-1, -1, 2))
        self._uv = torch.where(fill[..., None], new_uv, uv)
        self._valid = valid | fill
        self._ids = torch.where(fill, self._next_id + rank, ids)
        self._next_id = self._next_id + fill.sum(-1, keepdim=True)
        self.prev_pyr = pyr

    def _read(self, extra=()):
        """The frame's one device read: the slots' pixels, validity and ids
        (and `extra` (1,N,k) float columns), into the host mirrors.  Returns
        the extra columns (N,k)."""
        cols = [self._uv, self._valid[..., None], self._ids[..., None]] + list(extra)
        host = torch.cat([c.to(F64) for c in cols], dim=-1)[0].cpu().numpy()
        self.uv = host[:, 0:2].copy()
        self.valid = host[:, 2] > 0.5
        self.ids = host[:, 3].astype(np.int64)
        return host[:, 4:]

    def feed(self, img):
        """Process one grayscale frame (H, W) in [0, 1].  Returns (ids (K,),
        uvs (K,2)) of the features tracked now."""
        t0 = time.perf_counter()
        self._track(img)
        self._read()
        sel = self.valid
        out = self.ids[sel].copy(), self.uv[sel].copy()
        self.last_ms = 1e3 * (time.perf_counter() - t0)
        return out


class StereoKltTracker(KltTracker):
    """Stereo front-end: temporal KLT on the left stream and a left->right LK
    association each frame under shared ids (reference: TrackKLT::
    feed_stereo, TrackKLT.cpp:202-393, which also tracks the right stream
    over time; anchoring on the left and re-matching L->R each frame is the
    simpler variant with the same output: one id observed in both cameras at
    one time).  The L->R pass starts from the left positions."""

    def __init__(self, *a, max_y_diff=6.0, max_disparity=120.0, **kw):
        super().__init__(*a, **kw)
        self.max_y_diff = max_y_diff
        self.max_disparity = max_disparity

    def feed_stereo(self, img0, img1):
        """Returns (ids0, uv0, ids1, uv1): the left observations and the
        right ones (shared ids, ids1 a subset of ids0)."""
        t0 = time.perf_counter()
        self._track(img0)  # temporal left (sets prev_pyr to the left pyramid)
        pyr1 = self._pyramid(img1)
        uv, valid = self._uv, self._valid
        uv_r, ok = klt_ops.pyramidal_lk(self.prev_pyr, pyr1, uv.to(F32), valid, self.levels,
                                        self.half, self.iters)
        uv_r = uv_r.to(F64)
        # epipolar-band and disparity gate (a rectified-ish pair: the point
        # shifts left in the right camera)
        dy = torch.abs(uv_r[..., 1] - uv[..., 1])
        dx = uv[..., 0] - uv_r[..., 0]
        ok = ok & valid & (dy < self.max_y_diff) & (dx > -2.0) & (dx < self.max_disparity)
        right = self._read([uv_r, (ok & (self._ids >= 0))[..., None]])
        sel, sel_r = self.valid, right[:, 2] > 0.5
        out = (self.ids[sel].copy(), self.uv[sel].copy(), self.ids[sel_r].copy(),
               right[sel_r, 0:2].copy())
        self.last_ms = 1e3 * (time.perf_counter() - t0)
        return out
