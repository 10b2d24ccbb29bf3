"""Descriptor-based point tracker (port of plviwo_tpu/update/desc_tracker.py).

`ov_core::TrackDescriptor` (track/TrackDescriptor.cpp): per frame detect
corners, describe them (BRIEF, `ops/descriptor.py`), match them against
the previous frame's descriptors by the mutual-best ratio test, gate the
matches with a fundamental-matrix RANSAC and refill the free slots.  The
same (ids, uvs) contract as `KltTracker`, so it feeds `feed_camera` the
same way.  The reference ships it as the alternative to KLT; its PL-VIWO
config does not use it.

The device work of a frame (equalize, detect, describe, match, RANSAC)
runs on the tracker's device, B = 1, and ONE read brings back the
detections, the matches and the RANSAC verdicts; the slot bookkeeping (the
matched slots, then the unmatched detections into the free slots in order
under the minimum-distance rule against everything already placed) is
JAX's host loop, and the slots go back to the device with the frame's
descriptors (an upload, not a read).  The RANSAC draws are the port's
(key, counter) hash (`klt.draw_hypotheses`), the counter counting the
frames that ran RANSAC as JAX splits its key once for each.  The matched
pairs enter RANSAC in their slots, unmatched slots masked out: the order in
which RANSAC takes valid entries is JAX's compacted order, so the
hypotheses are JAX's.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..core.state import CUDA, checked_device
from ..ops import cam as cam_ops
from ..ops import descriptor as desc_ops
from ..ops import image as image_ops
from ..ops import klt as klt_ops

F32 = torch.float32
F64 = torch.float64


class DescTracker:
    def __init__(self, n_pts=150, grid_x=12, grid_y=10, min_px_dist=10, n_bits=256,
                 max_dist=80.0, ratio=0.8, cam_k=None, distortion_model=0, histogram=True,
                 seed=0, device=CUDA):
        self.device = checked_device(device)
        dev = self.device
        self.n_pts = n_pts
        self.grid_x = grid_x
        self.grid_y = grid_y
        self.min_px_dist = min_px_dist
        self.pattern = torch.as_tensor(desc_ops.brief_pattern(n_bits=n_bits), device=dev)
        self.max_dist = max_dist
        self.ratio = ratio
        self.cam_k = (None if cam_k is None
                      else torch.as_tensor(np.asarray(cam_k, dtype=np.float64), device=dev))
        self.model = distortion_model
        self.histogram = histogram
        # host slots (JAX's) and their device copies (B = 1)
        self.uv = np.zeros((n_pts, 2), dtype=np.float64)
        self.valid = np.zeros(n_pts, dtype=bool)
        self.ids = np.full(n_pts, -1, dtype=np.int64)
        self._uv = torch.zeros((1, n_pts, 2), dtype=F64, device=dev)
        self._valid = torch.zeros((1, n_pts), dtype=torch.bool, device=dev)
        self.desc = None  # (1, n_pts, bits) bool descriptors of the previous frame's slots
        self._next_id = 0
        self.key = torch.tensor([seed], dtype=torch.int64, device=dev)
        self.counter = torch.zeros(1, dtype=torch.int64, device=dev)
        self.host_reads = 0  # device -> host reads
        self.last_ms = 0.0  # host ms of the last feed, its read included

    def _match(self, img, det_uv, det_ok, det_desc):
        """The previous slots' matches among the detections and their RANSAC
        verdict: (idx2 (1,N) or -1, keep (1,N) = matched and kept)."""
        idx2 = desc_ops.match(self.desc, self._valid, det_desc, det_ok, self.max_dist, self.ratio)
        matched = idx2 >= 0
        if self.cam_k is None:
            return idx2, matched
        uv_next = torch.gather(det_uv.to(F64), 1, idx2.clamp(min=0)[..., None].expand(-1, -1, 2))
        k = self.cam_k[None, None]
        zn1 = cam_ops.undistort(self._uv, k, self.model)
        zn2 = cam_ops.undistort(uv_next, k, self.model)
        inl = klt_ops.ransac_fundamental(zn1, zn2, matched, self.key, self.counter)
        run = matched.sum(-1) >= 12
        self.counter = self.counter + run.to(torch.int64)
        return idx2, torch.where(run[:, None], matched & inl, matched)

    def feed(self, img):
        """Process one grayscale frame (H, W) in [0, 1]; returns (ids (K,),
        uvs (K, 2))."""
        t0 = time.perf_counter()
        dev = self.device
        img = torch.as_tensor(np.asarray(img, dtype=np.float32)).to(dev, non_blocking=True)[None]
        if self.histogram:
            img = image_ops.hist_equalize(img)
        # this frame's corners (the full budget, no occupancy seed)
        none = torch.zeros((1, self.n_pts), dtype=torch.bool, device=dev)
        det_uv, det_ok = klt_ops.detect_grid(
            img, torch.zeros((1, self.n_pts, 2), dtype=F32, device=dev), none, self.grid_x,
            self.grid_y, self.n_pts, min_px_dist=float(self.min_px_dist))
        cols = [det_uv.to(F64), det_ok[..., None].to(F64)]
        tracking = self.desc is not None and self.valid.any()
        if tracking:
            det_desc = desc_ops.describe(img, det_uv, det_ok, self.pattern)
            idx2, keep = self._match(img, det_uv, det_ok, det_desc)
            cols += [idx2[..., None].to(F64), keep[..., None].to(F64)]
        # the frame's one read
        host = torch.cat(cols, dim=-1)[0].cpu().numpy()
        self.host_reads += 1
        det_uv_np, det_ok_np = host[:, 0:2], host[:, 2] > 0.5

        new_uv = np.zeros_like(self.uv)
        new_valid = np.zeros_like(self.valid)
        new_ids = np.full_like(self.ids, -1)
        taken = np.zeros(len(det_uv_np), dtype=bool)
        if tracking:
            idx2 = host[:, 3].astype(np.int64)
            keep = host[:, 4] > 0.5
            for slot in np.nonzero(idx2 >= 0)[0]:
                taken[idx2[slot]] = True
                if keep[slot]:
                    new_uv[slot] = det_uv_np[idx2[slot]]
                    new_valid[slot] = True
                    new_ids[slot] = self.ids[slot]

        # replenish the free slots with unmatched detections
        free_slots = np.nonzero(~new_valid)[0]
        j = 0
        for i in range(len(det_uv_np)):
            if not det_ok_np[i] or taken[i] or j >= len(free_slots):
                continue
            # minimum-distance suppression against the features placed so far
            if new_valid.any():
                dmin = np.min(np.linalg.norm(new_uv[new_valid] - det_uv_np[i], axis=1))
                if dmin < self.min_px_dist:
                    continue
            s = free_slots[j]
            new_uv[s] = det_uv_np[i]
            new_valid[s] = True
            new_ids[s] = self._next_id
            self._next_id += 1
            j += 1

        self.uv, self.valid, self.ids = new_uv, new_valid, new_ids
        self._uv = torch.as_tensor(new_uv[None]).to(dev, non_blocking=True)
        self._valid = torch.as_tensor(new_valid[None]).to(dev, non_blocking=True)
        # describe the slots where they are now, for the next frame's matching
        self.desc = desc_ops.describe(img, self._uv.to(F32), self._valid, self.pattern)
        sel = self.valid
        out = self.ids[sel].copy(), self.uv[sel].copy()
        self.last_ms = 1e3 * (time.perf_counter() - t0)
        return out
