"""Fiducial tag tracker (port of plviwo_tpu/update/aruco_tracker.py): the
`TrackAruco` equivalent.

TrackAruco::perform_tracking (TrackAruco.cpp:59-150): detect the markers,
keep the tags with id < max_tag_id, and emit each tag's 4 corners as point
features with the stable id `id_base + tag_id + n * max_tag_id` (the
reference uses tag_id + n * max_tag_id; id_base, 10,000,000 by default,
lifts the block above the KLT ids so both trackers share one feature
database).  Detection is the template-bank NCC detector of `ops/aruco.py`
on the tracker's device; a frame reads the device once (the detections'
validity, ids and corners).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..core.state import CUDA
from ..ops.aruco import TagDetector


class ArucoTracker:
    def __init__(self, max_tag_id: int = 16, id_base: int = 10_000_000,
                 detector: TagDetector | None = None, device=CUDA, **det_kwargs):
        self.det = detector or TagDetector(device=device, **det_kwargs)
        self.max_tag_id = max_tag_id
        self.id_base = id_base
        self.last = {}  # tag_id -> (4,2) corners of the newest frame
        self.host_reads = 0  # device -> host reads
        self.last_ms = 0.0  # host ms of the last feed, its read included

    def feed(self, img):
        """One frame (H, W) -> (ids (4K,), uvs (4K,2)) corner features."""
        t0 = time.perf_counter()
        out = self.det.detect(img)
        D = out["valid"].shape[0]
        host = torch.cat([out["valid"][:, None].double(), out["tag_id"][:, None].double(),
                          out["corners"].reshape(D, 8).double()], dim=1).cpu().numpy()
        self.host_reads += 1
        ids, uvs = [], []
        self.last = {}
        H, W = np.shape(img)
        for i in np.nonzero(host[:, 0] > 0.5)[0]:
            tag = int(host[i, 1])
            if tag >= self.max_tag_id:
                continue
            corners = host[i, 2:].reshape(4, 2)
            if not np.all((corners[:, 0] > 1) & (corners[:, 0] < W - 2)
                          & (corners[:, 1] > 1) & (corners[:, 1] < H - 2)):
                continue
            self.last[tag] = corners
            for n in range(4):
                ids.append(self.id_base + tag + n * self.max_tag_id)
                uvs.append(corners[n])
        self.last_ms = 1e3 * (time.perf_counter() - t0)
        if not ids:
            return np.zeros(0, dtype=np.int64), np.zeros((0, 2))
        return np.asarray(ids, dtype=np.int64), np.asarray(uvs)
