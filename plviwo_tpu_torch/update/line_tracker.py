"""Host line tracker (port of plviwo_tpu/update/line_tracker.py): the
reference's `TrackLSD` (TrackLSD::feed_monocular, TrackLSD.cpp:70-192).

Per frame:
1. detect candidate segments on the device (`ops/line_detect.
   detect_segments`, the anchor walk) and merge collinear ones on the host
   (`merge_segments`, keep-longest);
2. attach the frame's point tracks to the segments on the device
   (`update/lines.assign_points_to_lines`);
3. drop the segments with no attached point (the paper's point-assisted
   pruning);
4. match against the previous frame's segments by shared point ids: >= 2
   shared, or 1 shared and midpoints within MIDPOINT_GATE px
   (LineMatch / LineSimilar, TrackLSD.cpp:368-433, 816-830); the rest get
   new ids.

A frame reads the device twice: the detector's output, then the
attachment matrix (none without points or segments).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..core.state import CUDA, checked_device
from ..ops import line_detect
from .lines import assign_points_to_lines


# a point attaches to a segment within ATTACH_DIST px of it; a line sharing a
# single point id with a previous one matches it only with their midpoints
# within MIDPOINT_GATE px
ATTACH_DIST, MIDPOINT_GATE = 5.0, 10.0


class LineTracker:
    def __init__(self, max_lines=40, min_length=25.0, device=CUDA):
        self.device = checked_device(device)
        self.max_lines = max_lines
        self.min_length = min_length
        self.prev: list[dict] = []  # the last frame's lines: {lid, seg, pids}
        self._next_id = 0
        self.host_reads = 0  # device -> host reads
        self.last_ms = 0.0  # host ms of the last feed, its reads included

    def _upload(self, x):
        """A host array on the tracker's device, a copy that does not wait
        for the device's queued work."""
        return torch.from_numpy(np.array(x)).to(self.device, non_blocking=True)

    def _segments(self, img):
        """The frame's merged segments (K, 4), at most max_lines."""
        img = self._upload(np.asarray(img, dtype=np.float32))
        segs, length, valid = line_detect.detect_segments(img)
        host = torch.cat([segs, length[:, None], valid[:, None].to(segs.dtype)], -1).cpu().numpy()
        self.host_reads += 1
        # keep-longest: the reference ships with MergeLines' extension bypassed,
        # and extended endpoints localize worse
        segs = line_detect.merge_segments(host[:, :4], host[:, 4], host[:, 5] > 0.5,
                                          min_length=self.min_length, extend=False)
        return segs[:self.max_lines]

    def _attach(self, segs, pt_ids, pt_uvs):
        """Per segment, the set of point ids attached to it."""
        if len(pt_ids) == 0:
            return [set() for _ in range(len(segs))]
        A = assign_points_to_lines(
            self._upload(segs)[None],
            self._upload(np.atleast_2d(np.asarray(pt_uvs, dtype=np.float64)))[None],
            torch.ones((1, len(pt_ids)), dtype=torch.bool, device=self.device),
            dist_thresh=ATTACH_DIST)[0].cpu().numpy()
        self.host_reads += 1
        ids = np.asarray(pt_ids)
        return [set(ids[row].tolist()) for row in A]

    def _match(self, seg, pid, used_prev):
        """The previous line that shares the most points with this one (a
        single shared point counts only with the midpoints within
        MIDPOINT_GATE), or None."""
        best, best_shared = None, 0
        for j, pr in enumerate(self.prev):
            if j in used_prev:
                continue
            shared = len(pid & pr["pids"])
            if shared == 0:
                continue
            if shared == 1:
                m_new = 0.5 * (seg[0:2] + seg[2:4])
                m_old = 0.5 * (pr["seg"][0:2] + pr["seg"][2:4])
                if np.linalg.norm(m_new - m_old) > MIDPOINT_GATE:
                    continue
            if shared > best_shared:
                best, best_shared = j, shared
        return best

    def feed(self, img, pt_ids, pt_uvs):
        """Process one grayscale frame (H, W) in [0, 1] with the frame's point
        tracks: ids (N,) and pixels (N, 2).  Returns (line_ids (K,), segs
        (K, 4), pids: per line the sorted ids (int64) of its attached
        points, for the point-line-coupled rows)."""
        t0 = time.perf_counter()
        segs = self._segments(img)
        if len(segs) == 0:
            self.prev = []
            self.last_ms = 1e3 * (time.perf_counter() - t0)
            return np.zeros(0, dtype=np.int64), np.zeros((0, 4)), []
        pids = self._attach(segs, pt_ids, pt_uvs)
        keep = [i for i in range(len(segs)) if pids[i]]
        out, used_prev = [], set()
        for i in keep:
            j = self._match(segs[i], pids[i], used_prev)
            if j is None:
                lid = self._next_id
                self._next_id += 1
            else:
                lid = self.prev[j]["lid"]
                used_prev.add(j)
            out.append({"lid": lid, "seg": segs[i], "pids": pids[i]})
        self.prev = out
        self.last_ms = 1e3 * (time.perf_counter() - t0)
        return (np.asarray([o["lid"] for o in out], dtype=np.int64),
                np.asarray([o["seg"] for o in out]),
                [np.asarray(sorted(o["pids"]), dtype=np.int64) for o in out])
