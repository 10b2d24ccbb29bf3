"""Host-side feature track databases (a copy of plviwo_tpu/update/feature_db.py,
which the port may not import).

Plain-Python track stores keyed by id (the reference's
`ov_core::FeatureDatabase`, feat/FeatureDatabase.h:68-162, and
`LineFeatureDatabase`, linefeat/LineFeatureDatabase.h:18-104): the
per-track driver (`core/system.VioSystem.feed_camera`) appends every
frame's tracked points and lines, and each MSCKF, SLAM or line update reads
whole tracks back into padded arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Track:
    fid: int
    times: list
    uvs: list  # raw pixel coords
    uvns: list  # undistorted normalized coords
    cams: list = dataclasses.field(default_factory=list)  # camera id per obs
    # flags mirroring PL-VIWO's Feature additions (feat/Feature.h)
    p_FinG: np.ndarray | None = None
    triangulated: bool = False
    dynamic: bool = False
    to_delete: bool = False

    def cam_of(self, i: int) -> int:
        """Camera id of observation i (tracks predating stereo default 0)."""
        return self.cams[i] if i < len(self.cams) else 0


@dataclasses.dataclass
class LineTrack:
    """Line track record (reference: linefeat/LineFeature.h:22-78)."""
    lid: int
    times: list
    segs: list       # raw pixel endpoints (4,) per obs
    segs_n: list     # undistorted normalized endpoints (4,)
    point_ids: list  # attached point ids, one list per obs
    classes: list = None  # per-obs vanishing-point class (0 none, 1 x, 2 y, 3 z)
    D: int = 0       # the last nonzero class fed (the fallback of majority_class)
    to_delete: bool = False

    def majority_class(self) -> int:
        """The track's class by majority over its per-observation classes
        (each frame classified from the orientation then current, as the
        reference does, UpdaterCamera.cpp:100-104): the winning axis needs
        >= 2 votes and at least half of the observations; with no vote at
        all, the fed class D; otherwise 0 (unclassified)."""
        votes = [c for c in (self.classes or []) if c in (1, 2, 3)]
        if not votes and self.D:
            return self.D
        if len(votes) < 2:
            return 0
        counts = [votes.count(k) for k in (1, 2, 3)]
        best = int(np.argmax(counts))
        if counts[best] * 2 >= len(self.classes or votes):
            return best + 1
        return 0


class LineDatabase:
    """id -> LineTrack store (reference: LineFeatureDatabase.h:18-104)."""

    def __init__(self):
        self.tracks: dict[int, LineTrack] = {}

    def update(self, lid: int, t: float, seg, seg_n, point_ids=(), D: int = 0):
        tr = self.tracks.get(lid)
        if tr is None:
            tr = LineTrack(lid=lid, times=[], segs=[], segs_n=[], point_ids=[], classes=[])
            self.tracks[lid] = tr
        if tr.classes is None:
            tr.classes = []
        tr.times.append(t)
        tr.segs.append(np.asarray(seg, dtype=np.float64))
        tr.segs_n.append(np.asarray(seg_n, dtype=np.float64))
        tr.point_ids.append(list(point_ids))
        tr.classes.append(int(D))
        if D:
            tr.D = D

    def cleanup(self, t_min: float):
        """Drop observations older than t_min; drop empty or flagged tracks."""
        dead = []
        for lid, tr in self.tracks.items():
            keep = [i for i, ti in enumerate(tr.times) if ti >= t_min]
            if not keep or tr.to_delete:
                dead.append(lid)
                continue
            if len(keep) != len(tr.times):
                tr.times = [tr.times[i] for i in keep]
                tr.segs = [tr.segs[i] for i in keep]
                tr.segs_n = [tr.segs_n[i] for i in keep]
                tr.point_ids = [tr.point_ids[i] for i in keep if i < len(tr.point_ids)]
                if tr.classes:
                    tr.classes = [tr.classes[i] for i in keep if i < len(tr.classes)]
        for lid in dead:
            del self.tracks[lid]

    def remove(self, lids):
        for lid in lids:
            self.tracks.pop(lid, None)

    def __len__(self):
        return len(self.tracks)


class FeatureDatabase:
    def __init__(self):
        self.tracks: dict[int, Track] = {}

    def update(self, fid: int, t: float, uv, uvn, cam: int = 0):
        tr = self.tracks.get(fid)
        if tr is None:
            tr = Track(fid=fid, times=[], uvs=[], uvns=[])
            self.tracks[fid] = tr
        tr.times.append(t)
        tr.uvs.append(np.asarray(uv, dtype=np.float64))
        tr.uvns.append(np.asarray(uvn, dtype=np.float64))
        tr.cams.append(int(cam))

    def ids_at(self, t: float):
        return [fid for fid, tr in self.tracks.items() if tr.times and tr.times[-1] == t]

    def lost_before(self, t: float):
        """Tracks whose newest observation is older than t (update candidates)."""
        return [tr for tr in self.tracks.items() if tr[1].times[-1] < t]

    def cleanup(self, t_min: float):
        """Drop measurements older than t_min; drop empty/flagged tracks
        (reference: FeatureDatabase::cleanup + cleanup_measurements)."""
        dead = []
        for fid, tr in self.tracks.items():
            keep = [i for i, ti in enumerate(tr.times) if ti >= t_min]
            if not keep or tr.to_delete:
                dead.append(fid)
                continue
            if len(keep) != len(tr.times):
                tr.times = [tr.times[i] for i in keep]
                tr.uvs = [tr.uvs[i] for i in keep]
                tr.uvns = [tr.uvns[i] for i in keep]
                if tr.cams:
                    tr.cams = [tr.cam_of(i) for i in keep]
        for fid in dead:
            del self.tracks[fid]

    def remove(self, fids):
        for fid in fids:
            self.tracks.pop(fid, None)

    def __len__(self):
        return len(self.tracks)
