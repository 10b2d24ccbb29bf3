"""Host-side feature track database (a copy of plviwo_tpu/update/feature_db.py:
`Track` and `FeatureDatabase`, which the port may not import).

Plain-Python track stores keyed by id (the reference's
`ov_core::FeatureDatabase`, feat/FeatureDatabase.h:68-162): the per-track
driver (`core/system.VioSystem.feed_camera`) appends every frame's tracked
observations, and each MSCKF update reads whole tracks back into padded
arrays.  The line store (`LineDatabase`) serves the per-track line rows and
is not copied yet (ROADMAP A9b).
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
