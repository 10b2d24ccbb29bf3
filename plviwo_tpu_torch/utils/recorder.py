"""State, trajectory and timing recording (port of
plviwo_tpu/utils/recorder.py; reference: viw::State_Logger,
State_Logger.h:53-240: MINS-format est/std/gt triplets read by the NEES
tooling, a TUM trajectory file and a timing file, plus check_files).

`record` reads the state once a call: time, q, p, v, bg, ba and the 15
standard deviations of the IMU block, gathered on the device into one
vector and moved in one transfer.  The files are the JAX recorder's."""

from __future__ import annotations

import os

import numpy as np
import torch

from ..eval.loader import save_timing, save_tum


class StateRecorder:
    """Accumulates per-clone state snapshots and writes MINS-style outputs."""

    def __init__(self, out_dir: str):
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)
        self.rows_est = []  # t, q(4), p(3), v(3), bg(3), ba(3)
        self.rows_std = []
        self.rows_gt = []
        self.traj = []      # t, p(3), q(4)
        self.timing = []    # t, per-stage ms...
        self.timing_names = None
        self.host_reads = 0  # device -> host transfers

    def record(self, system, gt=None):
        """Snapshot the current filter state (call after each clone)."""
        st = system.state
        std = torch.sqrt(torch.clamp(torch.diagonal(st.cov[0])[:15], min=0.0))
        host = torch.cat([st.time[:1], st.q[0], st.p[0], st.v[0], st.bg[0], st.ba[0],
                          std]).cpu().numpy()
        self.host_reads += 1
        t, q, p = float(host[0]), host[1:5], host[5:8]
        self.rows_est.append(host[:17].copy())
        self.rows_std.append(np.concatenate([[t], host[17:]]))
        self.traj.append(np.concatenate([[t], p, q]))
        if gt is not None:
            self.rows_gt.append(
                np.concatenate([[t], gt["q"], gt["p"], gt["v"], gt["bg"], gt["ba"]]))

    def record_timing(self, t, values: dict):
        if self.timing_names is None:
            self.timing_names = ["t"] + list(values.keys())
        self.timing.append([t] + [values.get(k, 0.0) for k in self.timing_names[1:]])

    def save(self):
        def dump(name, rows):
            if not rows:
                return
            np.savetxt(os.path.join(self.out_dir, name), np.asarray(rows), fmt="%.9f")

        dump("state_est.txt", self.rows_est)
        dump("state_std.txt", self.rows_std)
        dump("state_gt.txt", self.rows_gt)
        if self.traj:
            arr = np.asarray(self.traj)
            save_tum(os.path.join(self.out_dir, "trajectory.txt"),
                     arr[:, 0], arr[:, 1:4], arr[:, 4:8])
        if self.timing:
            save_timing(os.path.join(self.out_dir, "timing.txt"), self.timing_names,
                        self.timing)

    def check_files(self) -> bool:
        """Post-run sanity: outputs exist and are non-empty
        (reference: State_Logger::check_files, State_Logger.h:215-238)."""
        ok = True
        for name in ("trajectory.txt",):
            p = os.path.join(self.out_dir, name)
            ok &= os.path.exists(p) and os.path.getsize(p) > 0
        return ok
