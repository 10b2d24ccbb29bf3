"""Zero-velocity updater (port of plviwo_tpu/update/zupt.py).

The reference constructs a ZuptUpdater whose source its snapshot lacks
(SURVEY.md defect #1); this is the intended, MINS-style behavior:

- stationarity from short-window IMU statistics (the gyro magnitude less
  the gyro bias, and the accelerometer's spread, below thresholds), on the
  host;
- when stationary, the pseudo-measurements v = 0 and w_meas - bg = 0 (6
  rows) update the filter, clamping the velocity drift at stops.

The stationarity test runs on every IMU sample, so it reads no device
state: the driver passes its host mirror of bg (`VioSystem._bg`).  H is
built on the device once; an update reads the device once, for the chi^2
and the updated bg together.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import ekf

F64 = torch.float64


class ZuptUpdater:
    def __init__(self, layout, chi2_table, sigma_v=0.05, sigma_w=0.01, gyro_thresh=0.02,
                 accel_var_thresh=0.05, window=0.3, chi2_mult=5.0, device="cpu"):
        self.layout = layout
        self.chi2_table = chi2_table
        self.sigma_v = sigma_v
        self.sigma_w = sigma_w
        self.gyro_thresh = gyro_thresh
        self.accel_var_thresh = accel_var_thresh
        self.window = window
        self.chi2_mult = chi2_mult
        self.stats = {"applied": 0, "rejected": 0}
        self.last_zupt_t = -np.inf
        # rows: v = 0 (3), w_meas - bg = 0 (3)
        i3 = torch.arange(3, device=device)
        self.H = torch.zeros((1, 6, layout.dim), dtype=F64, device=device)
        self.H[0, i3, layout.IMU_V + i3] = 1.0
        self.H[0, 3 + i3, layout.IMU_BG + i3] = 1.0
        self.r_diag = torch.tensor([[sigma_v**2] * 3 + [sigma_w**2] * 3], dtype=F64,
                                   device=device)
        self.mask = torch.ones((1, 6), dtype=torch.bool, device=device)

    def is_stationary(self, imu_t, imu_w, imu_a, bg) -> bool:
        """Short-window stationarity test (gyro magnitude + accel spread) on
        host arrays; bg the host copy of the gyro bias."""
        if len(imu_t) < 5:
            return False
        t_hi = imu_t[-1]
        sel = imu_t >= t_hi - self.window
        if sel.sum() < 5:
            return False
        w = np.asarray(imu_w)[sel] - np.asarray(bg)
        a = np.asarray(imu_a)[sel]
        gyro_ok = np.linalg.norm(w, axis=1).max() < self.gyro_thresh
        accel_ok = np.sqrt(
            np.mean(np.sum((a - a.mean(0)) ** 2, axis=1))) < self.accel_var_thresh
        return bool(gyro_ok and accel_ok)

    def try_update(self, system, imu_w_latest) -> bool:
        """Apply the zero-velocity (+ gyro-bias) pseudo-measurement, at most
        every 0.2 s, if it passes its chi^2 gate.  One device read: the
        chi^2 and the bg the update would give, which refreshes the
        driver's bg mirror when the update is kept."""
        t = system._time
        if t - self.last_zupt_t < 0.2:
            return False
        st = system.state
        w = torch.as_tensor(np.asarray(imu_w_latest, dtype=np.float64)).to(
            st.bg.device, non_blocking=True)
        r = torch.cat([-st.v, w[None] - st.bg], dim=-1)  # 0 - v, w_meas - bg ~ 0
        chi = ekf.chi2(st.cov, self.H, r, self.r_diag, self.mask)
        new = ekf.update(st, self.H, r, self.r_diag, self.mask)
        host = system._host(torch.cat([chi, new.bg[0]]))
        if host[0] > float(self.chi2_table[6]) * self.chi2_mult:
            self.stats["rejected"] += 1
            return False
        system.state = new
        system._bg = host[1:]
        self.stats["applied"] += 1
        self.last_zupt_t = t
        return True
