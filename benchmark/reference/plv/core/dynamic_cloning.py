"""Dynamic clone-rate selection and the interpolation-error noise model
(a numpy copy of plviwo_tpu/core/dynamic_cloning.py, which the port may not
import).

The host rate policy of the live driver's dynamic cloning (the reference's
SystemManager::compute_accelerations / dynamic_cloning): from the IMU's
recent angular and linear acceleration, the lowest clone rate whose
interpolation error stays under a target, and that error as a noise
standard deviation,

    slope(hz, order) ~ C_order * (1 / hz)^order,

or a measured slope table installed with `set_slope_table` (the
reference's calibrate-then-load workflow of its YAML slope tables).
"""

from __future__ import annotations

import numpy as np

AVAILABLE_HZ = (4, 5, 7, 10, 15, 20, 30)
C_ORDER = {1: 0.5, 3: 0.15, 5: 0.05}

_custom_table: dict | None = None


def set_slope_table(table: dict | None):
    """table[(hz, order)] = slope (empirically calibrated), consulted before
    the parametric model; None removes it.  Process-wide, as in JAX."""
    global _custom_table
    _custom_table = table


def slope(hz: float, order: int) -> float:
    if _custom_table is not None and (hz, order) in _custom_table:
        return _custom_table[(hz, order)]
    c = C_ORDER.get(order, 0.15)
    return c * (1.0 / hz) ** order


def interp_noise_std(accel: float, hz: float, order: int, mlt: float = 1.0) -> float:
    """1-sigma interpolation error (meters / radians scale mixed; used to
    inflate pixel noise via the focal length by callers)."""
    return mlt * accel * slope(hz, order)


def estimate_accelerations(imu_t, imu_w, imu_a, window: float = 0.5,
                           gravity_mag: float = 9.81):
    """(ang_acc [rad/s^2], lin_acc [m/s^2]) over the trailing window.

    Reference computes these from CPI omega/v differences at clones
    (compute_accelerations); here directly from the IMU stream: angular
    acceleration = d|omega|/dt, linear = | |a| - g |.
    """
    if len(imu_t) < 4:
        return 0.0, 0.0
    t_hi = imu_t[-1]
    sel = imu_t >= t_hi - window
    w = np.asarray(imu_w)[sel]
    a = np.asarray(imu_a)[sel]
    t = np.asarray(imu_t)[sel]
    if len(t) < 12:
        return 0.0, 0.0
    # smooth before differencing: raw sample-to-sample gyro differences are
    # dominated by white noise amplified by 1/dt
    k = max(len(t) // 10, 3)
    kernel = np.ones(k) / k
    w_s = np.stack([np.convolve(w[:, i], kernel, mode="valid") for i in range(3)], 1)
    t_s = np.convolve(t, kernel, mode="valid")
    dw = np.diff(w_s, axis=0)
    dt = np.maximum(np.diff(t_s), 1e-6)[:, None]
    ang_acc = float(np.percentile(np.linalg.norm(dw / dt, axis=1), 90))
    a_s = np.stack([np.convolve(a[:, i], kernel, mode="valid") for i in range(3)], 1)
    lin_acc = float(np.percentile(np.abs(np.linalg.norm(a_s, axis=1) - gravity_mag), 90))
    return ang_acc, lin_acc


def select_rate_and_order(ang_acc: float, lin_acc: float, max_order: int = 3,
                          target_std: float = 0.02, mlt: float = 1.0,
                          max_hz: float = 30.0):
    """Cheapest (hz, order) pair keeping interpolation-error std below target.

    The reference picks both the clone rate AND the interpolation order from
    the slope tables (SystemManager::dynamic_cloning, SystemManager.cpp:
    293-312): a higher order lets a lower clone rate qualify.  Scans rates
    ascending and prefers the lowest order that qualifies at that rate.
    """
    accel = ang_acc + lin_acc
    orders = (1, max_order) if max_order > 1 else (1,)
    for hz in AVAILABLE_HZ:
        if hz > max_hz:
            break
        for order in orders:
            if interp_noise_std(accel, hz, order, mlt) <= target_std:
                return float(hz), order
    return float(min(max_hz, AVAILABLE_HZ[-1])), (max_order if max_order > 1 else 1)


def select_clone_rate(ang_acc: float, lin_acc: float, order: int,
                      target_std: float = 0.02, mlt: float = 1.0,
                      max_hz: float = 30.0):
    """Smallest clone rate keeping the interpolation-error std below target
    (reference: dynamic_cloning picks Hz in [4, 30] from the slope tables)."""
    accel = ang_acc + lin_acc
    for hz in AVAILABLE_HZ:
        if hz > max_hz:
            break
        if interp_noise_std(accel, hz, order, mlt) <= target_std:
            return float(hz)
    return float(min(max_hz, AVAILABLE_HZ[-1]))
