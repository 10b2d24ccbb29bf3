"""Static IMU initializer (a numpy copy of plviwo_tpu/init/static_imu.py, which
the port may not import; both compute the same on the host).

Rebuild of the OpenVINS-style `I_Initializer`
(`PL-VIWO/src/init/I_Initializer.cpp:43-155`): split the IMU buffer into two
windows; require an excitation jump in the *newer* window (accel variance
above `imu_thresh`) and a quiet *older* window, then initialize orientation
from the mean gravity direction (Gram-Schmidt), bg/ba from window means,
zero velocity.

When `require_excitation` is False (e.g. wheeled robots that may simply sit
still, or simulation), a single quiet window suffices.
"""

from __future__ import annotations

import numpy as np


def try_static_init(
    imu_t: np.ndarray,
    imu_w: np.ndarray,
    imu_a: np.ndarray,
    window_time: float,
    imu_thresh: float,
    gravity_mag: float = 9.81,
    require_excitation: bool = True,
):
    """Attempt static initialization from the IMU buffer.

    Returns None, or a dict {t, q_GtoI, bg, ba, v} (p = 0 defines the origin).
    """
    if len(imu_t) < 10:
        return None
    t_new = imu_t[-1]
    w1 = (imu_t >= t_new - 2 * window_time) & (imu_t < t_new - window_time)
    w2 = imu_t >= t_new - window_time
    if w2.sum() < 5 or (require_excitation and w1.sum() < 5):
        return None
    if imu_t[w2][0] > t_new - 0.9 * window_time:
        return None  # window not fully covered yet

    a2 = imu_a[w2]
    var2 = np.sqrt(np.mean(np.sum((a2 - a2.mean(0)) ** 2, axis=1)))
    if var2 > imu_thresh:
        return None  # not at rest
    if require_excitation:
        a1 = imu_a[w1]
        var1 = np.sqrt(np.mean(np.sum((a1 - a1.mean(0)) ** 2, axis=1)))
        if var1 < imu_thresh:
            return None  # no motion jump observed yet

    # use the quiet window (w2 if no excitation required, else w1 is the quiet
    # one in the reference; we initialize from the window closest to `t_new`
    # that is quiet — w2 here)
    quiet_w = imu_w[w2]
    quiet_a = imu_a[w2]
    z_I = quiet_a.mean(0)
    z_I = z_I / np.linalg.norm(z_I)  # gravity direction in IMU frame
    # Gram-Schmidt an orthonormal basis {x_I, y_I, z_I} in IMU coords; the
    # world frame is gravity-aligned (z up) with yaw chosen so world-x projects
    # onto IMU-x.  R_GtoI maps world axes into IMU coords, so its *columns*
    # are the images of e_x, e_y, e_z — in particular R_GtoI e_z = z_I.
    e1 = np.array([1.0, 0.0, 0.0])
    x_I = e1 - z_I * (z_I @ e1)
    x_I /= np.linalg.norm(x_I)
    y_I = np.cross(z_I, x_I)
    R_GtoI = np.column_stack([x_I, y_I, z_I])
    bg = quiet_w.mean(0)
    g_G = np.array([0.0, 0.0, gravity_mag])
    ba = quiet_a.mean(0) - R_GtoI @ g_G
    return {
        "t": float(imu_t[-1]),
        "R_GtoI": R_GtoI,
        "bg": bg,
        "ba": ba,
        "v": np.zeros(3),
    }
