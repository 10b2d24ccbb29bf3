"""IMU+wheel initializer (a numpy copy of plviwo_tpu/init/imu_wheel.py, which
the port may not import; both compute the same on the host).

Behavioral rebuild of `PL-VIWO/src/init/imu_wheel/IW_Initializer.*`
(SURVEY.md 2.5): align a common IMU/wheel window; when the wheels report
zero motion use the *static* path (bg from gyro-vs-wheel rates, v from wheel,
gravity by velocity-consistency averaging, ba closed form); otherwise the
*dynamic* path solves the norm-constrained gravity problem (Dong-Si).  A
candidate is accepted after 3 consecutive solutions agree within a threshold
(the smoothness vote, IW_Initializer.cpp:71-103).

The Dong-Si constrained solve (init_gI_dongsi, :280-433 + compute_dongsi_coeff
:690-800) is realized equivalently but more directly: eliminate ba from the
stacked linear system, eigendecompose the reduced 3x3 normal matrix, and root
the degree-6 secular polynomial sum_i (d_i / (lam_i - lam))^2 = |g|^2 with
`np.roots` — the same stationary points the reference finds via its
companion matrix.

Host-side numpy: initialization runs once per session on a ~1 s window.
"""

from __future__ import annotations

import numpy as np


def _skew(v):
    return np.array([
        [0, -v[2], v[1]],
        [v[2], 0, -v[0]],
        [-v[1], v[0], 0.0],
    ])


def _quat_mult_jpl(q, p):
    qv, qw = q[:3], q[3]
    pv, pw = p[:3], p[3]
    v = qw * pv + pw * qv - np.cross(qv, pv)
    w = qw * pw - qv @ pv
    out = np.concatenate([v, [w]])
    n = out / np.linalg.norm(out)
    return -n if n[3] < 0 else n


def _quat_to_rot_jpl(q):
    qv, w = q[:3], q[3]
    return (2 * w**2 - 1) * np.eye(3) - 2 * w * _skew(qv) + 2 * np.outer(qv, qv)


def _rk4_rel_quat(dt, w1, w2):
    """Relative JPL quaternion q_0to1 for body rates w over dt (RK4), matching
    IMU_prop_rk4 in the reference."""
    def omega(w):
        O = np.zeros((4, 4))
        O[:3, :3] = -_skew(w)
        O[:3, 3] = w
        O[3, :3] = -w
        return O

    w_alpha = (w2 - w1) / dt if dt > 0 else np.zeros(3)
    dq = np.array([0.0, 0.0, 0.0, 1.0])

    def norm(q):
        q = q / np.linalg.norm(q)
        return -q if q[3] < 0 else q

    w = w1
    k1 = 0.5 * omega(w) @ dq * dt
    w = w1 + 0.5 * w_alpha * dt
    k2 = 0.5 * omega(w) @ norm(dq + 0.5 * k1) * dt
    k3 = 0.5 * omega(w) @ norm(dq + 0.5 * k2) * dt
    w = w1 + w_alpha * dt
    k4 = 0.5 * omega(w) @ norm(dq + k3) * dt
    return norm(dq + (k1 + 2 * k2 + 2 * k3 + k4) / 6.0)


def gram_schmidt_from_gravity(g_inI0):
    """Gravity-aligned R_GtoI0 whose third column is the unit gravity-up
    direction in I0 (matches the reference's gram_schmidt)."""
    z = g_inI0 / np.linalg.norm(g_inI0)
    e1 = np.array([1.0, 0, 0])
    x = e1 - z * (z @ e1)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    return np.column_stack([x, y, z])


class IwInitializer:
    """Stateful IMU+wheel initialization with the smoothness vote."""

    def __init__(self, gravity_mag=9.81, threshold=0.5, window_time=1.0,
                 R_OtoI=None, p_IinO=None, toff=0.0, gravity_aligned=False):
        self.gravity_mag = gravity_mag
        self.threshold = threshold
        self.window_time = window_time
        self.R_OtoI = np.eye(3) if R_OtoI is None else np.asarray(R_OtoI)
        self.p_IinO = np.zeros(3) if p_IinO is None else np.asarray(p_IinO)
        self.toff = toff
        self.gravity_aligned = gravity_aligned
        self.prev_init = None
        self.cnt_smooth = 0

    # ------------------------------------------------------------------
    def try_init(self, imu_t, imu_w, imu_a, wheel_t, wheel_w, wheel_v):
        """One attempt.  wheel_w/wheel_v: (M,3) odometry-frame rates/velocities.

        Returns None or dict {t, R_GtoI, v_IinI0_world..., bg, ba, v} where v
        is v_IinG at the window start (world = gravity-aligned from R_GtoI).
        """
        sel = self._common_window(imu_t, wheel_t)
        if sel is None:
            return None
        (ia, ib), (wa, wb) = sel
        imu_t = imu_t[ia:ib]
        imu_w = imu_w[ia:ib]
        imu_a = imu_a[ia:ib]
        wheel_t = wheel_t[wa:wb]
        wheel_w = wheel_w[wa:wb]
        wheel_v = wheel_v[wa:wb]
        if len(imu_t) < 20 or len(wheel_t) < 5:
            return None

        static = bool(np.all(np.linalg.norm(wheel_w, axis=1) +
                             np.linalg.norm(wheel_v, axis=1) == 0))
        bg = self._init_bg(imu_t, imu_w, wheel_t, wheel_w)
        if bg is None:
            return None
        v_I0 = self.R_OtoI @ (wheel_v[0] + _skew(wheel_w[0]) @ self.p_IinO)

        sums = self._integrate(bg, imu_t, imu_w, imu_a, wheel_t, wheel_w, wheel_v)
        if static or self.gravity_aligned:
            g_I0 = self._g_simple(v_I0, sums)
        else:
            g_I0 = self._g_dongsi(v_I0, sums)
            if g_I0 is None:
                return None
        ba = self._init_ba(v_I0, g_I0, sums)
        if np.linalg.norm(ba) > self.gravity_mag:
            self.cnt_smooth = 0
            return None
        res = self._residual(v_I0, g_I0, ba, sums)
        if np.linalg.norm(res) / max(len(sums), 1) > self.threshold * 100:
            self.cnt_smooth = 0
            return None

        init = np.concatenate([bg, ba, g_I0, v_I0])
        if self.prev_init is not None and np.linalg.norm(self.prev_init - init) < self.threshold:
            self.cnt_smooth += 1
        else:
            self.cnt_smooth = 0
        self.prev_init = init
        if self.cnt_smooth < 3:
            return None

        R_GtoI0 = gram_schmidt_from_gravity(g_I0)
        return {
            "t": float(wheel_t[0] + self.toff),
            "R_GtoI": R_GtoI0,
            "bg": bg,
            "ba": ba,
            "v": R_GtoI0.T @ v_I0,  # v_IinG
        }

    # ------------------------------------------------------------------
    def _common_window(self, imu_t, wheel_t):
        if len(imu_t) < 2 or len(wheel_t) < 2:
            return None
        t_lo = max(imu_t[0] - self.toff, wheel_t[0])
        t_hi = min(imu_t[-1] - self.toff, wheel_t[-1])
        if t_hi - t_lo < self.window_time:
            return None
        t_lo = t_hi - self.window_time
        wa = int(np.searchsorted(wheel_t, t_lo))
        wb = int(np.searchsorted(wheel_t, t_hi, side="right"))
        ia = max(int(np.searchsorted(imu_t, t_lo + self.toff)) - 1, 0)
        ib = int(np.searchsorted(imu_t, t_hi + self.toff, side="right"))
        return (ia, ib), (wa, wb)

    def _init_bg(self, imu_t, imu_w, wheel_t, wheel_w):
        bg = np.zeros(3)
        cnt = 0
        for tw, wo in zip(wheel_t, wheel_w):
            t = tw + self.toff
            i = int(np.searchsorted(imu_t, t)) - 1
            if i < 0 or i + 1 >= len(imu_t):
                continue
            lam = (t - imu_t[i]) / (imu_t[i + 1] - imu_t[i])
            wi = (1 - lam) * imu_w[i] + lam * imu_w[i + 1]
            bg += wi - self.R_OtoI @ wo
            cnt += 1
        return bg / cnt if cnt else None

    def _integrate(self, bg, imu_t, imu_w, imu_a, wheel_t, wheel_w, wheel_v):
        """Per wheel interval: cumulative (sum_R_a_dt, sum_R_dt, sum_dt,
        v_It_from_wheel) — the building blocks of all four solvers."""
        out = []
        R_IktoI0 = np.eye(3)
        R_O0toOk = np.eye(3)
        sum_R_a_dt = np.zeros(3)
        sum_R_dt = np.zeros((3, 3))
        sum_dt = 0.0
        for i in range(1, len(wheel_t)):
            t_s = wheel_t[i - 1] + self.toff
            t_e = wheel_t[i] + self.toff
            ia = max(int(np.searchsorted(imu_t, t_s)) - 1, 0)
            ib = min(int(np.searchsorted(imu_t, t_e, side="right")) + 1, len(imu_t))
            ts = np.clip(imu_t[ia:ib], t_s, t_e)
            for j in range(len(ts) - 1):
                dt = ts[j + 1] - ts[j]
                if dt <= 0:
                    continue
                w0 = imu_w[ia + j] - bg
                w1 = imu_w[ia + j + 1] - bg
                a_I = 0.5 * (imu_a[ia + j] + imu_a[ia + j + 1])
                sum_R_a_dt = sum_R_a_dt + R_IktoI0 @ a_I * dt
                sum_R_dt = sum_R_dt + R_IktoI0 * dt
                sum_dt += dt
                q01 = _rk4_rel_quat(dt, w0, w1)
                R_IktoI0 = R_IktoI0 @ _quat_to_rot_jpl(q01).T
            q_O = _rk4_rel_quat(t_e - t_s, wheel_w[i - 1], wheel_w[i])
            R_O0toOk = _quat_to_rot_jpl(q_O) @ R_O0toOk
            v_It = self.R_OtoI @ R_O0toOk.T @ (
                wheel_v[i] + _skew(wheel_w[i]) @ self.p_IinO
            )
            out.append((sum_R_a_dt.copy(), sum_R_dt.copy(), sum_dt, v_It))
        return out

    def _g_simple(self, v_I0, sums):
        """Velocity-consistency averaging (init_gI_simple, :208-278)."""
        if self.gravity_aligned:
            return np.array([0.0, 0.0, self.gravity_mag])
        g = np.zeros(3)
        for sum_R_a_dt, _, sum_dt, v_It in sums:
            g += (v_I0 + sum_R_a_dt - v_It) / sum_dt
        g /= len(sums)
        g = g / np.linalg.norm(g) * self.gravity_mag
        return g

    def _g_dongsi(self, v_I0, sums):
        """Norm-constrained LS for gravity (Dong-Si): rows
        -sum_R_dt ba - sum_dt g = v_It - v_I0 - sum_R_a_dt."""
        A1 = np.vstack([-srdt for _, srdt, _, _ in sums])          # (3n,3)
        A2 = np.vstack([-sdt * np.eye(3) for _, _, sdt, _ in sums])
        b = np.concatenate([
            v_It - v_I0 - sradt for sradt, _, _, v_It in sums
        ])
        # eliminate ba: P = I - A1 (A1^T A1)^-1 A1^T
        G1 = A1.T @ A1
        if np.linalg.cond(G1) > 1e12:
            return None
        P = np.eye(len(b)) - A1 @ np.linalg.solve(G1, A1.T)
        D = A2.T @ P @ A2
        d = A2.T @ P @ b
        # minimize |g|-constrained quadratic: (D - lam I) g = d, |g| = r
        lam_e, Q = np.linalg.eigh(D)
        dp = Q.T @ d
        r = self.gravity_mag
        # secular polynomial: sum dp_i^2 prod_{j != i}(lam_j - x)^2 = r^2 prod (lam_i - x)^2
        poly = np.polynomial.polynomial
        num = [0.0]
        for i in range(3):
            term = [dp[i] ** 2]
            for j in range(3):
                if j != i:
                    term = poly.polymul(term, poly.polymul(
                        [lam_e[j], -1.0], [lam_e[j], -1.0]))
            num = poly.polyadd(num, term)
        den = [1.0]
        for i in range(3):
            den = poly.polymul(den, poly.polymul([lam_e[i], -1.0], [lam_e[i], -1.0]))
        full = poly.polysub(num, poly.polymul([r * r], den))
        roots = np.roots(full[::-1])
        best = None
        best_cost = np.inf
        for x in roots:
            if abs(x.imag) > 1e-8:
                continue
            lam = x.real
            denom = lam_e - lam
            if np.any(np.abs(denom) < 1e-12):
                continue
            g = Q @ (dp / denom)
            cost = g @ D @ g - 2 * d @ g
            if cost < best_cost:
                best_cost = cost
                best = g
        if best is None:
            return None
        return best / np.linalg.norm(best) * self.gravity_mag

    def _init_ba(self, v_I0, g_I0, sums):
        ba = np.zeros(3)
        for sum_R_a_dt, sum_R_dt, sum_dt, v_It in sums:
            ba += np.linalg.solve(
                sum_R_dt, v_I0 + sum_R_a_dt - sum_dt * g_I0 - v_It
            )
        return ba / len(sums)

    def _residual(self, v_I0, g_I0, ba, sums):
        res = []
        for sum_R_a_dt, sum_R_dt, sum_dt, v_It in sums:
            res.append(v_I0 + sum_R_a_dt - sum_R_dt @ ba - sum_dt * g_I0 - v_It)
        return np.concatenate(res) if res else np.zeros(3)
