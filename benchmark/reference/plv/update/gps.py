"""GNSS updater (port of plviwo_tpu/update/gps.py).

Rebuild of `PL-VIWO/src/update/gps/UpdaterGPS.*` + `MathGPS.h`: the fused
frame's per-fix position rows (`gps_linear_system`, batch-first) and the
host-side `GpsUpdater` of the live driver (`core/system.py`): the datum and
geodetic->ENU conversion, the fixes buffered before initialization, the
4-DoF world->ENU alignment, the whole-state rotation into ENU, and per-fix
3-DoF position updates with a 2-D fallback.

Initialization follows the reference (UpdaterGPS.cpp:338-516): a RANSAC /
Horn 4-DoF initial guess (numpy, the JAX package's `default_rng` draws) ->
the stacked delayed-initialization system over all covered fixes
(`ekf.delayed_init`) -> rotation of the whole state into ENU with the
transform's columns as common-mode terms -> marginalization of the
transform.  The filter math runs in float64 torch on the state's device at
B = 1 (one vehicle).  SLAM landmarks in a representation other than xyz
do not rotate linearly, so they are marginalized before the rotation
(`ekf.marginalize_slam_slot`), as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import ekf
from ..core.interp import interpolate_pose_linear, interpolate_rotation_jacobian
from ..ops import lie

F64 = torch.float64

_A = 6378137.0  # WGS84
_F = 1.0 / 298.257223563
_E2 = _F * (2 - _F)


def geodetic_to_ecef(lat, lon, alt):
    lat, lon = np.radians(lat), np.radians(lon)
    N = _A / np.sqrt(1 - _E2 * np.sin(lat) ** 2)
    x = (N + alt) * np.cos(lat) * np.cos(lon)
    y = (N + alt) * np.cos(lat) * np.sin(lon)
    z = (N * (1 - _E2) + alt) * np.sin(lat)
    return np.array([x, y, z])


def geodetic_to_enu(lat, lon, alt, datum):
    """WGS84 geodetic -> local ENU about `datum` = (lat0, lon0, alt0).

    (Reference: MathGPS::GeodeticToEnu, MathGPS.h:54-127.)
    """
    lat0, lon0, alt0 = datum
    p = geodetic_to_ecef(lat, lon, alt)
    p0 = geodetic_to_ecef(lat0, lon0, alt0)
    lat0r, lon0r = np.radians(lat0), np.radians(lon0)
    sl, cl = np.sin(lat0r), np.cos(lat0r)
    so, co = np.sin(lon0r), np.cos(lon0r)
    R = np.array([
        [-so, co, 0.0],
        [-sl * co, -sl * so, cl],
        [cl * co, cl * so, sl],
    ])
    return R @ (p - p0)


def horn_4dof(p_W, p_E):
    """Best-fit yaw rotation + translation: p_E ~= R_z(yaw) p_W + t.

    (Reference: get_initial_guess Horn eigen-solve restricted to z-rotation,
    UpdaterGPS.cpp:272-335.)  Closed form: yaw maximizes
    sum cos(yaw)(x_w x_e + y_w y_e) + sin(yaw)(x_w y_e - y_w x_e).
    """
    p_W = np.asarray(p_W)
    p_E = np.asarray(p_E)
    cW = p_W.mean(0)
    cE = p_E.mean(0)
    dW = p_W - cW
    dE = p_E - cE
    a = float(np.sum(dW[:, 0] * dE[:, 0] + dW[:, 1] * dE[:, 1]))
    b = float(np.sum(dW[:, 0] * dE[:, 1] - dW[:, 1] * dE[:, 0]))
    yaw = np.arctan2(b, a)
    c, s = np.cos(yaw), np.sin(yaw)
    R = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    t = cE - R @ cW
    resid = p_E - (p_W @ R.T + t)
    rms = float(np.sqrt(np.mean(np.sum(resid**2, axis=1))))
    return R, t, yaw, rms


def ransac_4dof(p_W, p_E, thresh, n_hyp: int = 128, seed: int = 0):
    """Robust 4-DoF initial guess: 2-point yaw+translation hypotheses,
    consensus by alignment residual, Horn refit on the inlier set.

    (Reference: MathGPS::Ransac_4Dof, MathGPS.h:129, used by
    UpdaterGPS::get_initial_guess.)  The hypotheses come from
    `np.random.default_rng(seed)`, so the consensus set equals the JAX
    package's.

    Returns (R, t, yaw, rms_inliers, inlier_mask).
    """
    p_W = np.asarray(p_W, dtype=float)
    p_E = np.asarray(p_E, dtype=float)
    n = len(p_W)
    if n < 4:
        R, t, yaw, rms = horn_4dof(p_W, p_E)
        return R, t, yaw, rms, np.ones(n, dtype=bool)
    rng = np.random.default_rng(seed)
    best_inl = np.ones(n, dtype=bool)
    best_cnt = -1
    for _ in range(n_hyp):
        i, j = rng.choice(n, 2, replace=False)
        dW = p_W[j] - p_W[i]
        dE = p_E[j] - p_E[i]
        if np.hypot(*dW[:2]) < 0.5:  # degenerate horizontal baseline
            continue
        yaw = np.arctan2(dE[1], dE[0]) - np.arctan2(dW[1], dW[0])
        c, s = np.cos(yaw), np.sin(yaw)
        R = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
        t = 0.5 * ((p_E[i] - R @ p_W[i]) + (p_E[j] - R @ p_W[j]))
        resid = np.linalg.norm(p_E - (p_W @ R.T + t), axis=1)
        inl = resid < thresh
        if inl.sum() > best_cnt:
            best_cnt = int(inl.sum())
            best_inl = inl
    if best_cnt < max(3, n // 3):
        # no consensus: fall back to Horn over everything (caller's rms
        # gate rejects if the cloud is inconsistent)
        R, t, yaw, rms = horn_4dof(p_W, p_E)
        return R, t, yaw, rms, np.ones(n, dtype=bool)
    R, t, yaw, rms = horn_4dof(p_W[best_inl], p_E[best_inl])
    return R, t, yaw, rms, best_inl


def _yaw_rot(yaw):
    """R_z(yaw) (...,3,3) for yaw (...,)."""
    c, s = torch.cos(yaw), torch.sin(yaw)
    z, o = torch.zeros_like(yaw), torch.ones_like(yaw)
    return torch.stack([torch.stack([c, -s, z], -1), torch.stack([s, c, z], -1),
                        torch.stack([z, z, o], -1)], -2)


def transform_state_to_enu(state, R_WtoE, p_WinE):
    """Rotate the whole filter state (means + covariance) from W to ENU by a
    known transform, without the transform's marginalization (reference:
    transform_state_to_ENU, UpdaterGPS.cpp:457-516).  R_WtoE (B,3,3),
    p_WinE (B,3).  No ported path calls it: the GPS init rotates through
    `transform_state_to_enu_marg_trans`.

    q_GtoI -> q_GtoI (x) q(R_WtoE^T) leaves the JPL (local) attitude error
    untouched; positions, velocities and landmarks rotate, so J carries R on
    their blocks and the identity elsewhere.  As in the JAX package, every
    SLAM slot rotates and only the valid ones take the translation."""
    lo = state.layout
    B, D = state.batch, lo.dim
    R = torch.as_tensor(R_WtoE, dtype=F64, device=state.cov.device).expand(B, 3, 3)
    t = torch.as_tensor(p_WinE, dtype=F64, device=state.cov.device).expand(B, 3)
    q_rot = lie.rot_2_quat(R.transpose(-1, -2))

    def rot_q(q):  # q (B,4) or (B,n,4)
        return lie.quat_multiply(q, q_rot.view((B,) + (1,) * (q.ndim - 2) + (4,)))

    def rot_v(v):
        return (R.view((B,) + (1,) * (v.ndim - 2) + (3, 3)) @ v[..., None])[..., 0]

    def rot_p(p):
        return rot_v(p) + t.view((B,) + (1,) * (p.ndim - 2) + (3,))

    t_slam = torch.where(state.slam_valid[..., None], t[:, None, :], 0.0)
    new = state.replace(
        q=rot_q(state.q), q_fej=rot_q(state.q_fej),
        p=rot_p(state.p), p_fej=rot_p(state.p_fej),
        v=rot_v(state.v), v_fej=rot_v(state.v_fej),
        clone_q=rot_q(state.clone_q), clone_q_fej=rot_q(state.clone_q_fej),
        clone_p=rot_p(state.clone_p), clone_p_fej=rot_p(state.clone_p_fej),
        slam_p=rot_v(state.slam_p) + t_slam,
        slam_p_fej=rot_v(state.slam_p_fej) + t_slam,
    )
    J = torch.eye(D, dtype=F64, device=t.device).repeat(B, 1, 1)
    blocks = [lo.IMU_P, lo.IMU_V] + [lo.clone(i) + 3 for i in range(lo.n_clones)] + [
        lo.slam(i) for i in range(lo.max_slam)]
    for s in blocks:
        J[:, s:s + 3, s:s + 3] = R
    cov = J @ state.cov @ J.transpose(-1, -2)
    return new.replace(cov=0.5 * (cov + cov.transpose(-1, -2)))


def transform_state_to_enu_marg_trans(state):
    """Rotate the whole state by its estimated `trans_WtoE` and marginalize
    the transform (reference: transform_state_to_ENU, UpdaterGPS.cpp:457-516).

    Batch-first, float64.  The covariance transform is x_E = f(x_W, n) with
    n = [dpsi, dt] the transform's error: J carries R_z(psi) on the
    position/velocity/landmark blocks, identity on attitude/bias/calib
    blocks, and the trans_WtoE COLUMNS as common-mode terms (a yaw or
    translation error shifts every global quantity coherently).  The
    transform's own rows are then dropped (marginalized) and its mean reset
    to identity.
    """
    lo = state.layout
    B, D, C, S = state.batch, lo.dim, lo.n_clones, lo.max_slam
    t = state.wtoe_p  # (B,3)
    R = _yaw_rot(state.wtoe_th)  # (B,3,3)
    q_rot = lie.rot_2_quat(R.transpose(-1, -2))
    ez = torch.tensor([0.0, 0.0, 1.0], dtype=F64, device=t.device)

    def rot_q(q):  # q (B,4) or (B,n,4)
        return lie.quat_multiply(q, q_rot.view((B,) + (1,) * (q.ndim - 2) + (4,)))

    def rot_v(v):
        return (R.view((B,) + (1,) * (v.ndim - 2) + (3, 3)) @ v[..., None])[..., 0]

    def rot_p(p):
        return rot_v(p) + t.view((B,) + (1,) * (p.ndim - 2) + (3,))

    sv = state.slam_valid[..., None]
    new = state.replace(
        q=rot_q(state.q), q_fej=rot_q(state.q_fej),
        p=rot_p(state.p), p_fej=rot_p(state.p_fej),
        v=rot_v(state.v), v_fej=rot_v(state.v_fej),
        clone_q=rot_q(state.clone_q), clone_q_fej=rot_q(state.clone_q_fej),
        clone_p=rot_p(state.clone_p), clone_p_fej=rot_p(state.clone_p_fej),
        slam_p=torch.where(sv, rot_p(state.slam_p), state.slam_p),
        slam_p_fej=torch.where(sv, rot_p(state.slam_p_fej), state.slam_p_fej),
    )

    w = lo.wtoe_off
    J = torch.eye(D, dtype=F64, device=t.device).repeat(B, 1, 1)

    def set_pos_rows(s, p_E):
        """Rows of a rotated position: R on its own block + trans columns."""
        J[:, s:s + 3, s:s + 3] = R
        J[:, s:s + 3, w] = torch.linalg.cross(ez.expand_as(p_E), p_E - t, dim=-1)
        J[:, s:s + 3, w + 1:w + 4] = torch.eye(3, dtype=F64, device=t.device)

    def set_th_rows(s, q_new):
        # JPL local attitude error is frame-invariant under the right-multiplied
        # yaw; the transform's dpsi enters along the body-frame z axis
        J[:, s:s + 3, w] = lie.quat_2_rot(q_new) @ ez

    set_th_rows(lo.IMU_TH, new.q)
    set_pos_rows(lo.IMU_P, new.p)
    J[:, lo.IMU_V:lo.IMU_V + 3, lo.IMU_V:lo.IMU_V + 3] = R
    J[:, lo.IMU_V:lo.IMU_V + 3, w] = torch.linalg.cross(ez.expand_as(new.v), new.v, dim=-1)
    for i in range(C):
        sc = lo.clone(i)
        set_th_rows(sc, new.clone_q[:, i])
        set_pos_rows(sc + 3, new.clone_p[:, i])
    valid6 = torch.repeat_interleave(state.clone_valid, 6, dim=-1).to(F64)
    J[:, lo.clone_off:lo.clone_off + 6 * C, w:w + 4] *= valid6[..., None]
    for i in range(S):
        set_pos_rows(lo.slam(i), new.slam_p[:, i])
    if S > 0:
        valid3 = torch.repeat_interleave(state.slam_valid, 3, dim=-1).to(F64)
        J[:, lo.slam_off:lo.slam_off + 3 * S, w:w + 4] *= valid3[..., None]
    # drop the transform's own rows (marginalize after the transform)
    J[:, w:w + 4, :] = 0.0
    cov = J @ state.cov @ J.transpose(-1, -2)
    return new.replace(wtoe_th=torch.zeros_like(state.wtoe_th),
                       wtoe_p=torch.zeros_like(state.wtoe_p),
                       cov=0.5 * (cov + cov.transpose(-1, -2)))


def _antenna_jacobian(q0, q1, lam, ext_p):
    """d(antenna)/d[dx0, dx1] (...,3,12) of the antenna p(lam) + R(lam)^T ext_p
    at the pose interpolated between two clones, each perturbed by a JPL
    error state dx = [dtheta, dp]: a left perturbation psi of R(lam) moves
    the antenna by R(lam)^T [ext_p]x psi, psi and the position block from
    `core.interp.interpolate_rotation_jacobian` (closed form; the JAX
    package takes this Jacobian by `jax.jacfwd`)."""
    R_t, J0, J1 = interpolate_rotation_jacobian(q0, q1, lam)
    A = R_t.transpose(-1, -2) @ lie.skew(ext_p.expand(R_t.shape[:-1]))
    lm = lam[..., None, None]
    eye = torch.eye(3, dtype=R_t.dtype, device=R_t.device).expand(A.shape)
    return torch.cat([A @ J0, (1.0 - lm) * eye, A @ J1, lm * eye], dim=-1)


def gps_linear_system(clone_q, clone_p, clone_q_fej, clone_p_fej, slot0, slot1, lam,
                      gps_ext_p, meas):
    """3-row position systems of fixes at interpolated poses.

    clone_* (B,C,4/3); slot0, slot1, lam (B,Ng); gps_ext_p (B,3) the antenna
    in the IMU frame; meas (B,Ng,3).  Returns (H6 (B,Ng,3,12) with respect
    to [clone slot0 (6), clone slot1 (6)] at the FEJ clones, and res
    (B,Ng,3))."""
    def at(x, slot):
        return torch.gather(x, 1, slot[..., None].expand(slot.shape + x.shape[-1:]))

    ext = gps_ext_p[:, None]
    R_t, p_t = interpolate_pose_linear(at(clone_q, slot0), at(clone_p, slot0),
                                       at(clone_q, slot1), at(clone_p, slot1), lam)
    pred = p_t + (R_t.transpose(-1, -2) @ ext[..., None])[..., 0]
    H6 = _antenna_jacobian(at(clone_q_fej, slot0), at(clone_q_fej, slot1), lam, ext)
    return H6, meas - pred


def _host(x):
    """Sequence 0 of a batch-first tensor as a numpy array."""
    return x[0].detach().cpu().numpy()


class GpsUpdater:
    """Host orchestration for GNSS fusion (buffer, datum, init, updates) of
    one vehicle: the system's state holds B = 1."""

    def __init__(self, opts, layout, chi2_table):
        self.op = opts
        self.layout = layout
        self.chi2_table = chi2_table
        self.datum = None
        self.initialized = False
        self.pending = []  # (t, p_ENU) fixes before init
        self.stats = {"accept": 0, "reject": 0, "fallback2d": 0}
        self.align = None  # (R_WtoE, p_WinE, yaw, rms)

    def feed_geodetic(self, t, lat, lon, alt):
        if self.datum is None:
            self.datum = (lat, lon, alt)
        p = geodetic_to_enu(lat, lon, alt, self.datum)
        return self.feed_enu(t, p)

    def feed_enu(self, t, p_enu):
        self.pending.append((float(t), np.asarray(p_enu, dtype=np.float64)))
        return True

    # ------------------------------------------------------------------
    def try_process(self, system):
        """Called after each clone: attempt init, then apply pending fixes."""
        st = system.state
        valid = _host(st.clone_valid)
        times = _host(st.clone_t)
        if not valid.any():
            return
        t_lo = float(times[valid].min())
        t_hi = float(times[valid].max())

        if not self.initialized:
            self._try_initialize(system, t_lo, t_hi)
            if not self.initialized:
                # keep only reasonably recent fixes
                self.pending = [(t, p) for t, p in self.pending if t > t_lo - 30.0]
                return

        # apply fixes whose time is covered by the clone window
        rest = []
        for t, p in self.pending:
            if t > t_hi:
                rest.append((t, p))
                continue
            if t < t_lo:
                continue
            self._update_one(system, t, p)
        self.pending = rest

    # ------------------------------------------------------------------
    def _interp_traj(self, system, t):
        """Bracketing clone slots and fraction (s0, s1, lam) of time t, or
        None where the clone window does not cover it."""
        st = system.state
        valid = _host(st.clone_valid)
        times = _host(st.clone_t)
        vt = times[valid]
        slots = np.nonzero(valid)[0]
        order = np.argsort(vt)
        vt = vt[order]
        slots = slots[order]
        i = int(np.searchsorted(vt, t, side="right") - 1)
        if i < 0 or (i >= len(vt) - 1 and vt[-1] < t):
            return None
        if vt[i] == t or i == len(vt) - 1:
            s0 = s1 = int(slots[i])
            lam = 0.0
        else:
            s0, s1 = int(slots[i]), int(slots[i + 1])
            lam = (t - vt[i]) / (vt[i + 1] - vt[i])
        return s0, s1, lam

    def _try_initialize(self, system, t_lo, t_hi):
        covered = [(t, p) for t, p in self.pending if t_lo <= t <= t_hi]
        if len(covered) < 3:
            return
        # distance traveled over the clone window history
        traj = system.traj
        if len(traj) < 2:
            return
        ps = np.asarray([p for _, _, p in traj])
        dist = float(np.sum(np.linalg.norm(np.diff(ps, axis=0), axis=1)))
        if dist < self.op.init_distance:
            return
        # build correspondences at fix times (covered is filtered in lockstep
        # so covered[k] <-> p_W[k] <-> itps[k] stay aligned); the clones are
        # read to the host once and interpolated there
        st = system.state
        cq, cp = st.clone_q.cpu(), st.clone_p.cpu()
        ext = _host(st.gps_p)[0] if self.layout.n_gps > 0 else np.zeros(3)
        p_W, p_E, itps, kept = [], [], [], []
        for t, p in covered:
            itp = self._interp_traj(system, t)
            if itp is None:
                continue
            s0, s1, lam = itp
            R_t, p_t = interpolate_pose_linear(cq[0, s0], cp[0, s0], cq[0, s1], cp[0, s1],
                                               torch.tensor(lam, dtype=F64))
            p_W.append(p_t.numpy() + R_t.numpy().T @ ext)
            p_E.append(p)
            itps.append(itp)
            kept.append((t, p))
        covered = kept
        if len(p_W) < 3:
            return
        # robust initial guess: RANSAC over fix pairs, Horn refit on the
        # consensus set (MathGPS::Ransac_4Dof); outlier fixes are excluded
        # from the delayed-init linear system below
        R, t_al, yaw, rms, inl = ransac_4dof(
            np.asarray(p_W), np.asarray(p_E), thresh=3.0 * self.op.noise)
        if rms > 10.0 * self.op.noise or inl.sum() < 3:
            # decimate like the reference's failed-init path
            self.pending = self.pending[::2]
            return
        if inl.sum() < 0.5 * len(p_W):
            # weak consensus: wait for more fixes rather than commit a
            # possibly-wrong frame alignment
            return
        covered = [c for c, m in zip(covered, inl) if m]
        p_W = [p for p, m in zip(p_W, inl) if m]
        itps = [p for p, m in zip(itps, inl) if m]

        # --- delayed initialization of the 4-DoF transform (reference:
        # construct_init_linsys + StateHelper::initialize,
        # UpdaterGPS.cpp:338-455).  Model per fix:
        #   p_E = R_z(psi_hat + dpsi)(p_W + dp_W(dx)) + t_hat + dt + n
        # => r_i = p_E_i - (R_hat p_W_i + t_hat)
        #        = [ez x (R_hat p_W_i) | I3] [dpsi; dt] + R_hat dp_W_i + n ---
        lo = self.layout
        if lo.n_gps == 0:
            return  # no wtoe block allocated; cannot estimate the transform
        n_fix = len(p_W)
        s0s, s1s = (torch.tensor([[x[i] for x in itps]]) for i in range(2))
        lams = torch.tensor([[x[2] for x in itps]], dtype=F64)
        H12, _ = gps_linear_system(
            cq, cp, st.clone_q_fej.cpu(), st.clone_p_fej.cpu(), s0s, s1s, lams,
            st.gps_p[:, 0].cpu(), torch.tensor(np.asarray(p_W))[None])
        H12 = H12[0].numpy()
        ez = np.array([0.0, 0.0, 1.0])
        Hx = np.zeros((3 * n_fix, lo.dim))
        Hn = np.zeros((3 * n_fix, 4))
        r = np.zeros(3 * n_fix)
        for k, ((t, p_e), pw, (s0, s1, lam)) in enumerate(zip(covered, p_W, itps)):
            rows = slice(3 * k, 3 * k + 3)
            Hx[rows, lo.clone(s0):lo.clone(s0) + 6] += R @ H12[k, :, 0:6]
            Hx[rows, lo.clone(s1):lo.clone(s1) + 6] += R @ H12[k, :, 6:12]
            Hn[rows, 0] = np.cross(ez, R @ pw)
            Hn[rows, 1:4] = np.eye(3)
            r[rows] = p_e - (R @ pw + t_al)

        def dev(a):
            return torch.as_tensor(a, dtype=F64, device=st.cov.device)[None]

        st = st.replace(wtoe_th=dev(yaw), wtoe_p=dev(t_al))
        r_diag = dev(np.full(3 * n_fix, self.op.noise**2))
        new_cov, dx_full, dn, _, _, _ = ekf.delayed_init(
            st.cov, dev(Hx), dev(Hn), dev(r), r_diag, lo.wtoe_off, 4)
        # sanity: reject a clearly broken alignment solve (reference:
        # StateHelper.cpp:567-574 suspicious-init rejection)
        dn_h = _host(dn)
        if not (np.all(np.isfinite(dn_h)) and abs(float(dn_h[0])) < 0.5
                and float(np.linalg.norm(dn_h[1:4])) < 10.0):
            self.pending = self.pending[::2]
            return
        st = ekf.apply_dx(st, dx_full).replace(cov=new_cov)
        # apply_dx already folded dx_full's wtoe component; add the
        # initialization value dn on top
        st = st.replace(wtoe_th=st.wtoe_th + dn[:, 0], wtoe_p=st.wtoe_p + dn[:, 1:4])
        yaw_f = float(_host(st.wtoe_th))
        t_f = _host(st.wtoe_p)
        c_, s_ = np.cos(yaw_f), np.sin(yaw_f)
        R_f = np.array([[c_, -s_, 0.0], [s_, c_, 0.0], [0.0, 0.0, 1.0]])
        # posterior transform covariance (pre-marginalization) for NEES checks
        w = lo.wtoe_off
        self.init_trans_cov = _host(st.cov[:, w:w + 4, w:w + 4])

        # --- whole-state rotation into ENU + transform marginalization
        # (reference: transform_state_to_ENU, UpdaterGPS.cpp:457-516).
        # Non-xyz landmark representations do not rotate linearly: drop the
        # landmarks first (the reference marginalizes SLAM here regardless).
        if getattr(system, "feat_rep", 0) != 0 and st.layout.max_slam > 0:
            for slot in np.nonzero(_host(st.slam_valid))[0]:
                st = ekf.marginalize_slam_slot(st, int(slot))
        system.state = transform_state_to_enu_marg_trans(st)
        # rotate the recorded trajectory too (it is now in ENU)
        q_rot = lie.rot_2_quat(torch.as_tensor(R_f.T))
        qs = lie.quat_multiply(torch.as_tensor(np.stack([q_ for _, q_, _ in system.traj])),
                               q_rot).numpy()
        system.traj = [(t_, qs[i], R_f @ p_ + t_f) for i, (t_, _, p_) in enumerate(system.traj)]
        self.align = (R_f, t_f, yaw_f, rms)
        self.initialized = True

    def _update_one(self, system, t, p_meas):
        itp = self._interp_traj(system, t)
        if itp is None:
            return
        s0, s1, lam = itp
        st = system.state
        lo = self.layout
        dev = st.cov.device
        ext = st.gps_p[:, 0] if lo.n_gps > 0 else st.p.new_zeros(1, 3)
        H12, res = gps_linear_system(
            st.clone_q, st.clone_p, st.clone_q_fej, st.clone_p_fej,
            torch.tensor([[s0]], device=dev), torch.tensor([[s1]], device=dev),
            torch.tensor([[lam]], dtype=F64, device=dev), ext,
            torch.as_tensor(p_meas, dtype=F64, device=dev)[None, None])
        H = st.cov.new_zeros(1, 3, lo.dim)
        H[:, :, lo.clone(s0):lo.clone(s0) + 6] += H12[:, 0, :, 0:6]
        H[:, :, lo.clone(s1):lo.clone(s1) + 6] += H12[:, 0, :, 6:12]
        res = res[:, 0]
        r_diag = torch.full((1, 3), self.op.noise**2, dtype=F64, device=dev)
        mask3 = torch.ones((1, 3), dtype=torch.bool, device=dev)
        chi = float(ekf.chi2(st.cov, H, res, r_diag, mask3)[0])
        gate3 = float(self.chi2_table[3]) * self.op.chi2_mult
        if chi < gate3:
            system.state = ekf.update(st, H, res, r_diag, mask3)
            self.stats["accept"] += 1
            return
        # 2-D fallback: drop the z row (reference: UpdaterGPS.cpp:260-267)
        mask2 = torch.tensor([[True, True, False]], device=dev)
        chi2d = float(ekf.chi2(st.cov, H, res, r_diag, mask2)[0])
        if chi2d < float(self.chi2_table[2]) * self.op.chi2_mult:
            system.state = ekf.update(st, H, res, r_diag, mask2)
            self.stats["fallback2d"] += 1
        else:
            self.stats["reject"] += 1
