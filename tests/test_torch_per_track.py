"""The port's per-track path against the JAX package, on the CPU.

The simulator's data association (`Simulator.cam_frame`, both cameras),
the feature database, `ekf.marginalize_clone` and `measurement_compress`,
the polynomial interpolation and its table (`core.interp.polynomial_pose`,
`build_interp_table`), the table rows (`update.cam_helper.
point_systems_table_batch`), the XLA gate at the per-track shapes
(`msckf_project_and_gate`), the 2D wheel rows and the 3D wheel dt column,
and `VioSystem.feed_camera` / `feed_stereo` frame by frame with
`run_sim` without --images.  Inputs are numpy arrays made from a seed, or
the simulators' streams; the JAX driver runs its Python feature store
(`fdb_native = None`; tests/test_native.py holds the two stores equal).

Tolerances: `cam_frame` ids equal and uv within 1e-12 px, with the
generators in step after it; the feature databases equal;
`marginalize_clone` exact; `measurement_compress` H'^T H' and H'^T r'
within 1e-6 of max|G| and max|c| (JAX factors the equilibrated Gram in
float32) and the short-system branch exact, a clone slot of rounding
noise compressed as the slot exactly zero within 1e-12, and with it exactly
zero the factor over the valid columns that of JAX's equilibrated Gram bit
for bit; `polynomial_pose` and the
table's poses within 1e-12, its Jacobians within 1e-9 of `jax.jacfwd`
(the port's are in closed form) and within 1e-6 of central differences;
the table rows within 1e-9 of max(1, max|x|) on valid rows; the gate's
`feat_ok` and row masks equal and its rows within 1e-8 of max(1,
max|x|); `preintegrate_2d` within 1e-12 (a prefix sum and a tree fold where
JAX scans) and `linear_system_2d` / the dt column within 1e-10.

The driver, in five modes (mono points; points + wheel + GPS; stereo;
dynamic cloning at order 3 under a 4 Hz clone cap, estimating the camera's
time offset and extrinsics; sequential updates with wheel and GPS,
estimating the wheel's time offset, started 5 ms off because at 0 the sign
of a 1e-6 s estimate decides in either package whether the newest wheel
pair is covered), over 2-2.5 s of simulation, against JAX with its
compression factor keeping the rows and columns of a numerically zero Gram
diagonal out (`jax_factor_valid_only`, as the port factors them; JAX as it
ships factors a column of rounding noise in at unit size, which moves its
trajectory by up to ~1e-2 m in one update): `stats` equal after every frame
and `len(traj)` equal; positions within 1e-5 m and the covariance within
1e-3 max|cov| of JAX's (2.5e-7 m and 1.0e-5 measured), and in the two modes
with the GPS init within 3e-2 m and 0.1 max|cov| (8.1e-5 m and 1.8e-3
measured: the 4-DoF init's rotation into ENU carries the difference to every
pose); in mono also against JAX with its float64 products and solves
(`jax_f64_linalg_all`), within 1e-8 m and 1e-6 max|cov| over the first
five frames and within 1e-6 m and 1e-5 max|cov| over all (2.3e-8 m and
2.4e-7 measured).  The seed of the two packages' difference is the float32
IMU transition both compute (1.5e-8 of max|cov| after the first frame) and
JAX's float32 factors.  `run_sim` without --images: JAX's summary keys plus `device`, and
JAX's frame count.  The slow tests hold the port alone to the gates of
tests/test_e2e_vio.py (including test_stereo_beats_mono) and
tests/test_poly_interp_e2e.py::test_order_continuum_at_low_clone_rate.
"""

import contextlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plviwo_tpu.config.options import EstimatorOptions as JOptions
from plviwo_tpu.core import ekf as j_ekf
from plviwo_tpu.core import interp as j_interp
from plviwo_tpu.core.layout import StateLayout as JLayout
from plviwo_tpu.core.state import make_state as j_make_state
from plviwo_tpu.core.system import VioSystem as JVioSystem
from plviwo_tpu.ops.chi2 import _TABLE as J_CHI2
from plviwo_tpu.sim.simulator import SimConfig as JSimConfig
from plviwo_tpu.sim.simulator import Simulator as JSimulator
from plviwo_tpu.update import cam_helper as j_cam
from plviwo_tpu.update import feature_db as j_fdb
from plviwo_tpu.update import wheel as j_wheel
from plviwo_tpu_torch import examples, run_sim
from plviwo_tpu_torch.config.options import EstimatorOptions
from plviwo_tpu_torch.core import ekf, interp
from plviwo_tpu_torch.core.layout import StateLayout
from plviwo_tpu_torch.core.state import FilterState, make_state
from plviwo_tpu_torch.core.system import VioSystem
from plviwo_tpu_torch.ops import lie
from plviwo_tpu_torch.ops.chi2 import _TABLE as T_CHI2
from plviwo_tpu_torch.sim.simulator import SimConfig, Simulator
from plviwo_tpu_torch.update import cam_helper, feature_db, wheel
from tests.test_torch_fused_frame import _jax_state_arrays

F64 = torch.float64


def _t(x, dtype=F64):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


def _close(a, b, tol, what=""):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    scale = max(1.0, float(np.max(np.abs(b)))) if b.size else 1.0
    err = float(np.max(np.abs(a - b))) if b.size else 0.0
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol:.1e} x {scale:.3e}"


# --- the simulator's data association and the feature database ----------------

@pytest.mark.parametrize("cam", [0, 1])
def test_cam_frame_matches_jax(cam):
    cfg = dict(duration=4.0, seed=7, n_pts=30, sigma_pix=0.7)
    port, jsim = Simulator(SimConfig(**cfg)), JSimulator(JSimConfig(**cfg))
    port.imu_stream(), jsim.imu_stream()
    for t in port.cam_times()[::5]:
        ids, uv = port.cam_frame(t, cam=cam)
        jids, juv = jsim.cam_frame(t, cam=cam)
        np.testing.assert_array_equal(ids, jids)
        np.testing.assert_allclose(uv, juv, rtol=0, atol=1e-12)
    assert len(ids) == 30  # more visible than n_pts: the permutation was drawn
    assert port.rng.normal() == jsim.rng.normal()


def test_feature_db_matches_jax():
    rng = np.random.default_rng(11)
    dbs = (feature_db.FeatureDatabase(), j_fdb.FeatureDatabase())
    for k in range(60):
        t = 0.1 * k
        for fid in rng.choice(40, size=12, replace=False):
            uv, uvn, cam = rng.normal(size=2), rng.normal(size=2), int(rng.integers(2))
            for db in dbs:
                db.update(int(fid), t, uv, uvn, cam=cam)
        if k % 7 == 3:
            for db in dbs:
                db.cleanup(t - 1.0)
        if k % 5 == 4:
            gone = [int(x) for x in rng.choice(40, size=4, replace=False)]
            for db in dbs:
                db.remove(gone)
        assert dbs[0].ids_at(t) == dbs[1].ids_at(t)
        assert ([f for f, _ in dbs[0].lost_before(t)] == [f for f, _ in dbs[1].lost_before(t)])
    a, b = dbs
    assert len(a) == len(b) > 0 and list(a.tracks) == list(b.tracks)
    for fid, tr in a.tracks.items():
        jt = b.tracks[fid]
        assert tr.times == jt.times and tr.cams == jt.cams
        assert [tr.cam_of(i) for i in range(len(tr.times) + 1)] == \
            [jt.cam_of(i) for i in range(len(jt.times) + 1)]
        np.testing.assert_array_equal(np.array(tr.uvs), np.array(jt.uvs))
        np.testing.assert_array_equal(np.array(tr.uvns), np.array(jt.uvns))


# --- EKF pieces -----------------------------------------------------------------

LAYOUT = dict(n_clones=8, n_cams=1, use_wheel=True)


def _spd(rng, n, scale):
    A = rng.normal(size=(n, n))
    return scale * (A @ A.T / n + np.eye(n))


def test_marginalize_clone_matches_jax():
    rng = np.random.default_rng(3)
    lo = StateLayout(**LAYOUT)
    st = make_state(lo, device="cpu").to_numpy()
    st["clone_valid"][:] = True
    st["clone_keyframe"][[2, 5]] = True
    st["clone_t"] = 10.0 + 0.1 * np.arange(lo.n_clones)
    st["cov"] = _spd(rng, lo.dim, 1e-2)
    jst = j_make_state(JLayout(**LAYOUT)).replace(**{k: jnp.asarray(v) for k, v in st.items()})
    port = FilterState.from_numpy(st, lo, "cpu")
    for slot in (0, 5, 7):
        want = _jax_state_arrays(j_ekf.marginalize_clone(jst, slot))
        got = ekf.marginalize_clone(port, slot).to_numpy()
        for k in ("clone_valid", "clone_keyframe", "clone_t", "cov"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{k} slot {slot}")


@pytest.mark.parametrize("M", [720, 40])
def test_measurement_compress_matches_jax(M):
    """A tall system (the per-track joint rows: compressed through the
    Gram) and a short one (M <= D: masked and passed through)."""
    rng = np.random.default_rng(M)
    D = 102
    H = rng.normal(size=(M, D))
    H[:, 20:30] = 0.0  # empty clone slots: null directions
    H[::3] *= 1e3
    r = rng.normal(size=M)
    mask = rng.random(M) > 0.3
    H[~mask] = np.nan  # masked rows may carry NaN
    Hc, rc, valid = ekf.measurement_compress(_t(H)[None], _t(r)[None], _t(mask, torch.bool)[None])
    jH, jr, jv = (np.asarray(x) for x in j_ekf.measurement_compress(
        jnp.asarray(H), jnp.asarray(r), jnp.asarray(mask)))
    Hc, rc, valid = Hc[0].numpy(), rc[0].numpy(), valid[0].numpy()
    np.testing.assert_array_equal(valid, jv)
    if M <= D:
        np.testing.assert_array_equal(Hc, jH)
        np.testing.assert_array_equal(rc, jr)
        return
    Hm = np.where(mask[:, None], H, 0.0)
    G, c = Hm.T @ Hm, Hm.T @ np.where(mask, r, 0.0)
    for got, want, ref in ((Hc.T @ Hc, jH.T @ jH, G), (Hc.T @ rc, jH.T @ jr, c)):
        assert np.max(np.abs(got - want)) < 1e-6 * np.max(np.abs(ref))
        assert np.max(np.abs(got - ref)) < 1e-5 * np.max(np.abs(ref))  # the jitter


def test_compression_keeps_noise_columns_out_of_the_factor():
    """A clone slot whose rows carry rounding noise (Gram diagonal ~1e-25
    against ~1e8, as for a clone the interpolation weights at ~1e-16)
    compresses as the same slot exactly zero: the valid columns keep their
    information.  With the slot exactly zero the factor over the valid
    columns is the one of the equilibrated Gram as JAX forms it, bit for
    bit."""
    from plviwo_tpu_torch.ops.linalg import chol_equilibrated

    rng = np.random.default_rng(12)
    M, D = 60, 30
    H = rng.normal(size=(M, D)) * 1e3
    H[:, 12:18] = 0.0
    noisy = H.copy()
    noisy[:, 12:18] = 1e-14 * rng.normal(size=(M, 6))
    r, mask = _t(rng.normal(size=M))[None], torch.ones(1, M, dtype=torch.bool)
    Hc, rc, valid = ekf.measurement_compress(_t(H)[None], r, mask)
    Hn, rn, valid_n = ekf.measurement_compress(_t(noisy)[None], r, mask)
    keep = np.ones(D, bool)
    keep[12:18] = False
    np.testing.assert_array_equal(valid[0].numpy(), keep)
    np.testing.assert_array_equal(valid_n[0].numpy(), keep)
    _close(Hn[0].numpy()[np.ix_(keep, keep)], Hc[0].numpy()[np.ix_(keep, keep)], 1e-12)
    _close(rn[0].numpy()[keep], rc[0].numpy()[keep], 1e-12)
    assert not Hn[0].numpy()[~keep].any() and not Hn[0].numpy()[:, ~keep].any()
    # the exactly zero slot: JAX's equilibrated Gram (in float64) factored whole
    G = _t(H.T @ H)[None]
    d = torch.sqrt(torch.clamp(torch.diagonal(G, dim1=-2, dim2=-1), min=1e-30))
    whole = torch.linalg.cholesky(G / (d[..., :, None] * d[..., None, :]) + 3e-6 * torch.eye(D,
                                                                                          dtype=F64))
    L, _ = chol_equilibrated(G)
    np.testing.assert_array_equal(L[0].numpy()[np.ix_(keep, keep)],
                                  (d[..., :, None] * whole)[0].numpy()[np.ix_(keep, keep)])


# --- polynomial interpolation and its table ---------------------------------------

C_RING = 8


def _ring(rng):
    """A clone ring on a curving, pitching path 0.1 s apart, its FEJ copy
    perturbed."""
    ts = 0.1 * np.arange(C_RING)
    q, p = [], []
    for t in ts:
        R = lie.exp_so3(_t([0.05 * np.sin(3 * t), 0.1 * t * t, 0.6 * t])).numpy()
        q.append(lie.rot_2_quat(_t(R)).numpy())
        p.append([3.0 * t, np.sin(2 * t), 0.2 * t * t])
    q, p = np.array(q), np.array(p)
    qf = lie.quat_norm(_t(q + rng.normal(0, 1e-3, q.shape))).numpy()
    return ts, q, p, qf, p + rng.normal(0, 1e-2, p.shape)


def _table_inputs(rng, K, T=10):
    ts, *_ = ring = _ring(rng)
    perm = rng.permutation(C_RING)  # slots in ring order, not time order
    inv = np.argsort(perm)
    q, p, qf, pf = (x[perm] for x in ring[1:])  # slot s holds time ts[perm[s]]
    sup_slot = np.zeros((T, K), dtype=np.int64)
    sup_dt = np.zeros((T, K))
    dt_eval = np.zeros(T)
    for i in range(T):
        j0 = int(rng.integers(0, C_RING - K + 1))
        sup_slot[i] = inv[j0:j0 + K]
        sup_dt[i] = ts[j0:j0 + K] - ts[j0]
        dt_eval[i] = 0.0 if i == 0 else rng.uniform(0, sup_dt[i, -1])
    return (q, p, qf, pf), sup_slot, sup_dt, dt_eval


@pytest.mark.parametrize("K", [2, 3, 4])
def test_polynomial_pose_matches_jax(K):
    rng = np.random.default_rng(K)
    (q, p, _, _), s, d, e = _table_inputs(rng, K)
    args = (q[s[:, 0]], p[s[:, 0]], q[s[:, 1:]], p[s[:, 1:]], d[:, 1:], e)
    R, pt = interp.polynomial_pose(*(_t(x) for x in args))
    jR, jp = jax.jit(jax.vmap(j_interp.polynomial_pose))(*(jnp.asarray(x) for x in args))
    _close(R, jR, 1e-12, "R")
    _close(pt, jp, 1e-12, "p")


def _fd_table(q, p, qf, pf, sup_slot, sup_dt, dt_eval, K, eps=1e-6):
    """Central differences of the FEJ interpolated pose [psi, p] wrt each
    clone's JPL [dtheta, dp] and the evaluation time."""
    def pose(qf_, pf_, dte):
        out = interp.build_interp_table(_t(q)[None], _t(p)[None], _t(qf_)[None], _t(pf_)[None],
                                        _t(sup_slot, torch.long)[None], _t(sup_dt)[None],
                                        _t(dte)[None], K=K, n_clones=C_RING)
        return out[2][0], out[3][0]

    R0 = lie.quat_2_rot(pose(qf, pf, dt_eval)[0])

    def err(qf_, pf_, dte):
        qt, pt = pose(qf_, pf_, dte)
        return torch.cat([lie.log_so3(R0 @ lie.quat_2_rot(qt).transpose(-1, -2)), pt], -1).numpy()

    J = np.zeros((len(dt_eval), 6, 6 * C_RING))
    for c in range(C_RING):
        for k in range(6):
            d = np.zeros(6)
            d[k] = eps
            outs = []
            for sgn in (1, -1):
                qf_, pf_ = qf.copy(), pf.copy()
                qf_[c] = ekf.lie.quat_multiply(ekf._dq(_t(sgn * d[:3])), _t(qf[c])).numpy()
                pf_[c] = pf[c] + sgn * d[3:]
                outs.append(err(qf_, pf_, dt_eval))
            J[:, :, 6 * c + k] = (outs[0] - outs[1]) / (2 * eps)
    Jt = (err(qf, pf, dt_eval + eps) - err(qf, pf, dt_eval - eps)) / (2 * eps)
    return J, Jt


@pytest.mark.parametrize("K", [2, 3, 4])
def test_interp_table_matches_jax_and_differences(K):
    rng = np.random.default_rng(10 + K)
    (q, p, qf, pf), sup_slot, sup_dt, dt_eval = _table_inputs(rng, K)
    got = interp.build_interp_table(_t(q)[None], _t(p)[None], _t(qf)[None], _t(pf)[None],
                                    _t(sup_slot, torch.long)[None], _t(sup_dt)[None],
                                    _t(dt_eval)[None], K=K, n_clones=C_RING)
    want = j_interp.build_interp_table(*(jnp.asarray(x) for x in (q, p, qf, pf)),
                                       jnp.asarray(sup_slot.astype(np.int32)),
                                       jnp.asarray(sup_dt), jnp.asarray(dt_eval), K=K,
                                       n_clones=C_RING)
    for name, a, b, tol in zip(("tq", "tp", "tq_f", "tp_f", "tJ", "tJt"), got, want,
                               (1e-12, 1e-12, 1e-12, 1e-12, 1e-9, 1e-9)):
        _close(a[0], b, tol, name)
    J, Jt = _fd_table(q, p, qf, pf, sup_slot, sup_dt, dt_eval, K)
    _close(got[4][0], J, 1e-6, "tJ vs differences")
    _close(got[5][0], Jt, 1e-6, "tJt vs differences")


# --- the table rows and the gate ----------------------------------------------------

def _table_system_inputs(rng, stereo, F=12, O=6, K=3):
    (q, p, qf, pf), sup_slot, sup_dt, dt_eval = _table_inputs(rng, K, T=O + 2)
    tbl = [np.asarray(x) for x in j_interp.build_interp_table(
        *(jnp.asarray(x) for x in (q, p, qf, pf)), jnp.asarray(sup_slot.astype(np.int32)),
        jnp.asarray(sup_dt), jnp.asarray(dt_eval), K=K, n_clones=C_RING)]
    # landmarks ~6 m ahead of the table poses (camera z forward = body x)
    cam_q = np.array([[0.5, -0.5, 0.5, -0.5], [0.5, -0.5, 0.5, -0.5]])
    cam_p = np.array([[0.05, 0.0, 0.0], [-0.07, 0.0, 0.0]])
    cam_k = np.array([[300.0, 300.0, 320.0, 240.0, -0.05, 0.01, 5e-4, -2e-4],
                      [310.0, 305.0, 318.0, 242.0, -0.04, 0.02, 1e-4, -1e-4]])
    p_f = tbl[1][0] + np.array([6.0, 0.0, 0.0]) + rng.uniform(-2, 2, (F, 3))
    obs_tidx = rng.integers(0, O + 2, (F, O))
    obs_valid = rng.random((F, O)) > 0.2
    obs_cam = rng.integers(0, 2, (F, O)) if stereo else np.zeros((F, O), dtype=np.int64)
    obs_uv = rng.uniform(50, 600, (F, O, 2))
    return tbl, p_f, obs_uv, obs_tidx, obs_valid, obs_cam, cam_q, cam_p, cam_k


@pytest.mark.parametrize("stereo,calib", [(False, False), (False, True), (True, False),
                                          (True, True)])
def test_point_systems_table_matches_jax(stereo, calib):
    rng = np.random.default_rng(20 + 2 * stereo + calib)
    tbl, p_f, obs_uv, tidx, valid, cam, cq, cp, ck = _table_system_inputs(rng, stereo)
    lo = StateLayout(n_clones=C_RING, n_cams=2)
    cols = ((lo.cam_dt(0), lo.cam_ext(0), lo.cam_int(0)) if calib else (-1, -1, -1))
    per_obs = [x[cam] for x in (cq, cp, ck)]
    got = cam_helper.point_systems_table_batch(
        _t(p_f)[None], _t(obs_uv)[None], _t(tidx, torch.long)[None], _t(valid, torch.bool)[None],
        _t(cam == 0, torch.bool)[None], *(_t(x)[None] for x in tbl),
        *(_t(x)[None] for x in per_obs), 0, lo.clone_off, lo.dim, *cols)
    want = j_cam.point_systems_table_batch(
        jnp.asarray(p_f), jnp.asarray(obs_uv), jnp.asarray(tidx.astype(np.int32)),
        jnp.asarray(valid), jnp.asarray(cam == 0), *(jnp.asarray(x) for x in tbl),
        *(jnp.asarray(x) for x in per_obs), 0, lo.clone_off, lo.dim, *cols)
    rows = np.asarray(want[3])
    np.testing.assert_array_equal(got[3][0].numpy(), rows)
    for name, a, b in zip(("Hx", "Hf", "r"), got[:3], want[:3]):
        _close(a[0].numpy()[rows], np.asarray(b)[rows], 1e-9, name)
    if calib:
        assert np.abs(np.asarray(want[0])[rows][:, lo.cam_int(0)]).max() > 0


def _gate_inputs(rng, F, M, D, s2):
    Hx = rng.normal(size=(F, M, D)) * 30.0
    Hf = rng.normal(size=(F, M, 3)) * 100.0
    cov = _spd(rng, D, 1e-8)
    # residuals consistent with the systems for most features, outliers for some
    r = (np.einsum("fmk,fk->fm", Hf, rng.normal(0, 0.01, (F, 3)))
         + np.sqrt(s2) * rng.normal(size=(F, M)))
    r[::5] += rng.normal(0, 6.0, (len(r[::5]), M))
    rowmask = np.repeat(rng.random((F, M // 2)) > 0.25, 2, axis=1)
    rowmask[-1] = False
    rowmask[-2, 4:] = False  # too few rows
    Hx[~rowmask] = np.nan
    return Hx, Hf, r, rowmask, cov


@pytest.mark.parametrize("F,O", [(30, 12), (40, 22)])
@pytest.mark.parametrize("per_row", [False, True])
def test_msckf_project_and_gate_matches_jax(F, O, per_row):
    rng = np.random.default_rng(F + O + per_row)
    D = 15 + 6 * O + 15
    s2 = rng.uniform(0.25, 4.0, (F, 2 * O)) if per_row else 0.5**2
    Hx, Hf, r, rowmask, cov = _gate_inputs(rng, F, 2 * O, D, s2)
    got = cam_helper.msckf_project_and_gate(
        _t(Hx)[None], _t(Hf)[None], _t(r)[None], _t(rowmask, torch.bool)[None], _t(cov)[None],
        _t(s2)[None] if per_row else s2, _t(T_CHI2), 5.0)
    want = j_cam.msckf_project_and_gate(
        jnp.asarray(Hx), jnp.asarray(Hf), jnp.asarray(r), jnp.asarray(rowmask),
        jnp.asarray(cov), jnp.asarray(s2) if per_row else s2, jnp.asarray(J_CHI2), 5.0)
    ok = np.asarray(want[3])
    np.testing.assert_array_equal(got[3][0].numpy(), ok)
    np.testing.assert_array_equal(got[2][0].numpy(), np.asarray(want[2]))
    assert 0 < ok.sum() < F - 2
    for name, a, b in zip(("Hn", "rn"), got[:2], want[:2]):
        _close(a[0].numpy()[ok], np.asarray(b)[ok], 1e-8, name)


# --- wheel rows ------------------------------------------------------------------------

def _wheel_case(rng, C=6):
    lo = StateLayout(n_clones=C, n_cams=1, use_wheel=True)
    ts = np.concatenate([[0.0], np.sort(rng.uniform(0, 0.1, 20)), [0.1], np.full(9, 0.1)])
    m1 = 8.0 + rng.normal(0, 0.5, len(ts))
    m2 = 9.0 + rng.normal(0, 0.5, len(ts))
    intr = np.array([0.31, 0.29, 1.4])
    st = make_state(lo, device="cpu").to_numpy()
    for i in range(C):
        a = 0.05 * i
        st["clone_q"][i] = lie.rot_2_quat(lie.exp_so3(_t([0.01 * i, -0.02 * i, a]))).numpy()
        st["clone_p"][i] = [2.5 * np.cos(a) * i, 0.3 * i * i, 0.01 * i]
    st["clone_q_fej"] = lie.quat_norm(_t(st["clone_q"] + rng.normal(0, 1e-3, (C, 4)))).numpy()
    st["clone_p_fej"] = st["clone_p"] + rng.normal(0, 1e-2, (C, 3))
    wq = lie.quat_norm(_t([0.01, -0.02, 0.03, 1.0])).numpy()
    wp = np.array([0.1, -0.05, -0.5])
    wv = [rng.normal(size=3) for _ in range(4)]
    return lo, ts, m1, m2, intr, st, wq, wp, wv


@pytest.mark.parametrize("type_code", [wheel.W2D_ANG, wheel.W2D_LIN, wheel.W2D_CEN])
def test_wheel_2d_matches_jax(type_code):
    rng = np.random.default_rng(30 + type_code)
    lo, ts, m1, m2, intr, st, wq, wp, wv = _wheel_case(rng)
    got = wheel.preintegrate_2d(_t(ts)[None], _t(m1)[None], _t(m2)[None], _t(intr)[None],
                                0.05, 0.06, 0.02, type_code)
    want = j_wheel.preintegrate_2d(jnp.asarray(ts), jnp.asarray(m1), jnp.asarray(m2),
                                   jnp.asarray(intr), 0.05, 0.06, 0.02, type_code)
    for name, a, b in zip(("th", "xy", "Cov"), got, want):
        _close(a[0], b, 1e-12, name)
    ring = [st[k] for k in ("clone_q", "clone_p", "clone_q_fej", "clone_p_fej")]
    for do_dt in (False, True):
        dt = dict(wheel_dt_off=lo.wheel_dt, do_calib_dt=do_dt)
        H, res = wheel.linear_system_2d(*(_t(x)[None] for x in ring), _t([1], torch.long), _t([4], torch.long),
                                        _t(wq)[None], _t(wp)[None], got[0], got[1],
                                        lo.n_clones, lo.clone_off, lo.dim, **dt,
                                        **({k: _t(v)[None] for k, v in zip(
                                            ("w0", "v0", "w1", "v1"), wv)} if do_dt else {}))
        jH, jres = j_wheel.linear_system_2d(
            *(jnp.asarray(x) for x in ring), jnp.asarray(1), jnp.asarray(4), jnp.asarray(wq),
            jnp.asarray(wp), want[0], want[1], lo.n_clones, lo.clone_off, lo.dim, **dt,
            **({k: jnp.asarray(v) for k, v in zip(("w0", "v0", "w1", "v1"), wv)}
               if do_dt else {}))
        _close(H[0], jH, 1e-10, "H")
        _close(res[0], jres, 1e-10, "res")


def test_wheel_3d_dt_column_matches_jax():
    rng = np.random.default_rng(40)
    lo, ts, m1, m2, intr, st, wq, wp, wv = _wheel_case(rng)
    pre = wheel.preintegrate_3d(_t(ts)[None], _t(m1)[None], _t(m2)[None], _t(intr)[None],
                                0.05, 0.06, 0.02, wheel.W3D_ANG)
    ring = [st[k] for k in ("clone_q", "clone_p", "clone_q_fej", "clone_p_fej")]
    flags = (lo.wheel_ext, lo.wheel_int, True, True)
    H, res = wheel.linear_system_3d(
        *(_t(x)[None] for x in ring), _t([2], torch.long), _t([3], torch.long), _t(wq)[None], _t(wp)[None],
        pre[0], pre[1], pre[3], pre[4], lo.n_clones, lo.clone_off, lo.dim, *flags,
        wheel_dt_off=lo.wheel_dt, do_calib_dt=True,
        **{k: _t(v)[None] for k, v in zip(("w0", "v0", "w1", "v1"), wv)})
    jH, jres = j_wheel.linear_system_3d(
        *(jnp.asarray(x) for x in ring), jnp.asarray(2), jnp.asarray(3), jnp.asarray(wq),
        jnp.asarray(wp), *(jnp.asarray(x[0].numpy()) for x in (pre[0], pre[1], pre[3], pre[4])),
        lo.n_clones, lo.clone_off, lo.dim, *flags, wheel_dt_off=lo.wheel_dt, do_calib_dt=True,
        **{k: jnp.asarray(v) for k, v in zip(("w0", "v0", "w1", "v1"), wv)})
    _close(H[0], jH, 1e-10, "H")
    _close(res[0], jres, 1e-10, "res")
    assert np.abs(np.asarray(jH)[:, lo.wheel_dt]).max() > 0


def test_imu_buffer_at_matches_jax():
    from plviwo_tpu.core.propagator import ImuBuffer as JImuBuffer
    from plviwo_tpu_torch.core.propagator import ImuBuffer

    rng = np.random.default_rng(50)
    bufs = ImuBuffer(), JImuBuffer()
    for t in np.sort(rng.uniform(0, 1, 40)):
        w, a = rng.normal(size=3), rng.normal(size=3)
        for b in bufs:
            b.feed(t, w, a)
    for t in np.concatenate([rng.uniform(-0.1, 1.1, 20), bufs[1].t[[0, 7, -1]]]):
        got, want = bufs[0].at(t), bufs[1].at(t)
        assert (got is None) == (want is None)
        if want is not None:
            np.testing.assert_array_equal(np.stack(got), np.stack(want))


# --- the driver, frame by frame ----------------------------------------------------

DRIVER_MODES = ("mono", "stereo", "dynamic", "wheel_gps", "sequential")
POS_TOL, COV_TOL = 1e-5, 1e-3  # m, and of max|cov| (see the module docstring)
GPS_POS_TOL, GPS_COV_TOL = 3e-2, 0.1  # the modes with the GPS init


def _scenario(mode):
    """(SimConfig kwargs, option setter) of a driver mode: tests/test_e2e_vio.py's
    options; run_sim's wheel and GPS settings (GPS at 5 Hz so the 4-DoF init
    lands within the run), with one joint update a frame or sequential
    updates (the sequential one estimating the wheel's time offset);
    run_sim --stereo's track length; dynamic cloning at order 3 under a
    4 Hz cap, estimating the camera's time offset and extrinsics online."""
    gps = mode in ("wheel_gps", "sequential")
    sim = dict(duration=2.5 if gps else 2.0, seed=1, sigma_pix=0.5, n_pts=45)
    if gps:
        sim.update(gps_hz=5.0, sigma_gps=0.3)

    def options(o):
        o.window_size, o.clone_freq = 1.0, 10
        o.cam.n_pts, o.cam.max_msckf, o.cam.sigma_pix = 60, 30, 0.5
        o.cam.min_track_length, o.cam.chi2_mult = 4, 5.0
        if mode == "stereo":
            o.cam.max_n, o.cam.min_track_length = 2, 6
        if mode == "dynamic":
            o.dynamic_cloning, o.clone_freq, o.intr_order = True, 4, 3
            o.cam.do_calib_dt = o.cam.do_calib_ext = True  # calibration columns, dt shift
        if mode in ("wheel_gps", "sequential"):
            w = o.wheel
            w.enabled, w.type, w.chi2_mult = True, "Wheel3DAng", 10.0
            w.noise_w, w.noise_v, w.noise_p = 0.05, 0.05, 0.02
        if gps:
            o.gps.enabled, o.gps.noise, o.gps.chi2_mult, o.gps.init_distance = True, 0.3, 10.0, 4.0
        if mode == "sequential":
            o.joint_update = False
            o.wheel.do_calib_dt = True  # the clones' (w, v) record and the dt column
        return o

    return sim, options


def _drive(mode, port):
    """Run one mode through the port's or JAX's VioSystem; returns per frame
    (stats, position, covariance)."""
    sim_kw, options = _scenario(mode)
    if port:
        sim = Simulator(SimConfig(**sim_kw))
        system = VioSystem(options(EstimatorOptions()), device="cpu")
    else:
        sim = JSimulator(JSimConfig(**sim_kw))
        system = JVioSystem(options(JOptions()))
        system.fdb_native = None
    events = examples.track_events(sim, stereo=mode == "stereo",
                                   wheel=system.opts.wheel.enabled, gps=system.gps is not None)
    c = sim.cfg
    system.set_calibration(np.asarray(c.intrinsics), np.asarray(c.cam_ext_q),
                           np.asarray(c.cam_ext_p))
    if system.layout.n_cams >= 2:
        system.set_calibration(np.asarray(c.intrinsics), np.asarray(c.cam_ext_q),
                               np.asarray(c.cam_ext_p) + [-c.stereo_baseline, 0.0, 0.0], cam=1)
    if system.opts.wheel.enabled:
        # with the wheel's time offset estimated, start it 5 ms off: at 0 a
        # 1e-6 s estimate's sign decides, in either package, whether the
        # newest pair is covered (a wheel sample lies on every frame time)
        system.set_wheel_calibration(c.wheel_ext_q, c.wheel_ext_p,
                                     [c.wheel_rl, c.wheel_rr, c.wheel_base],
                                     dt=0.005 if system.opts.wheel.do_calib_dt else 0.0)
    if system.gps is not None:
        if port:
            system.set_gps_calibration(c.gps_ext_p)
        else:
            system.state = system.state.replace(
                gps_p=system.state.gps_p.at[0].set(jnp.asarray(c.gps_ext_p)))
    t0 = float(sim.imu_t[0])
    kin = sim.gt_kin(t0)
    q0 = lie.rot_2_quat(_t(kin["R_GtoI"])).numpy()
    system.initialize_from(t0, q0, kin["p_IinG"], kin["v_IinG"], sim.bg_true[0], sim.ba_true[0])
    frames = []
    for kind, args in events:
        n = len(system.traj)
        examples.feed(system, kind, args)
        if len(system.traj) > n:
            cov = system.state.cov[0].numpy() if port else np.asarray(system.state.cov)
            frames.append((dict(system.stats), np.array(system.traj[-1][2]), cov))
    return system, frames


@pytest.fixture(scope="module", autouse=True)
def _cache_small_compiles():
    """The JAX driver compiles hundreds of small programs (eager operations
    at each mode's shapes), each under the persistent cache's 0.5 s floor:
    cache them too while this module runs."""
    key = "jax_persistent_cache_min_compile_time_secs"
    old = getattr(jax.config, key)
    jax.config.update(key, 0.0)
    yield
    jax.config.update(key, old)


@pytest.fixture(scope="module")
def jax_runs():
    """One JAX driver run per mode, made on first use."""
    cache = {}

    def get(mode):
        if mode not in cache:
            cache[mode] = _drive(mode, port=False)
        return cache[mode]
    return get


def _compare(port_frames, jax_frames, pos_tol, cov_tol, n=None):
    assert len(port_frames) == len(jax_frames)
    for i, ((sa, pa, ca), (sb, pb, cb)) in enumerate(list(zip(port_frames, jax_frames))[:n]):
        assert sa == sb, f"frame {i}: {sa} != {sb}"
        assert np.max(np.abs(pa - pb)) < pos_tol, f"frame {i}: position"
        assert np.max(np.abs(ca - cb)) < cov_tol * np.max(np.abs(cb)), f"frame {i}: covariance"


@pytest.mark.parametrize("mode", DRIVER_MODES)
def test_driver_matches_jax(jax_factor_valid_only, jax_runs, mode):
    jsys, want = jax_runs(mode)
    port, got = _drive(mode, port=True)
    gps = mode in ("wheel_gps", "sequential")
    _compare(got, want, *((GPS_POS_TOL, GPS_COV_TOL) if gps else (POS_TOL, COV_TOL)))
    assert len(port.traj) == len(jsys.traj) and port.stats == jsys.stats
    st = port.stats
    assert st["cam_accept"] > 50 and st["lost_marg_obs"] == 0
    if mode in ("wheel_gps", "sequential"):
        assert st["wheel_accept"] > 10
    if mode == "sequential":
        assert len(port.clone_wv) > 0
    if mode in ("wheel_gps", "sequential"):
        assert port.gps.initialized and port.gps.stats == jsys.gps.stats
        assert port.gps.stats["accept"] > 0
    if mode == "dynamic":
        assert port._cur_order == jsys._cur_order
    if mode == "sequential":
        assert st["updates"] > st["clones"]


def valid_only_factor(dtype):
    """JAX's `ops.linalg.chol_equilibrated` with the rows and columns of a
    numerically zero Gram diagonal kept out of the factor, as the port's
    (`plviwo_tpu_torch/ops/linalg.py`) keeps them: JAX factors a column of
    rounding noise in at unit size, and the information it takes from the
    valid columns moves its trajectory by up to ~1e-2 m in one update
    (ROADMAP C, known differences).  The factor in `dtype` (float32 as JAX
    ships it); where no such column carries noise, JAX's own factor."""
    def chol_equilibrated(G, jitter=3e-6):
        diag = jnp.diagonal(G, axis1=-2, axis2=-1)
        valid = diag > 1e-12 * jnp.max(diag, axis=-1, keepdims=True)
        d = jnp.sqrt(jnp.clip(diag, 1e-30, None))
        eye = jnp.eye(G.shape[-1], dtype=dtype)
        Si = jnp.where(valid[..., :, None] & valid[..., None, :],
                       G / (d[..., :, None] * d[..., None, :]), eye.astype(G.dtype))
        L = jnp.linalg.cholesky(Si.astype(dtype) + jitter * eye)
        L = jnp.where(jnp.isnan(L), eye, L)
        return d[..., :, None] * L.astype(G.dtype), valid
    return chol_equilibrated


def _patch_jax_linalg(monkeypatch, **fns):
    """Set JAX `ops.linalg` functions for one test, with the compiled
    programs that traced the old ones dropped on the way in and out."""
    from plviwo_tpu.ops import linalg

    for name, fn in fns.items():
        monkeypatch.setattr(linalg, name, fn)
    jax.clear_caches()
    yield
    jax.clear_caches()


@pytest.fixture
def jax_factor_valid_only(monkeypatch):
    """The JAX package's compression factor as `valid_only_factor`."""
    yield from _patch_jax_linalg(monkeypatch, chol_equilibrated=valid_only_factor(jnp.float32))


@pytest.fixture
def jax_f64_linalg_all(monkeypatch):
    """Every float32 workaround of the JAX EKF update and compression
    replaced by the float64 product, solve or factor it approximates: the
    split products, the refined solve, the equilibrated float32 Cholesky
    (as `valid_only_factor`) and the refined triangular solve."""
    yield from _patch_jax_linalg(
        monkeypatch, dmatmul=lambda a, b: a @ b,
        solve_psd_refined=lambda S, B, iters=1: jnp.linalg.solve(S, B),
        chol_equilibrated=valid_only_factor(jnp.float64),
        tri_lower_solve_refined=lambda L, b, iters=1:
            jax.scipy.linalg.solve_triangular(L, b, lower=True))


def test_driver_matches_jax_f64(jax_f64_linalg_all):
    """Mono, within 1e-8 m over the first five frames and 1e-6 m over all."""
    _, want = _drive("mono", port=False)
    _, got = _drive("mono", port=True)
    _compare(got, want, 1e-8, 1e-6, n=5)
    _compare(got, want, 1e-6, 1e-5)


def _run_main(mod, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mod.main(argv)
    return rc, json.loads(buf.getvalue().strip().splitlines()[-1])


# plviwo_tpu.run_sim.main(["--platform", "cpu", "--duration", "1.5"]): its keys,
# 13 frames, 10 updates, accept rate 0.914 (ATE 0.0065 m)
JAX_SUMMARY_KEYS = {"frames", "ate_rmse_m", "max_err_m", "updates", "accept_rate", "wall_s",
                    "fps", "distance_m", "clones", "cam_accept_rate", "line_accept_rate",
                    "wheel_accept_rate"}


def test_run_sim_per_track_matches_jax_summary():
    rc, out = _run_main(run_sim, ["--device", "cpu", "--duration", "1.5"])
    assert rc == 0
    assert set(out) == JAX_SUMMARY_KEYS | {"device", "feature_store"}
    assert out["device"] == "cpu" and out["feature_store"] == "native"
    assert (out["frames"], out["updates"], out["accept_rate"]) == (13, 10, 0.914)


# --- the JAX end-to-end tests' scenarios, on the port alone ----------------------

def _e2e_vio_run(duration=15.0, seed=1, **opt):
    """tests/test_e2e_vio.py's scenario through the port."""
    cfg = SimConfig(duration=duration, seed=seed, sigma_pix=0.5, n_pts=45, sigma_w=1.7e-4,
                    sigma_a=2.0e-3, sigma_wb=1.9e-5, sigma_ab=3.0e-3)
    sim = Simulator(cfg)
    o = EstimatorOptions()
    o.window_size, o.clone_freq = 1.0, 10
    o.cam.n_pts, o.cam.max_msckf, o.cam.sigma_pix = 60, 30, 0.5
    o.cam.min_track_length, o.cam.chi2_mult = 4, 5.0
    for k, v in opt.items():
        setattr(o, k, v)
    system = VioSystem(o, device="cpu")
    examples.live_calibrate(system, sim, float(sim.imu_t[0]))
    for kind, args in examples.track_events(sim):
        examples.feed(system, kind, args)
    return sim, system


@pytest.mark.slow
def test_e2e_vio_gates():
    """tests/test_e2e_vio.py's five gates."""
    sim, s = _e2e_vio_run()
    errs = np.array([np.linalg.norm(p - sim.gt_kin(t)["p_IinG"]) for t, _, p in s.traj])
    rmse = float(np.sqrt(np.mean(errs**2)))
    assert len(s.traj) > 100 and rmse < 1.0 and errs[-1] < 2.0, (rmse, errs[-1])
    st = s.stats
    assert st["updates"] > 20 and st["cam_accept"] > 50
    assert st["cam_accept"] / max(st["cam_accept"] + st["cam_reject"], 1) > 0.5
    assert st["lost_marg_obs"] == 0
    cov = s.state.cov[0].numpy()
    assert np.all(np.isfinite(cov))
    active = np.flatnonzero(np.abs(np.diag(cov)) > 0)
    sub = cov[np.ix_(active, active)]
    eig = np.linalg.eigvalsh(sub)
    assert np.all(np.diag(sub) > 0) and eig.min() > -1e-7 * eig.max()
    assert np.trace(cov[3:6, 3:6]) < 5.0
    t, q, _ = s.traj[-1]
    dR = lie.quat_2_rot(_t(q)).numpy() @ sim.gt_kin(t)["R_GtoI"].T
    assert np.linalg.norm(lie.log_so3(_t(dR)).numpy()) < 0.05


@pytest.mark.slow
def test_stereo_beats_mono():
    """tests/test_e2e_vio.py::test_stereo_beats_mono through the port's run_sim."""
    base = ["--device", "cpu", "--duration", "8", "--seed", "2"]
    rc, mono = _run_main(run_sim, base)
    rc2, stereo = _run_main(run_sim, base + ["--stereo"])
    assert rc == rc2 == 0
    assert stereo["ate_rmse_m"] < mono["ate_rmse_m"], (mono, stereo)


@pytest.mark.slow
def test_order_continuum_at_low_clone_rate():
    """tests/test_poly_interp_e2e.py's gates at orders 1, 2 and 3 (12 s,
    seed 3, dynamic cloning under a 4 Hz cap)."""
    out = {}
    for order in (1, 2, 3):
        cfg = SimConfig(duration=12.0, seed=3, sigma_pix=0.5, n_pts=45)
        sim = Simulator(cfg)
        o = EstimatorOptions()
        o.dynamic_cloning, o.clone_freq, o.intr_order = True, 4, order
        o.cam.max_msckf, o.cam.sigma_pix, o.cam.min_track_length, o.cam.chi2_mult = 30, 0.5, 4, 5.0
        s = VioSystem(o, device="cpu")
        examples.live_calibrate(s, sim, float(sim.imu_t[0]))
        for kind, args in examples.track_events(sim):
            examples.feed(s, kind, args)
        errs = [np.linalg.norm(p - sim.gt_kin(t)["p_IinG"]) for t, _, p in s.traj]
        out[order] = (float(np.sqrt(np.mean(np.square(errs)))), s)
    (r1, _), (r2, s2), (r3, s3) = out[1], out[2], out[3]
    assert r1 < 1.0 and r2 < 1.0 and r3 < 1.0, (r1, r2, r3)
    assert r3 <= r1 * 1.15 and r2 <= r1 * 1.15, (r1, r2, r3)
    assert s3.stats["clones"] < 0.75 * len(s3.traj) + 60
    assert s3.stats["updates"] > 10 and s2.stats["updates"] > 10
    assert s3.stats["lost_marg_obs"] == 0
