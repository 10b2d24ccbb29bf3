"""The port's SLAM landmarks against the JAX package, on the CPU.

The landmark representations (`cam_helper.rep_to_xyz`, `xyz_to_rep`,
`rep_jacobian`), the in-state landmark rows (`slam_systems_batch`) in both
representations, `ekf.marginalize_slam_slot`, the GPS 4-DoF init with
inverse-depth landmarks (marginalized before the rotation into ENU), and
`VioSystem` with `cam.max_slam > 0` frame by frame.  Inputs are numpy
arrays made from a seed, or the two simulators' streams; both drivers export
their mono MSCKF candidates through the C++ feature store (the JAX driver
handed the port's build, tests/test_torch_per_track_lines.py::native_store),
where SLAM-owned tracks take candidate places and are masked out.

Tolerances: the representations and their round trip within 1e-12 of
max(1, max|x|), the Jacobian within 1e-12 of JAX's and 1e-6 of central
differences; `slam_systems_batch` row masks equal, Hx and r within 1e-9 of
max(1, max|x|) on valid rows; `marginalize_slam_slot` exact; the GPS init
with JAX's float64 products and solve (as tests/test_torch_system.py's GPS
parity): state, trajectory and alignment within 1e-9 of max(1, max|x|).

The driver, in two modes over 2-2.5 s of simulation (tests/test_slam.py's
options with every visible point tracked, so that landmarks initialize
within the window: 8 slots in GLOBAL_3D; 6 slots in
GLOBAL_FULL_INVERSE_DEPTH with W3D_ANG wheel rows and 5 Hz GPS, whose 4-DoF
init marginalizes the landmarks), against JAX with the port's compression
factor (`jax_factor_valid_only`, see tests/test_torch_per_track.py):
`stats` equal after every frame, the set of active landmark ids (`slam_id`
where `slam_valid`) equal after every frame, `len(traj)` equal; positions
within 1e-5 m and the covariance within 1e-3 max|cov| of JAX's (1.9e-7 m
and 1.6e-5 measured), and with the GPS init within 3e-2 m and 0.1 max|cov|
(1.0e-3 m and 2.3e-3 measured: the 4-DoF init's rotation into ENU carries
the difference to every pose).  The slow tests hold the port alone to the
gates of tests/test_slam.py (both representations) and of
tests/test_joint_update.py's two live tests.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plviwo_tpu.config.options import GpsOptions as JGpsOptions
from plviwo_tpu.core import ekf as j_ekf
from plviwo_tpu.core.layout import StateLayout as JLayout
from plviwo_tpu.core.state import make_state as j_make_state
from plviwo_tpu.ops.chi2 import _TABLE as J_CHI2
from plviwo_tpu.update import cam_helper as j_cam
from plviwo_tpu.update import gps as j_gps
from plviwo_tpu_torch import examples
from plviwo_tpu_torch.config.options import EstimatorOptions, GpsOptions
from plviwo_tpu_torch.core import ekf
from plviwo_tpu_torch.core.layout import StateLayout
from plviwo_tpu_torch.core.state import FilterState, make_state
from plviwo_tpu_torch.core.system import VioSystem
from plviwo_tpu_torch.ops import lie
from plviwo_tpu_torch.ops.chi2 import _TABLE as T_CHI2
from plviwo_tpu_torch.sim.simulator import SimConfig, Simulator
from plviwo_tpu_torch.update import cam_helper, gps
from tests.test_torch_fused_frame import _jax_state_arrays
from tests.test_torch_per_track_lines import _cache_small_compiles  # noqa: F401 (fixture)
from tests.test_torch_per_track import GPS_COV_TOL, GPS_POS_TOL
from tests.test_torch_per_track import jax_factor_valid_only  # noqa: F401 (fixture)
from tests.test_torch_per_track_lines import _close, _t, compare, drive
from tests.test_torch_system import GPS_LAYOUT, _gps_case, _System
from tests.test_torch_system import jax_f64_linalg  # noqa: F401 (fixture)

REPS = ("GLOBAL_3D", "GLOBAL_FULL_INVERSE_DEPTH")


# --- representations and the landmark rows ------------------------------------------

@pytest.mark.parametrize("rep_name", REPS)
def test_representations_match_jax_and_differences(rep_name):
    rep = cam_helper.REP_CODES[rep_name]
    assert rep == j_cam.REP_CODES[rep_name]
    rng = np.random.default_rng(1 + rep)
    p = rng.normal(size=(2, 5, 3)) + np.array([0.0, 0.0, 5.0])
    p[1, 4, 2] = 0.0  # a landmark at depth 0: the guarded division
    r = cam_helper.xyz_to_rep(_t(p), rep)
    _close(r, j_cam.xyz_to_rep(jnp.asarray(p), rep), 1e-12, "xyz_to_rep")
    back = cam_helper.rep_to_xyz(r, rep)
    _close(back, j_cam.rep_to_xyz(jnp.asarray(r.numpy()), rep), 1e-12, "rep_to_xyz")
    _close(back[0], p[0], 1e-12, "round trip")
    J = cam_helper.rep_jacobian(r, rep)
    _close(J, j_cam.rep_jacobian(jnp.asarray(r.numpy()), rep), 1e-12, "rep_jacobian")
    eps = 1e-6
    for k in range(3):
        d = torch.zeros(3, dtype=torch.float64)
        d[k] = eps
        fd = (cam_helper.rep_to_xyz(r[0] + d, rep)
              - cam_helper.rep_to_xyz(r[0] - d, rep)) / (2 * eps)
        _close(J[0, :, :, k], fd, 1e-6, "rep_jacobian vs differences")


def _ring(rng, C=8):
    """A clone ring on a curving path 0.1 s apart and its perturbed FEJ copy."""
    q, p = [], []
    for t in 0.1 * np.arange(C):
        R = lie.exp_so3(_t([0.05 * np.sin(3 * t), 0.1 * t * t, 0.6 * t])).numpy()
        q.append(lie.rot_2_quat(_t(R)).numpy())
        p.append([3.0 * t, np.sin(2 * t), 0.2 * t * t])
    q, p = np.array(q), np.array(p)
    qf = lie.quat_norm(_t(q + rng.normal(0, 1e-3, q.shape))).numpy()
    return q, p, qf, p + rng.normal(0, 1e-2, p.shape)


@pytest.mark.parametrize("rep_name", REPS)
def test_slam_systems_match_jax(rep_name):
    """The driver's call: S landmarks, one observation each at the newest
    clone (s0 = s1, lam = 0), the last two slots padding."""
    rep = cam_helper.REP_CODES[rep_name]
    rng = np.random.default_rng(40 + rep)
    C, S = 8, 6
    lo = StateLayout(n_clones=C, n_cams=1, max_slam=S)
    ring = _ring(rng, C)
    xyz = ring[1][-1] + np.array([6.0, 0.0, 0.0]) + rng.uniform(-2, 2, (S, 3))
    xyz_fej = xyz + rng.normal(0, 0.05, xyz.shape)
    rep_fej = cam_helper.xyz_to_rep(_t(xyz_fej), rep).numpy()
    slot = np.array([3, 0, 5, 1, 0, 0])
    uv = rng.uniform(50, 600, (S, 1, 2))
    s0 = np.full((S, 1), C - 1)
    valid = np.array([[True]] * 4 + [[False]] * 2)
    cam = (np.array([0.5, -0.5, 0.5, -0.5]), np.array([0.05, 0.0, 0.0]),
           np.array([300.0, 300.0, 320.0, 240.0, -0.05, 0.01, 5e-4, -2e-4]))
    got = cam_helper.slam_systems_batch(
        _t(xyz)[None], _t(slot, torch.long)[None], _t(uv)[None], _t(s0, torch.long)[None],
        _t(valid, torch.bool)[None],
        *(_t(x)[None] for x in ring), *(_t(x)[None] for x in cam), 0, C, lo.clone_off,
        lo.slam_off, lo.dim, rep_jac=cam_helper.rep_jacobian(_t(rep_fej), rep)[None])
    want = [np.asarray(x) for x in j_cam.slam_systems_batch(
        jnp.asarray(xyz), jnp.asarray(slot.astype(np.int32)), jnp.asarray(uv),
        jnp.asarray(s0.astype(np.int32)), jnp.asarray(s0.astype(np.int32)), jnp.zeros((S, 1)),
        jnp.asarray(valid), *(jnp.asarray(x) for x in ring), jnp.asarray(xyz_fej),
        *(jnp.asarray(x) for x in cam), 0, C, lo.clone_off, lo.slam_off, lo.dim,
        rep_jac=j_cam.rep_jacobian(jnp.asarray(rep_fej), rep))]
    rows = want[2]
    np.testing.assert_array_equal(got[2][0].numpy(), rows)
    _close(got[0][0].numpy()[rows], want[0][rows], 1e-9, "Hx")
    _close(got[1][0].numpy()[rows], want[1][rows], 1e-9, "r")
    # each landmark's columns are its slot's
    cols = np.abs(want[0][rows][:, lo.slam_off:]).reshape(-1, S, 3).sum(-1) > 0
    assert (np.flatnonzero(cols.any(0)) == np.unique(slot[:4])).all()


def test_marginalize_slam_slot_matches_jax():
    rng = np.random.default_rng(50)
    layout = dict(n_clones=6, n_cams=1, max_slam=4)
    lo = StateLayout(**layout)
    st = make_state(lo, device="cpu").to_numpy()
    st["slam_valid"][:] = [True, True, False, True]
    st["slam_id"][:] = [5, 9, -1, 12]
    st["slam_p"] = rng.normal(size=(4, 3))
    A = rng.normal(size=(lo.dim, lo.dim))
    st["cov"] = A @ A.T / lo.dim + np.eye(lo.dim)
    jst = j_make_state(JLayout(**layout)).replace(**{k: jnp.asarray(v) for k, v in st.items()})
    port = FilterState.from_numpy(st, lo, "cpu")
    for slot in (0, 3, 2):
        want = _jax_state_arrays(j_ekf.marginalize_slam_slot(jst, slot))
        got = ekf.marginalize_slam_slot(port, slot).to_numpy()
        for k in ("slam_valid", "slam_id", "cov", "slam_p"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{k} slot {slot}")


def test_gps_init_marginalizes_non_xyz_landmarks_like_jax(jax_f64_linalg):  # noqa: F811
    """tests/test_torch_system.py's GPS case with three landmark slots (two
    valid, inverse depth): both updaters initialize, marginalize the
    landmarks before the rotation into ENU and fuse the fixes; the states,
    trajectories and alignments agree."""
    layout = dict(GPS_LAYOUT, max_slam=3)
    lo0, st0, traj, fixes = _gps_case()
    lo = StateLayout(**layout)
    st = make_state(lo, device="cpu").to_numpy()
    st.update({k: v for k, v in st0.items() if k != "cov" and not k.startswith("slam")})
    rng = np.random.default_rng(60)
    D0 = lo0.dim
    st["cov"] = np.zeros((lo.dim, lo.dim))
    st["cov"][:D0, :D0] = st0["cov"]
    A = rng.normal(size=(9, 9))
    st["cov"][D0:, D0:] = 0.05 * (A @ A.T / 9 + np.eye(9))
    st["slam_valid"][:] = [True, False, True]
    st["slam_id"][:] = [11, -1, 17]
    xyz = st0["clone_p"][:3] + np.array([6.0, 1.0, 2.0])
    st["slam_p"] = st["slam_p_fej"] = cam_helper.xyz_to_rep(_t(xyz), 1).numpy()
    systems = [_System(j_make_state(JLayout(**layout)).replace(
        **{k: jnp.asarray(v) for k, v in st.items()}), list(traj), feat_rep=1),
        _System(FilterState.from_numpy(st, lo, "cpu"), list(traj), feat_rep=1)]
    kw = dict(noise=0.3, chi2_mult=10.0, init_distance=8.0)
    ups = [j_gps.GpsUpdater(JGpsOptions(**kw), JLayout(**layout), J_CHI2),
           gps.GpsUpdater(GpsOptions(**kw), lo, T_CHI2)]
    for u, s in zip(ups, systems):
        for f in fixes:
            u.feed_enu(*f)
        u._try_initialize(s, 10.0, 13.5)
        u.try_process(s)
    (ju, tu), (js, ts) = ups, systems
    assert tu.initialized and ju.initialized and tu.stats == ju.stats
    got, want = ts.state.to_numpy(), _jax_state_arrays(js.state)
    for k, v in want.items():
        _close(got[k], v, 1e-9, k)
    assert not got["slam_valid"].any() and (got["slam_id"] == -1).all()
    for slot in (0, 2):  # the valid slots' rows and columns are zero
        band = slice(lo.slam(slot), lo.slam(slot) + 3)
        assert not got["cov"][band].any() and not got["cov"][:, band].any()
    for (ta, qa, pa), (tb, qb, pb) in zip(ts.traj, js.traj, strict=True):
        assert ta == tb
        _close(qa, qb, 1e-9)
        _close(pa, pb, 1e-9)


# --- the driver, frame by frame ----------------------------------------------------

SLAM_MODES = ("slam_3d", "slam_invdepth_gps")


def _slam_scenario(mode):
    """(SimConfig kwargs, option setter, track_events kwargs): tests/test_slam.py's
    options over 2 s with 8 landmark slots in xyz, or over 2.5 s with 6
    inverse-depth slots, W3D_ANG wheel rows and 5 Hz GPS (run_sim's noise
    settings, the 4-DoF init after 4 m), with every visible point tracked."""
    gps_mode = mode == "slam_invdepth_gps"
    # every visible point a frame (n_pts above the visible count): tracks
    # long enough for a landmark within the window (with tests/test_slam.py's
    # 45 of them, drawn anew each frame, the first lands after 2.6 s)
    sim = dict(duration=2.5 if gps_mode else 2.0, seed=1, sigma_pix=0.5, n_pts=100)
    if gps_mode:
        sim.update(gps_hz=5.0, sigma_gps=0.3)

    def options(o):
        o.cam.max_msckf, o.cam.sigma_pix, o.cam.min_track_length, o.cam.chi2_mult = 25, 0.5, 4, 5.0
        o.cam.max_slam = 6 if gps_mode else 8
        if gps_mode:
            o.cam.feat_rep = "GLOBAL_FULL_INVERSE_DEPTH"
            w = o.wheel
            w.enabled, w.type, w.chi2_mult = True, "Wheel3DAng", 10.0
            w.noise_w, w.noise_v, w.noise_p = 0.05, 0.05, 0.02
            o.gps.enabled, o.gps.noise, o.gps.chi2_mult, o.gps.init_distance = True, 0.3, 10.0, 4.0
        return o

    return sim, options, dict(wheel=gps_mode)


@pytest.mark.parametrize("mode", SLAM_MODES)
def test_driver_slam_matches_jax(jax_factor_valid_only, mode):
    sim_kw, options, events_kw = _slam_scenario(mode)
    jsys, want = drive(sim_kw, options, events_kw, port=False)
    port, got = drive(sim_kw, options, events_kw, port=True)
    compare(got, want, *((GPS_POS_TOL, GPS_COV_TOL) if mode == "slam_invdepth_gps" else ()))
    assert len(port.traj) == len(jsys.traj) and port.stats == jsys.stats
    assert max(len(f[3]) for f in got) >= 3  # landmarks were initialized
    # the host mirrors of the slots match the state
    st = port.state.to_numpy()
    np.testing.assert_array_equal(port._slam_valid, st["slam_valid"])
    np.testing.assert_array_equal(np.where(st["slam_valid"], port._slam_id, -1),
                                  np.where(st["slam_valid"], st["slam_id"], -1))
    if mode == "slam_invdepth_gps":
        assert port.gps.initialized and port.gps.stats == jsys.gps.stats
        # landmarks were active before the init and gone right after it
        k = next(k for k, f in enumerate(got) if f[0]["gps_initialized"])
        assert got[k - 1][3] and not got[k][3] and port.stats["wheel_accept"] > 5


# --- the JAX end-to-end tests' scenarios, on the port alone ----------------------

@pytest.mark.slow
@pytest.mark.parametrize("feat_rep", REPS)
def test_slam_features_e2e(feat_rep):
    """tests/test_slam.py's gates over 10 s: >= 3 active slots at some time,
    RMSE < 1.0 m, every checked landmark within 2 m of the truth."""
    sim = Simulator(SimConfig(duration=10.0, seed=1, sigma_pix=0.5, n_pts=45))
    o = EstimatorOptions()
    o.cam.feat_rep, o.cam.max_slam = feat_rep, 8
    o.cam.max_msckf, o.cam.sigma_pix, o.cam.min_track_length, o.cam.chi2_mult = 25, 0.5, 4, 5.0
    s = VioSystem(o, device="cpu")
    examples.live_calibrate(s, sim, float(sim.imu_t[0]))
    max_active = 0
    for kind, args in examples.track_events(sim):
        examples.feed(s, kind, args)
        max_active = max(max_active, int(s._slam_valid.sum()))
    assert max_active >= 3
    errs = [np.linalg.norm(p - sim.gt_kin(t)["p_IinG"]) for t, _, p in s.traj]
    assert float(np.sqrt(np.mean(np.square(errs)))) < 1.0
    st = s.state.to_numpy()
    xyz = cam_helper.rep_to_xyz(_t(st["slam_p"]), s.feat_rep).numpy()
    checked = [np.linalg.norm(xyz[k] - sim.landmarks[st["slam_id"][k]])
               for k in np.flatnonzero(st["slam_valid"]) if st["slam_id"][k] < len(sim.landmarks)]
    assert checked and max(checked) < 2.0, checked


@pytest.mark.slow
def test_live_joint_matches_sequential():
    """tests/test_joint_update.py::test_live_joint_matches_sequential's gates."""
    rmse_j, st_j, _ = examples.joint_update_replay(True, device="cpu")
    rmse_s, st_s, _ = examples.joint_update_replay(False, device="cpu")
    assert st_j["wheel_accept"] > 0 and st_j["line_accept"] > 0
    assert rmse_j < 0.5 and rmse_s < 0.5, (rmse_j, rmse_s)
    assert abs(rmse_j - rmse_s) < 0.5 * max(rmse_j, rmse_s) + 0.02, (rmse_j, rmse_s)
    for k in ("cam_accept", "line_accept", "wheel_accept"):
        assert abs(st_j[k] - st_s[k]) <= max(4, 0.25 * st_s[k]), (k, st_j, st_s)


@pytest.mark.slow
def test_live_joint_slam_gps_parity():
    """tests/test_joint_update.py::test_live_joint_slam_gps_parity's gates,
    with inverse-depth landmarks in the joint run (the GPS init marginalizes
    them)."""
    rmse_j, _, sys_j = examples.joint_update_replay(True, slam=6, gps=True, feat_rep=REPS[1],
                                                    device="cpu")
    rmse_s, _, sys_s = examples.joint_update_replay(False, slam=6, gps=True, device="cpu")
    for s in (sys_j, sys_s):
        assert s.state.slam_valid.any() and s.gps.initialized
    assert rmse_j < 1.0 and rmse_s < 1.0, (rmse_j, rmse_s)
    assert abs(rmse_j - rmse_s) < 0.2 * max(rmse_j, rmse_s) + 0.02, (rmse_j, rmse_s)
