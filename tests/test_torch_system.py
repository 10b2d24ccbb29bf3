"""The port's live driver and its host parts against the JAX package, on the CPU.

`plviwo_tpu_torch.core.system.VioSystem` (B = 1, device="cpu"), its host
buffers, the GPS updater with its 4-DoF init, the option tree, the
trajectory metrics and `run_sim`, against the JAX package's on the same
numpy inputs.  RANSAC's hypotheses in the frame come from JAX's draws
(`JaxDraws`, tests/test_torch_fused_frame.py).

Tolerances: the option tree equal field by field; `geodetic_to_enu`,
`horn_4dof`, `ransac_4dof`, `umeyama`, `ImuBuffer.select`,
`WheelBuffer.select` and the position statistics of `ate` equal exactly
(numpy copies); `ate`'s orientation statistics within 1e-9 deg (the
rotations go through each package's `lie`);
`transform_state_to_enu_marg_trans` within 1e-10 (float64);
`delayed_init` within 1e-12 of max(1, max|x|) against its formulas in
float64 numpy, and within 1e-6 against JAX's: its remaining rows go
through the JAX EKF update, which solves with a float32 factor, one
float64 refinement and split-float32 products (TPU workarounds; 4e-8 off
the float64 result on this input); the GPS updater (delayed init and
per-fix updates) against JAX's with those two workarounds replaced by
their float64 products and solve (`jax_f64_linalg`): state, trajectory
and alignment within 1e-9 of max(1, max|x|), and against JAX's as it
ships within 1e-7 (1.8e-8 measured; JAX wholly in float32 is 3.9e-7 off),
in both its `initialized`, `stats` and pending fixes equal;
`VioSystem.feed_image` frame by frame: `stats`, `clone_keyframe` and `len(traj)` equal, `traj`
positions within 1e-5 and the covariance within 1e-4 max|cov| (the frame
bounds of tests/test_torch_fused_frame.py).  The slow tests hold the port
alone to the gates of tests/test_feed_image.py and
tests/test_gps_fused.py::test_feed_image_with_gps_e2e.
"""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plviwo_tpu.config import options as j_options
from plviwo_tpu.core import ekf as j_ekf
from plviwo_tpu.core.layout import StateLayout as JLayout
from plviwo_tpu.core.propagator import ImuBuffer as JImuBuffer
from plviwo_tpu.core.state import make_state as j_make_state
from plviwo_tpu.core.system import VioSystem as JVioSystem
from plviwo_tpu.eval.align import umeyama as j_umeyama
from plviwo_tpu.eval.metrics import ate as j_ate
from plviwo_tpu.ops.chi2 import _TABLE as J_CHI2
from plviwo_tpu.update import gps as j_gps
from plviwo_tpu.update.wheel import WheelBuffer as JWheelBuffer
from plviwo_tpu_torch import examples, run_sim
from plviwo_tpu_torch.config import options as t_options
from plviwo_tpu_torch.core import ekf
from plviwo_tpu_torch.core.layout import StateLayout
from plviwo_tpu_torch.core.propagator import ImuBuffer
from plviwo_tpu_torch.core.state import FilterState, make_state
from plviwo_tpu_torch.core.system import VioSystem
from plviwo_tpu_torch.eval.align import umeyama
from plviwo_tpu_torch.eval.metrics import ate
from plviwo_tpu_torch.ops import klt, lie
from plviwo_tpu_torch.ops.chi2 import _TABLE as T_CHI2
from plviwo_tpu_torch.sim.simulator import SimConfig, Simulator
from plviwo_tpu_torch.update import gps
from plviwo_tpu_torch.update.wheel import WheelBuffer
from tests.test_torch_fused_frame import JaxDraws, _jax_state_arrays

GPS_LAYOUT = dict(n_clones=8, n_cams=1, use_wheel=True, n_gps=1)


def _tree(obj):
    """A dataclass instance as nested (class name, {field: value})."""
    if dataclasses.is_dataclass(obj):
        return (type(obj).__name__,
                {f.name: _tree(getattr(obj, f.name)) for f in dataclasses.fields(obj)})
    return obj


@pytest.mark.parametrize("name", ["ImuOptions", "CameraOptions", "WheelOptions", "GpsOptions",
                                  "ZuptOptions", "InitOptions", "EstimatorOptions",
                                  "SystemOptions", "Options"])
def test_options_copy_matches_jax(name):
    t_cls, j_cls = getattr(t_options, name), getattr(j_options, name)
    assert ([(f.name, f.type) for f in dataclasses.fields(t_cls)]
            == [(f.name, f.type) for f in dataclasses.fields(j_cls)])
    assert _tree(t_cls()) == _tree(j_cls())
    if name == "EstimatorOptions":
        for hz in (4, 10, 20):
            assert t_cls(clone_freq=hz).max_clones == j_cls(clone_freq=hz).max_clones


def _aligned_clouds(rng, n=24, n_out=5):
    """World points along a curve, their yawed/offset ENU images with noise,
    and n_out gross outliers."""
    a = np.linspace(0.0, 2.5, n)
    p_W = np.stack([12.0 * np.cos(a), 8.0 * np.sin(a), 0.2 * a], 1) + rng.normal(0, 0.1, (n, 3))
    c, s = np.cos(0.7), np.sin(0.7)
    R = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    p_E = p_W @ R.T + np.array([30.0, -12.0, 2.0]) + rng.normal(0, 0.3, (n, 3))
    p_E[rng.choice(n, n_out, replace=False)] += rng.normal(0, 20.0, (n_out, 3))
    return p_W, p_E


def test_gps_and_eval_copies_match_jax():
    rng = np.random.default_rng(0)
    datum = (36.37, 127.36, 50.0)
    for lat, lon, alt in zip(datum[0] + rng.normal(0, 1e-3, 5), datum[1] + rng.normal(0, 1e-3, 5),
                             datum[2] + rng.normal(0, 5, 5)):
        np.testing.assert_array_equal(gps.geodetic_to_enu(lat, lon, alt, datum),
                                      j_gps.geodetic_to_enu(lat, lon, alt, datum))
    p_W, p_E = _aligned_clouds(rng)
    for a, b in zip(gps.horn_4dof(p_W, p_E), j_gps.horn_4dof(p_W, p_E)):
        np.testing.assert_array_equal(a, b)
    for n in (3, 24):  # the Horn-only branch and the consensus branch
        out, want = gps.ransac_4dof(p_W[:n], p_E[:n], 0.9), j_gps.ransac_4dof(p_W[:n], p_E[:n], 0.9)
        for a, b in zip(out, want):
            np.testing.assert_array_equal(a, b)
    assert 3 <= int(out[4].sum()) < 24
    for kw in (dict(yaw_only=True), dict(), dict(with_scale=True)):
        for a, b in zip(umeyama(p_W, p_E, **kw), j_umeyama(p_W, p_E, **kw)):
            np.testing.assert_array_equal(a, b)
    # trajectories: estimate = truth yawed, shifted and noisy; JPL
    # quaternions; the truth's stamps 5 ms off
    t = np.arange(24) * 0.1
    q = np.asarray(lie.quat_norm(torch.as_tensor(rng.normal(size=(24, 4)))))
    q_e = np.asarray(lie.quat_norm(torch.as_tensor(q + rng.normal(0, 0.01, q.shape))))
    for method in ("none", "posyaw", "se3", "sim3"):
        got = ate(t, p_E, q_e, t + 0.005, p_W, q, method=method)
        want = j_ate(t, p_E, q_e, t + 0.005, p_W, q, method=method)
        for k in ("pos", "pos_2d", "align", "n"):
            assert got[k] == want[k], (method, k)
        for k, v in want["ori_deg"].items():
            assert abs(got["ori_deg"][k] - v) <= 1e-9, (method, k)
    # the updater's geodetic feed: datum at the first fix, fixes in ENU
    tu = gps.GpsUpdater(t_options.GpsOptions(), StateLayout(**GPS_LAYOUT), T_CHI2)
    ju = j_gps.GpsUpdater(j_options.GpsOptions(), JLayout(**GPS_LAYOUT), J_CHI2)
    for k in range(3):
        fix = (0.5 * k, datum[0] + 1e-4 * k, datum[1] - 2e-4 * k, datum[2] + k)
        tu.feed_geodetic(*fix)
        ju.feed_geodetic(*fix)
    assert tu.datum == ju.datum
    for (ta, pa), (tb, pb) in zip(tu.pending, ju.pending, strict=True):
        assert ta == tb
        np.testing.assert_array_equal(pa, pb)


def _close(got, want, tol, name=""):
    want = np.asarray(want)
    scale = max(float(np.max(np.abs(want))) if want.size else 0.0, 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale, err_msg=name)


def _same(a, b):
    if a is None or b is None:
        assert a is None and b is None
        return
    for x, y in zip(a, b, strict=True):
        np.testing.assert_array_equal(x, y)


def test_buffers_match_jax():
    """ImuBuffer / WheelBuffer selections on jittered streams: interior,
    boundary-interpolated and exactly-on-a-sample windows, with and without
    padding, padding too short, uncovered and empty windows, after a prune."""
    rng = np.random.default_rng(1)
    t_imu = np.cumsum(rng.uniform(0.003, 0.007, 400))
    t_whl = np.cumsum(rng.uniform(0.008, 0.012, 200))
    bufs = [(ImuBuffer(), JImuBuffer()), (WheelBuffer(), JWheelBuffer())]
    for t in t_imu:
        w, a = rng.normal(size=3), rng.normal(size=3)
        for b in bufs[0]:
            b.feed(t, w, a)
    for t in t_whl:
        m1, m2 = rng.normal(size=2)
        for b in bufs[1]:
            b.feed(t, m1, m2)
    for (tb, jb), ts in zip(bufs, (t_imu, t_whl)):
        windows = [tuple(np.sort(rng.uniform(ts[0], ts[-1], 2))) for _ in range(20)]
        windows += [(ts[10], ts[20]), (ts[10] + 1e-4, ts[12]), (ts[0] - 0.01, ts[5]),
                    (ts[5], ts[-1] + 0.01), (ts[7], ts[7]), (ts[9], ts[3])]
        for t0, t1 in windows:
            for pad in (None, 8, 32, 400):
                _same(tb.select(t0, t1, pad_to=pad), jb.select(t0, t1, pad_to=pad))
        tb.prune(ts[100])
        jb.prune(ts[100])
        np.testing.assert_array_equal(tb.t, jb.t)
        _same(tb.select(ts[101], ts[150], 64), jb.select(ts[101], ts[150], 64))
        _same(tb.select(ts[50], ts[150], 64), jb.select(ts[50], ts[150], 64))
    ti, ji = bufs[0]
    assert (ti.newest, ti.oldest) == (ji.newest, ji.oldest)


def _spd(rng, D, scale=1e-2):
    A = rng.normal(size=(D, 2 * D))
    return scale * (A @ A.T) / (2 * D)


def test_delayed_init_matches_jax():
    rng = np.random.default_rng(2)
    lo = StateLayout(**GPS_LAYOUT)
    D, n = lo.dim, 7
    cov = _spd(rng, D)
    w = lo.wtoe_off
    cov[w:w + 4, :] = cov[:, w:w + 4] = 0.0  # the transform is not in the state yet
    Hx = rng.normal(size=(3 * n, D))
    Hx[:, w:w + 4] = 0.0
    Hn = rng.normal(size=(3 * n, 4))
    r = rng.normal(size=3 * n)
    r_diag = np.full(3 * n, 0.09)
    want = j_ekf.delayed_init(jnp.asarray(cov), jnp.asarray(Hx), jnp.asarray(Hn),
                              jnp.asarray(r), jnp.asarray(r_diag), w, 4)
    got = ekf.delayed_init(*(torch.as_tensor(a)[None] for a in (cov, Hx, Hn, r, r_diag)), w, 4)
    # the JAX function's formulas in float64 numpy
    Q, _ = np.linalg.qr(Hn, mode="complete")
    Hx2, Hn2, r2 = Q.T @ Hx, Q.T @ Hn, Q.T @ r
    Hi = np.linalg.inv(Hn2[:4])
    PxHt = cov @ Hx2[:4].T
    ref = cov.copy()
    ref[:, w:w + 4] = -PxHt @ Hi.T
    ref[w:w + 4, :] = ref[:, w:w + 4].T
    ref[w:w + 4, w:w + 4] = Hi @ (Hx2[:4] @ PxHt + 0.09 * np.eye(4)) @ Hi.T
    ref = 0.5 * (ref + ref.T)
    PHt = ref @ Hx2[4:].T
    K = np.linalg.solve(Hx2[4:] @ PHt + 0.09 * np.eye(3 * n - 4), PHt.T).T
    ref_cov = ref - K @ PHt.T
    for a, b, c in zip(got[:3], want[:3], (0.5 * (ref_cov + ref_cov.T), K @ r2[4:], Hi @ r2[:4])):
        _close(a[0].numpy(), c, 1e-12)
        _close(a[0].numpy(), b, 1e-6)
    assert got[4].shape == (1, 3 * n - 4) and bool(got[5].all())


def _clone_state(rng, layout, n_valid, t0=10.0, dt=0.5):
    """State arrays (numpy, JAX's unbatched shapes) with n_valid clones on an
    arc (yaw along the tangent), a GPS lever arm, a transform guess, and an
    SPD covariance over every block."""
    st = make_state(layout, device="cpu").to_numpy()
    C = layout.n_clones
    for i in range(n_valid):
        a = 0.35 * i
        yaw = a + np.pi / 2
        q = lie.rot_2_quat(torch.as_tensor([[np.cos(yaw), np.sin(yaw), 0.0],
                                            [-np.sin(yaw), np.cos(yaw), 0.0],
                                            [0.0, 0.0, 1.0]])).numpy()
        st["clone_q"][i] = st["clone_q_fej"][i] = q
        st["clone_p"][i] = st["clone_p_fej"][i] = [10 * np.cos(a), 10 * np.sin(a), 0.05 * i]
        st["clone_t"][i] = t0 + dt * i
        st["clone_valid"][i] = True
    st["clone_q_fej"] = lie.quat_norm(torch.as_tensor(
        st["clone_q_fej"] + rng.normal(0, 1e-4, (C, 4)))).numpy()
    st["clone_p_fej"] = st["clone_p_fej"] + rng.normal(0, 1e-3, (C, 3))
    st["clone_keyframe"][:2] = True
    st["q"], st["p"] = st["clone_q"][n_valid - 1], st["clone_p"][n_valid - 1]
    st["q_fej"], st["p_fej"] = st["q"], st["p"]
    st["v"] = st["v_fej"] = np.array([-1.0, 2.0, 0.1])
    st["time"] = np.array(t0 + dt * (n_valid - 1))
    st["gps_p"][0] = [0.0, 0.0, 0.3]
    st["wtoe_th"], st["wtoe_p"] = np.array(0.3), np.array([5.0, -2.0, 0.5])
    cov = _spd(rng, layout.dim, 1e-3)
    off = layout.clone_off
    cov[off:off + 6 * C, off:off + 6 * C] *= 1e2  # clone poses loose
    return st, cov


def _jstate(st, layout):
    return j_make_state(layout).replace(**{k: jnp.asarray(v) for k, v in st.items()})


def test_transform_to_enu_matches_jax():
    rng = np.random.default_rng(3)
    lo = StateLayout(**GPS_LAYOUT)
    st, cov = _clone_state(rng, lo, 6)
    st["cov"] = cov
    want = j_gps.transform_state_to_enu_marg_trans(_jstate(st, JLayout(**GPS_LAYOUT)))
    got = gps.transform_state_to_enu_marg_trans(FilterState.from_numpy(st, lo, "cpu"))
    for k, v in _jax_state_arrays(want).items():
        np.testing.assert_allclose(got.to_numpy()[k], v, rtol=0, atol=1e-10, err_msg=k)


@pytest.fixture
def jax_f64_linalg(monkeypatch):
    """The JAX EKF update's split-float32 products and float32-factor solve
    (TPU workarounds the port does not carry) replaced by the float64
    products and solve they approximate."""
    from plviwo_tpu.ops import linalg

    monkeypatch.setattr(linalg, "dmatmul", lambda a, b: a @ b)
    monkeypatch.setattr(linalg, "solve_psd_refined", lambda S, B, iters=1: jnp.linalg.solve(S, B))


class _System:
    """What GpsUpdater reads and writes of a VioSystem."""

    def __init__(self, state, traj, feat_rep=0):
        self.state, self.traj, self.feat_rep = state, traj, feat_rep


def _gps_case(seed=4):
    """Eight clones 0.5 s apart on a 10 m arc (about 24 m travelled), the
    trajectory recorded at them, and 4 Hz fixes over the window in a
    yawed/offset ENU frame with 0.3 m noise; fix 3 is a gross outlier, fix 6
    is off by 5 m in height only (3-D gate rejects, 2-D accepts)."""
    rng = np.random.default_rng(seed)
    lo = StateLayout(**GPS_LAYOUT)
    st, cov = _clone_state(rng, lo, 8)
    st["wtoe_th"], st["wtoe_p"] = np.array(0.0), np.zeros(3)
    st["cov"] = cov
    w = lo.wtoe_off
    st["cov"][w:w + 4, :] = st["cov"][:, w:w + 4] = 0.0
    traj = [(float(st["clone_t"][i]), st["clone_q"][i].copy(), st["clone_p"][i].copy())
            for i in range(8)]
    c, s = np.cos(0.4), np.sin(0.4)
    R = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    fixes = []
    for k, t in enumerate(10.1 + 0.25 * np.arange(14)):
        i = int((t - 10.0) / 0.5)
        lam = (t - 10.0 - 0.5 * i) / 0.5
        p = (1 - lam) * st["clone_p"][i] + lam * st["clone_p"][i + 1] + [0.0, 0.0, 0.3]
        p_e = R @ p + np.array([40.0, -20.0, 1.0]) + rng.normal(0, 0.3, 3)
        if k == 3:
            p_e = p_e + [25.0, -30.0, 4.0]
        if k == 6:
            p_e = p_e + [0.0, 0.0, 5.0]
        fixes.append((float(t), p_e))
    return lo, st, traj, fixes


def _updater(port, lo):
    opts = (t_options if port else j_options).GpsOptions(noise=0.3, chi2_mult=10.0,
                                                         init_distance=8.0)
    if port:
        return gps.GpsUpdater(opts, lo, T_CHI2)
    return j_gps.GpsUpdater(opts, JLayout(**GPS_LAYOUT), J_CHI2)


@pytest.mark.parametrize("jax_linalg,tol", [("f64", 1e-9), ("as_shipped", 1e-7)])
def test_gps_updater_matches_jax(request, jax_linalg, tol):
    """From one state with clones and a trajectory, the same pending fixes
    through JAX's updater and the port's: `_try_initialize` (RANSAC, the
    delayed init, the rotation into ENU), then `try_process` (per-fix
    updates with the 2-D fallback and a rejection); state, trajectory and
    alignment within tol of max(1, max|x|).  "f64": JAX's updater with
    float64 products and solve.  "as_shipped": JAX's float32-factor solve,
    one float64 refinement and split-float32 products; the port sits
    1.8e-8 from it on this case, and the same JAX updater run wholly in
    float32 sits 3.9e-7 away, so a float32 port fails here."""
    if jax_linalg == "f64":
        request.getfixturevalue("jax_f64_linalg")
    lo, st, traj, fixes = _gps_case()
    systems = [_System(_jstate(st, JLayout(**GPS_LAYOUT)), list(traj)),
               _System(FilterState.from_numpy(st, lo, "cpu"), list(traj))]
    ups = [_updater(False, lo), _updater(True, lo)]
    for u in ups:
        for f in fixes:
            u.feed_enu(*f)
    for u, s in zip(ups, systems):
        u._try_initialize(s, 10.0, 13.5)
        u.try_process(s)
    (ju, tu), (js, ts) = ups, systems
    assert tu.initialized and ju.initialized
    assert tu.stats == ju.stats and tu.stats["fallback2d"] >= 1 and tu.stats["accept"] >= 8
    assert [f[0] for f in tu.pending] == [f[0] for f in ju.pending]
    for a, b in zip(tu.align, ju.align, strict=True):
        _close(a, b, tol)
    for k, v in _jax_state_arrays(js.state).items():
        _close(ts.state.to_numpy()[k], v, tol, k)
    for (ta, qa, pa), (tb, qb, pb) in zip(ts.traj, js.traj, strict=True):
        assert ta == tb
        _close(qa, qb, tol)
        _close(pa, pb, tol)
    _close(tu.init_trans_cov, ju.init_trans_cov, tol)


# --- the live driver -------------------------------------------------------

LIVE_T0, LIVE_FRAMES = 1.0, 6
LIVE_SIM = dict(duration=2.5, n_landmarks=350, n_lines=40, seed=5, sigma_gps=0.3, gps_hz=10.0)


def _small_live(opts):
    examples.live_options(opts, gps=True)
    opts.cam.n_pts, opts.cam.max_lines, opts.cam.fused_max_obs = 32, 8, 4
    return opts


def test_feed_image_matches_jax(monkeypatch):
    """Both drivers through one stream of the port's simulator (the JAX
    one's data, tests/test_torch_fused_frame.py; 640 x 480, lines, wheel,
    10 Hz GPS fixes in a yawed ENU frame that pin keyframes before the 4-DoF
    init, which 8 m of travel would start): after every frame the same
    stats, keyframes and trajectory."""
    monkeypatch.setattr(klt, "draw_hypotheses", JaxDraws())
    sim = Simulator(SimConfig(**LIVE_SIM))
    c, s = np.cos(0.4), np.sin(0.4)
    enu = (np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]]), np.array([40.0, -20.0, 1.0]))
    events = examples.live_events(sim, LIVE_T0, LIVE_FRAMES, enu)
    port = VioSystem(_small_live(t_options.EstimatorOptions()), device="cpu")
    examples.live_calibrate(port, sim, LIVE_T0)
    jsys = JVioSystem(_small_live(j_options.EstimatorOptions()))
    cfg = sim.cfg
    jsys.set_calibration(np.asarray(cfg.intrinsics), np.asarray(cfg.cam_ext_q),
                         np.asarray(cfg.cam_ext_p))
    jsys.set_wheel_calibration(np.asarray(cfg.wheel_ext_q), np.asarray(cfg.wheel_ext_p),
                               [cfg.wheel_rl, cfg.wheel_rr, cfg.wheel_base])
    q0, p0 = sim.gt_pose(LIVE_T0)
    i0 = int(np.searchsorted(sim.imu_t, LIVE_T0))
    jsys.initialize_from(LIVE_T0, q0, p0, sim.gt_kin(LIVE_T0)["v_IinG"], sim.bg_true[i0],
                         sim.ba_true[i0])
    jsys.state = jsys.state.replace(gps_p=jsys.state.gps_p.at[0].set(jnp.asarray(cfg.gps_ext_p)))
    keyframes = n_frames = 0
    for kind, args in events:
        examples.feed(port, kind, args)
        examples.feed(jsys, kind, args)
        assert len(port.traj) == len(jsys.traj)
        if len(jsys.traj) == n_frames:
            continue
        n_frames = len(jsys.traj)
        assert port.stats == jsys.stats
        kf = np.asarray(jsys.state.clone_keyframe)
        np.testing.assert_array_equal(port.state.clone_keyframe[0].numpy(), kf)
        keyframes = max(keyframes, int(kf.sum()))
        for (ta, _, pa), (tb, _, pb) in zip(port.traj, jsys.traj, strict=True):
            assert ta == tb
            np.testing.assert_allclose(pa, np.asarray(pb), rtol=0, atol=1e-5)
        cov = np.asarray(jsys.state.cov)
        assert np.max(np.abs(port.state.cov[0].numpy() - cov)) < 1e-4 * np.max(np.abs(cov))
    assert len(port.traj) == LIVE_FRAMES and keyframes >= 1
    assert port.stats["cam_accept"] > 0 and port.stats["wheel_accept"] > 0
    assert not port.gps.initialized and len(port.gps.pending) > 0


JAX_SUMMARY_KEYS = {"frames", "ate_rmse_m", "max_err_m", "updates", "accept_rate", "wall_s",
                    "fps", "distance_m", "clones", "cam_accept_rate", "line_accept_rate",
                    "wheel_accept_rate"}


def test_run_sim_cli(capsys):
    rc = run_sim.main(["--device", "cpu", "--images", "--lines", "--wheel", "--duration", "1.5"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0
    assert set(out) == JAX_SUMMARY_KEYS | {"device"} and out["device"] == "cpu"
    assert out["frames"] == 13 and out["ate_rmse_m"] < 0.1 and out["cam_accept_rate"] > 0.3


@pytest.mark.parametrize("argv,queue", [
    (["--images", "--dynamic", "--intr-order", "3"], "A9a"), (["--images", "--imu-res"], "A9c"),
    (["--images", "--calib"], "A9a"), (["--images", "--lines", "--plc"], "A9b"),
    (["--images", "--sequential-update"], "A9a")])
def test_run_sim_refuses_unported_modes(capsys, argv, queue):
    assert run_sim.main(["--device", "cpu"] + argv) != 0
    err = capsys.readouterr()
    assert f"ROADMAP {queue}" in err.err and not err.out


def test_feed_image_runs_the_gather_lk():
    """`cam.fused_lk_conv=False`: the images-in frame tracks with the
    gather LK, launching no kernel (its `track_frame` is held to JAX's in
    tests/test_torch_fused_frame.py)."""
    from plviwo_tpu_torch.ops import lk_kernel

    sim = Simulator(SimConfig(**LIVE_SIM))
    opts = _small_live(t_options.EstimatorOptions())
    opts.cam.fused_lk_conv = False
    s = VioSystem(opts, device="cpu")
    examples.live_calibrate(s, sim, LIVE_T0)
    launches = lk_kernel.lk_pyramid.launches
    for kind, args in examples.live_events(sim, LIVE_T0, 4):
        examples.feed(s, kind, args)
    assert len(s.traj) == 4 and int(s.track_state.valid.sum()) > 16
    assert lk_kernel.lk_pyramid.launches == launches


def test_system_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        VioSystem(t_options.EstimatorOptions())


# --- the JAX end-to-end tests' scenarios, on the port alone ------------------

def _live_run(gps, n_frames, enu=None, **sim_kw):
    sim = Simulator(SimConfig(n_landmarks=350, n_lines=40, width=640, height=480, **sim_kw))
    system = VioSystem(examples.live_options(t_options.EstimatorOptions(), gps), device="cpu")
    examples.live_calibrate(system, sim, 1.0)
    for kind, args in examples.live_events(sim, 1.0, n_frames, enu):
        examples.feed(system, kind, args)
    d = system.state.cov[0].diagonal()
    assert bool(torch.isfinite(d).all()) and bool((d > -1e-9).all())
    return sim, system


@pytest.mark.slow
def test_feed_image_e2e_tracks_trajectory():
    """tests/test_feed_image.py's scenario and gates."""
    sim, s = _live_run(False, 40, duration=8.0, seed=3)
    assert s.track_state is not None
    assert s.stats["clones"] >= 35
    assert s.stats["cam_accept"] > 30, s.stats
    assert s.stats["wheel_accept"] > 15, s.stats
    errs = [np.linalg.norm(p - sim.gt_pose(t)[1]) for t, _, p in s.traj]
    assert np.isfinite(errs).all()
    rmse = float(np.sqrt(np.mean(np.square(errs))))
    assert rmse < 0.35, f"feed_image RMSE {rmse:.3f} m"


@pytest.mark.slow
def test_feed_image_with_gps_e2e():
    """tests/test_gps_fused.py::test_feed_image_with_gps_e2e's scenario and
    gates: GPS in a frame yawed by 0.4 rad and offset by (40, -20, 1) m."""
    c, s_ = np.cos(0.4), np.sin(0.4)
    R = np.array([[c, -s_, 0.0], [s_, c, 0.0], [0.0, 0.0, 1.0]])
    t_enu = np.array([40.0, -20.0, 1.0])
    sim, s = _live_run(True, 130, (R, t_enu), duration=16.0, seed=5, sigma_gps=0.3)
    assert s.gps.initialized, "GPS 4-DoF alignment never initialized"
    assert s.stats["gps_fused"] >= 3, s.stats
    errs = [np.linalg.norm(p - (R @ sim.gt_kin(t)["p_IinG"] + t_enu)) for t, _, p in s.traj[-30:]]
    rmse = float(np.sqrt(np.mean(np.square(errs))))
    assert rmse < 1.0, f"fused-GPS aligned RMSE {rmse:.3f} m"
