"""The port's continuous preintegration, ZUPT and auto-initializers against
the JAX package, on the CPU.

`ops.lie.gamma2_so3`, `core.cpi` (`cpi_v1`, `cpi_v2` over padded windows,
with their bias Jacobians, `predict_from_cpi`, `correct_for_bias`),
`core.interp.build_cpi_table`, the static IMU initializer and the
IMU+wheel initializer (numpy copies), `update.wheel.wv_stack_np`, the
zero-velocity updater in `VioSystem.feed_imu`, and `VioSystem`'s per-track
path with `use_imu_res` and with the auto-initialization, frame by frame.
Inputs are numpy arrays drawn from a seed, tests/test_iw_init.py's and
tests/test_zupt.py's streams, or the simulators' streams.

Tolerances: `gamma2_so3` and every per-step stack of `cpi_v1` / `cpi_v2`
(padding and bias Jacobians included), `predict_from_cpi` and
`correct_for_bias` within 1e-12 of max(1, max|x|); padding bit for bit a
no-op; the bias Jacobians within 5e-6 of differences of the integral
(tests/test_cpi.py's bound); `build_cpi_table` within 1e-10; the
initializers' results within 1e-12 with the same smoothness-vote count
after every attempt (both packages compute them in numpy on the host);
`wv_stack_np` exact; ZUPT the same applied and rejected counts and the
velocity within 1e-9 m/s.  The driver, in three modes (mono with
`use_imu_res` and dynamic cloning under a 4 Hz cap, so that most
observations lie between clones; the IMU+wheel auto-initialization with wheel rows; the
static IMU auto-initialization without them), against JAX with its
compression factor keeping a numerically zero Gram diagonal out
(tests/test_torch_per_track.py's `jax_factor_valid_only`): the init time
and `stats` equal after every frame (every gate decision), `len(traj)`
equal, positions within 1e-5 m and the covariance within 1e-3 max|cov|.
The driver reads no device state on an IMU sample before the
initialization, nor on a stationarity test.
The slow tests hold the port alone to tests/test_poly_interp_e2e.py::
test_cpi_interpolation_e2e's gates and to run_sim --wheel --auto-init's
(ATE under 0.1 m, the init at JAX's time).
"""

import contextlib
import io
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plviwo_tpu.config.options import EstimatorOptions as JOptions
from plviwo_tpu.core import cpi as j_cpi
from plviwo_tpu.core import interp as j_interp
from plviwo_tpu.core.system import VioSystem as JVioSystem
from plviwo_tpu.init import imu_wheel as j_iw
from plviwo_tpu.init import static_imu as j_static
from plviwo_tpu.ops import lie as j_lie
from plviwo_tpu.sim.simulator import SimConfig as JSimConfig
from plviwo_tpu.sim.simulator import Simulator as JSimulator
from plviwo_tpu.update import wheel as j_wheel
from plviwo_tpu_torch import examples, run_sim
from plviwo_tpu_torch.config.options import EstimatorOptions
from plviwo_tpu_torch.core import cpi, interp
from plviwo_tpu_torch.core.system import VioSystem
from plviwo_tpu_torch.init import imu_wheel, static_imu
from plviwo_tpu_torch.ops import lie
from plviwo_tpu_torch.sim.simulator import SimConfig, Simulator
from plviwo_tpu_torch.update import wheel
from tests.test_iw_init import _wheel_wv
from tests.test_torch_per_track import (C_RING, _cache_small_compiles,  # noqa: F401
                                        _close, _compare, _ring, _t, jax_factor_valid_only)


# --- gamma2 and the preintegration -------------------------------------------------

@pytest.mark.parametrize("scale", [1e-4, 0.8])
def test_gamma2_so3_matches_jax(scale):
    """Both branches: the Taylor series below the cutoff, the closed form above."""
    w = np.random.default_rng(1).normal(size=(64, 3)) * scale
    _close(lie.gamma2_so3(_t(w)), j_lie.gamma2_so3(jnp.asarray(w)), 1e-12)


def _windows(rng, T=5, N=40):
    """T windows of N IMU samples at ~200 Hz with repeated-last padding of
    different lengths (window i: 8 + 5 i real samples), biases drawn."""
    t = np.cumsum(rng.uniform(0.004, 0.006, (T, N)), axis=1)
    w = rng.normal(0, 0.6, (T, N, 3))
    a = rng.normal(0, 1.0, (T, N, 3)) + [0.0, 0.0, 9.81]
    for i in range(T):
        n = 8 + 5 * i
        t[i, n:], w[i, n:], a[i, n:] = t[i, n - 1], w[i, n - 1], a[i, n - 1]
    return t, w, a, rng.normal(0, 0.01, 3), rng.normal(0, 0.1, 3)


@pytest.mark.parametrize("version", ["cpi_v1", "cpi_v2"])
def test_cpi_matches_jax(version):
    t, w, a, bg, ba = _windows(np.random.default_rng(2))
    got = getattr(cpi, version)(_t(t), _t(w), _t(a), _t(bg), _t(ba))
    for i in range(len(t)):
        want = getattr(j_cpi, version)(*(jnp.asarray(x) for x in (t[i], w[i], a[i], bg, ba)))
        for k in cpi.KEYS:
            _close(got[k][i], want[k], 1e-12, f"{version} {k} window {i}")
    # padding steps are no-ops, bit for bit: window 0 has 8 real samples, so
    # every entry from step 6 on (the state at its last sample) is the same
    for k in cpi.KEYS:
        pad = got[k][0, 6:]
        assert torch.equal(pad, pad[:1].expand_as(pad)), k


@pytest.mark.parametrize("version", ["cpi_v1", "cpi_v2"])
def test_cpi_bias_jacobians_and_prediction(version):
    """correct_for_bias with -d predicts the integral at bias + d (J_q, J_a,
    J_b, H_a, H_b), and predict_from_cpi / correct_for_bias equal JAX's."""
    rng = np.random.default_rng(3)
    t, w, a, bg, ba = _windows(rng, T=1)
    fn = getattr(cpi, version)
    base = {k: v[0, -1] for k, v in fn(_t(t), _t(w), _t(a), _t(bg), _t(ba)).items()}
    eps = 1e-6
    for which in ("bg", "ba"):
        for axis in range(3):
            d = np.zeros(3)
            d[axis] = eps
            pert = fn(_t(t), _t(w), _t(a), _t(bg + d if which == "bg" else bg),
                      _t(ba + d if which == "ba" else ba))
            R, al, be = cpi.correct_for_bias(base, _t(-d if which == "bg" else 0 * d),
                                             _t(-d if which == "ba" else 0 * d))
            _close(al, pert["alpha"][0, -1], 5e-6, f"alpha wrt {which}[{axis}]")
            _close(be, pert["beta"][0, -1], 5e-6, f"beta wrt {which}[{axis}]")
            dR = R @ pert["R_k2tau"][0, -1].T
            assert float(torch.linalg.vector_norm(lie.log_so3(dR))) < 5e-6, (which, axis)
    jbase = {k: v[-1] for k, v in getattr(j_cpi, version)(
        *(jnp.asarray(x) for x in (t[0], w[0], a[0], bg, ba))).items()}
    dbg, dba = rng.normal(0, 1e-3, 3), rng.normal(0, 1e-2, 3)
    for x, y in zip(cpi.correct_for_bias(base, _t(dbg), _t(dba)),
                    j_cpi.correct_for_bias(jbase, jnp.asarray(dbg), jnp.asarray(dba))):
        _close(x, y, 1e-12, "correct_for_bias")
    q = lie.rot_2_quat(lie.exp_so3(_t(rng.normal(size=3)))).numpy()
    p, v, g = rng.normal(size=3), rng.normal(size=3), np.array([0.0, 0.0, 9.81])
    for x, y in zip(cpi.predict_from_cpi(_t(q), _t(p), _t(v), base, _t(g)),
                    j_cpi.predict_from_cpi(*(jnp.asarray(z) for z in (q, p, v)), jbase,
                                           jnp.asarray(g))):
        _close(x, y, 1e-12, "predict_from_cpi")


def test_build_cpi_table_matches_jax():
    rng = np.random.default_rng(4)
    _, q, p, qf, pf = _ring(rng)
    T = 7
    t, w, a, bg, ba = _windows(rng, T=T)
    slot = rng.integers(0, C_RING, T)
    v = rng.normal(0, 2.0, (T, 3))
    g = np.array([0.0, 0.0, 9.81])
    got = interp.build_cpi_table(_t(q)[None], _t(p)[None], _t(qf)[None], _t(pf)[None],
                                 _t(slot, torch.long)[None], _t(v)[None], _t(t)[None],
                                 _t(w)[None], _t(a)[None], _t(bg)[None], _t(ba)[None], _t(g),
                                 n_clones=C_RING)
    want = j_interp.build_cpi_table(*(jnp.asarray(x) for x in (q, p, qf, pf)),
                                    jnp.asarray(slot.astype(np.int32)),
                                    *(jnp.asarray(x) for x in (v, t, w, a, bg, ba, g)),
                                    n_clones=C_RING)
    for name, x, y in zip(("tq", "tp", "tq_f", "tp_f", "tJ", "tJt"), got, want):
        _close(x[0], y, 1e-10, name)


# --- the initializers ------------------------------------------------------------

def _same_result(got, want):
    assert (got is None) == (want is None)
    if got is not None:
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-12, err_msg=k)


def _static_stream():
    """tests/test_iw_init.py::test_static_init_zero_wheel's streams."""
    rng = np.random.default_rng(0)
    n, hz = 600, 200.0
    imu_t = np.arange(n) / hz
    imu_w = np.array([0.002, -0.001, 0.003]) + rng.normal(0, 1e-4, (n, 3))
    imu_a = np.array([0.05, -0.03, 0.02]) + [0, 0, 9.81] + rng.normal(0, 1e-3, (n, 3))
    wheel_t = np.arange(0, n // 2) / 100.0
    zero = np.zeros((len(wheel_t), 3))
    return imu_t, imu_w, imu_a, wheel_t, zero, zero, np.arange(1.2, 3.0, 0.2), {}


def _dynamic_stream():
    """tests/test_iw_init.py::test_dynamic_init_recovers_biases_and_gravity's."""
    cfg = JSimConfig(duration=8.0, seed=5)
    sim = JSimulator(cfg)
    imu_t, imu_w, imu_a = sim.imu_stream()
    wheel_t = sim.wheel_times()
    wv = [_wheel_wv(sim, t) for t in wheel_t]
    R_OtoI = np.asarray(j_lie.quat_2_rot(jnp.asarray(cfg.wheel_ext_q))).T
    kw = dict(gravity_mag=9.81, threshold=0.5, window_time=1.0, R_OtoI=R_OtoI,
              p_IinO=np.asarray(cfg.wheel_ext_p))
    return (imu_t, imu_w, imu_a, wheel_t, np.stack([x for x, _ in wv]),
            np.stack([y for _, y in wv]), np.arange(1.2, 6.0, 0.25), kw)


@pytest.mark.parametrize("path", ["static", "dongsi"])
def test_iw_initializer_matches_jax(path):
    """Both paths of IwInitializer (zero wheels; Dong-Si on a moving start)
    on growing windows: every attempt's result and vote count as JAX's, and
    the vote passes; on the static stream also `try_static_init`."""
    imu_t, imu_w, imu_a, wheel_t, ww, wv, ends, kw = (_static_stream() if path == "static"
                                                      else _dynamic_stream())
    port, ref = imu_wheel.IwInitializer(**kw), j_iw.IwInitializer(**kw)
    done = False
    for t_end in ends:
        i, j = int(np.searchsorted(imu_t, t_end)), int(np.searchsorted(wheel_t, t_end))
        args = (imu_t[:i], imu_w[:i], imu_a[:i], wheel_t[:j], ww[:j], wv[:j])
        got, want = port.try_init(*args), ref.try_init(*args)
        _same_result(got, want)
        assert port.cnt_smooth == ref.cnt_smooth
        if path == "static":
            sargs = (imu_t[:i], imu_w[:i], imu_a[:i], 1.0, 1.0, 9.81)
            _same_result(static_imu.try_static_init(*sargs, require_excitation=False),
                         j_static.try_static_init(*sargs, require_excitation=False))
        if want is not None:
            done = True
            break
    assert done
    g = np.array([0.1, -0.2, 9.7])
    np.testing.assert_array_equal(imu_wheel.gram_schmidt_from_gravity(g),
                                  j_iw.gram_schmidt_from_gravity(g))


@pytest.mark.parametrize("type_code", [wheel.W3D_ANG, wheel.W2D_LIN, wheel.W2D_CEN])
def test_wv_stack_np_matches_jax(type_code):
    rng = np.random.default_rng(type_code)
    m1, m2, intr = rng.normal(size=20), rng.normal(size=20), [0.31, 0.32, 1.5]
    for x, y in zip(wheel.wv_stack_np(m1, m2, intr, type_code),
                    j_wheel.wv_stack_np(m1, m2, intr, type_code)):
        np.testing.assert_array_equal(x, y)


# --- ZUPT ------------------------------------------------------------------------

def _zupt_run(system, moving):
    """tests/test_zupt.py's two streams: a stationary IMU from a wrong start
    velocity of 0.2 m/s, or a turning, accelerating one."""
    rng = np.random.default_rng(0)
    system.initialize_from(0.0, [0, 0, 0, 1.0], np.zeros(3),
                           np.zeros(3) if moving else [0.2, 0.0, 0.0], np.zeros(3), np.zeros(3))
    for i in range(1, 150) if moving else range(200):
        t = i / 200.0
        if moving:
            w, a = np.array([0.0, 0.0, 0.5]), np.array([0.5, 0, 9.81])
        else:
            w = rng.normal(0, 1e-4, 3)
            a = np.array([0, 0, 9.81]) + rng.normal(0, 5e-3, 3)
        system.feed_imu(t, w, a)
    return system


@pytest.mark.parametrize("moving", [False, True])
def test_zupt_matches_jax(moving):
    def options(o):
        o.zupt.enabled = True
        if not moving:
            o.imu.init_cov_vel = 0.3  # an honest prior for the injected 0.2 m/s
        return o

    port = _zupt_run(VioSystem(options(EstimatorOptions()), device="cpu"), moving)
    ref = _zupt_run(JVioSystem(options(JOptions())), moving)
    assert port.zupt.stats == ref.zupt.stats
    assert port.final_report()["zupt"] == ref.final_report()["zupt"]
    np.testing.assert_allclose(port.state.v[0].numpy(), np.asarray(ref.state.v), rtol=0,
                               atol=1e-9)
    if moving:
        assert port.zupt.stats["applied"] == 0
    else:
        assert port.zupt.stats["applied"] > 0 and np.linalg.norm(port.state.v[0].numpy()) < 0.05
        # the stationarity test reads no device state: one read per attempt
        assert port.host_reads == sum(port.zupt.stats.values())


# --- the driver with use_imu_res and with the auto-initialization ------------------

DRIVER_MODES = ("imu_res", "auto_init_wheel", "auto_init_static")


def _drive(mode, port):
    """One mode through the port's or JAX's VioSystem (tests/test_e2e_vio.py's
    options; with the wheel, run_sim's wheel settings); returns (system, per
    frame (stats, position, covariance))."""
    auto = mode.startswith("auto_init")
    use_wheel = mode == "auto_init_wheel"
    sim_kw = dict(duration=2.5 if auto else 2.0, seed=3, sigma_pix=0.5, n_pts=45)
    sim = Simulator(SimConfig(**sim_kw)) if port else JSimulator(JSimConfig(**sim_kw))
    o = EstimatorOptions() if port else JOptions()
    o.window_size, o.clone_freq = 1.0, 10
    o.cam.n_pts, o.cam.max_msckf, o.cam.sigma_pix = 60, 30, 0.5
    o.cam.min_track_length, o.cam.chi2_mult = 4, 5.0
    if mode == "imu_res":  # clones at most at 4 Hz: most observations lie between clones
        o.use_imu_res, o.dynamic_cloning, o.clone_freq = True, True, 4
    if use_wheel:
        w = o.wheel
        w.enabled, w.type, w.chi2_mult = True, "Wheel3DAng", 10.0
        w.noise_w, w.noise_v, w.noise_p = 0.05, 0.05, 0.02
    if port:
        system = VioSystem(o, device="cpu")
    else:
        system = JVioSystem(o)
        system.fdb_native = None
    events = examples.track_events(sim, wheel=use_wheel)
    c = sim.cfg
    system.set_calibration(np.asarray(c.intrinsics), np.asarray(c.cam_ext_q),
                           np.asarray(c.cam_ext_p))
    if use_wheel:
        system.set_wheel_calibration(c.wheel_ext_q, c.wheel_ext_p,
                                     [c.wheel_rl, c.wheel_rr, c.wheel_base])
    if not auto:
        t0 = float(sim.imu_t[0])
        kin = sim.gt_kin(t0)
        q0 = lie.rot_2_quat(_t(kin["R_GtoI"])).numpy()
        system.initialize_from(t0, q0, kin["p_IinG"], kin["v_IinG"], sim.bg_true[0],
                               sim.ba_true[0])
    frames, reads_before_init = [], 0
    for kind, args in events:
        n = len(system.traj)
        examples.feed(system, kind, args)
        if port and not system.initialized:
            reads_before_init = system.host_reads
        if len(system.traj) > n:
            cov = system.state.cov[0].numpy() if port else np.asarray(system.state.cov)
            frames.append((dict(system.stats), np.array(system.traj[-1][2]), cov))
    return system, frames, reads_before_init


@pytest.mark.parametrize("mode", DRIVER_MODES)
def test_driver_matches_jax(jax_factor_valid_only, mode):
    jsys, want, _ = _drive(mode, port=False)
    port, got, reads = _drive(mode, port=True)
    _compare(got, want, 1e-5, 1e-3)
    assert len(port.traj) == len(jsys.traj) > 5 and port.stats == jsys.stats
    # the static init assumes v = 0 on a moving start (ROADMAP C), so few
    # features pass the gate in either package
    assert port.stats["cam_accept"] > (0 if mode == "auto_init_static" else 20)
    if mode.startswith("auto_init"):
        assert port.traj[0][0] == jsys.traj[0][0] and port.startup_time == jsys.startup_time
        assert reads == 0  # no device read on an IMU sample before the initialization
    if mode == "imu_res":
        assert len(port.clone_wv) > 0


def _run_main(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = run_sim.main(["--device", "cpu"] + argv)
    return rc, json.loads(buf.getvalue().strip().splitlines()[-1])


def test_run_sim_auto_init_imu_res():
    rc, out = _run_main(["--duration", "2", "--wheel", "--auto-init", "--imu-res"])
    assert rc == 0 and out["frames"] >= 5 and out["ate_rmse_m"] < 0.1


# --- the JAX end-to-end gates, on the port alone ---------------------------------

@pytest.mark.slow
def test_cpi_interpolation_e2e():
    """tests/test_poly_interp_e2e.py::test_cpi_interpolation_e2e's gates."""
    rc, out = _run_main(["--duration", "8", "--seed", "3", "--imu-res"])
    assert rc == 0 and out["ate_rmse_m"] < 0.2 and out["cam_accept_rate"] > 0.5, out


@pytest.mark.slow
def test_wheel_auto_init_e2e():
    """run_sim --wheel --auto-init (8 s, seed 3): JAX's driver reads ATE
    0.0339 m after its IMU+wheel init; the port within 0.1 m."""
    rc, out = _run_main(["--duration", "8", "--seed", "3", "--wheel", "--auto-init"])
    assert rc == 0 and out["ate_rmse_m"] < 0.1, out
