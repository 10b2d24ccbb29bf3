"""The port's stereo and dynamic cloning against the JAX package, on the CPU.

Dynamic cloning: `core.step._bound_times`, the closed-form Jacobian of the
interpolated pose (`core.interp.interpolate_rotation_jacobian`),
`update.cam_helper.point_systems_interp_batch`,
`core.step._camera_msckf_rows_interp`, `core.dynamic_cloning`,
`core.frame.fused_frame(use_dynamic=True)` with a per-sequence clone
pattern and `VioSystem` with `opts.dynamic_cloning`.  Stereo: the
simulator's right camera, `update.cam_helper.point_systems_batch_multicam`,
`core.step._camera_msckf_rows_stereo`, `core.frame.track_frame(img_r=...)`,
`fused_frame(use_stereo=True)` and `VioSystem.feed_image(t, img, img_r)`.
Inputs are made with numpy from a seed (or rendered by the simulators);
RANSAC's draws are JAX's, replayed (`JaxDraws`,
tests/test_torch_fused_frame.py).  The row builders' gate is the port's
plain gate/Gram, held to JAX's XLA gate.

Tolerances: `_bound_times` slots, coverage and fractions equal (ties
included); the interpolated rotation's Jacobians within 1e-10 of
`jax.jacfwd` (float64); the interp and multicam systems within 1e-9
(float64); the rows' `accepted` equal and G, c within 1e-4 of max|G|,
max|c| (float32 camera tensors: the port whitens each row by 1/sigma in
float32 before the gate, JAX divides the projected rows' Gram by sigma^2
in float64); the rate policy equal; the right camera's frames within
1e-6; track_frame's right fields `rvalid`, `hist_rvalid` and the right
harvest mask equal, and where a right observation is valid `uv_r`/
`hist_uv_r` within 1e-3 px and `hist_uvn_r` within 1e-6 (the bounds of the
left fields in tests/test_torch_fused_frame.py; where the L->R track
failed, LK has run off by up to hundreds of pixels, rounding moves that
end point by up to 1e-2 px, and no row reads it); fused_frame's counts equal per frame,
max|dp| < 1e-5 and max|dcov| < 1e-4 max|cov|; the driver's `stats` and
`len(traj)` equal after every frame and positions within 1e-5; without
lines (the stereo scenario) `stats["line_reject"]` is left out: JAX's
driver runs its line front-end all the same and counts every line it
harvests as a rejected line row, and the port skips that front-end when
line rows are off (a known difference since the lines were ported).  The slow
tests hold the port alone to the gates of tests/test_stereo_fused.py and
tests/test_dynamic_fused.py.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plviwo_tpu.config import options as j_options
from plviwo_tpu.core import dynamic_cloning as j_dyn
from plviwo_tpu.core.frame import fused_frame as j_fused_frame
from plviwo_tpu.core.frame import make_track_state as j_make_track_state
from plviwo_tpu.core.frame import track_frame as j_track_frame
from plviwo_tpu.core.interp import interpolate_pose_linear as j_interp
from plviwo_tpu.core.layout import StateLayout as JLayout
from plviwo_tpu.core.state import make_state as j_make_state
from plviwo_tpu.core.step import _bound_times as j_bound_times
from plviwo_tpu.core.step import _camera_msckf_rows_interp as j_rows_interp
from plviwo_tpu.core.step import _camera_msckf_rows_stereo as j_rows_stereo
from plviwo_tpu.core.system import VioSystem as JVioSystem
from plviwo_tpu.ops import lie as j_lie
from plviwo_tpu.sim.simulator import SimConfig as JSimConfig
from plviwo_tpu.sim.simulator import Simulator as JSimulator
from plviwo_tpu.update import cam_helper as j_cam_helper
from plviwo_tpu_torch import examples
from plviwo_tpu_torch.config import options as t_options
from plviwo_tpu_torch.core import dynamic_cloning, frame
from plviwo_tpu_torch.core.interp import interpolate_rotation_jacobian
from plviwo_tpu_torch.core.layout import StateLayout
from plviwo_tpu_torch.core.state import FilterState, make_state
from plviwo_tpu_torch.core.step import (_bound_times, _camera_msckf_rows_interp,
                                        _camera_msckf_rows_stereo)
from plviwo_tpu_torch.core.system import VioSystem
from plviwo_tpu_torch.ops import cam as cam_ops
from plviwo_tpu_torch.ops import klt, lie
from plviwo_tpu_torch.sim.simulator import SimConfig, Simulator
from plviwo_tpu_torch.update import cam_helper
from tests.test_fused_frame import _imu_window, _seed_state, _wheel_window
from tests.test_torch_fused_frame import JaxDraws, _assert_frame_close, _jax_state_arrays

torch.set_num_threads(1)
F64 = torch.float64
T0 = 1.0
SIGMAS = (1.7e-4, 2.0e-3, 1.9e-5, 3.0e-3)
WHEEL_NOISE = (0.05, 0.05, 0.02)


def _t(a):
    return torch.as_tensor(np.asarray(a))


# --- dynamic cloning: bracketing, the interpolated pose's Jacobian, rows -----

def test_bound_times_matches_jax():
    """Times before, between, at and after the clones of a ring with an
    invalid slot, two slots of equal time and one sequence with no valid
    clone: slots, coverage and fractions equal JAX's."""
    ct = np.array([[0.3, 0.1, 0.2, 0.2, 0.5, 9.0], [0.3, 0.1, 0.2, 0.2, 0.5, 9.0],
                   [0.0, 0.1, 0.2, 0.3, 0.4, 0.5]])
    cv = np.array([[True, True, True, True, True, False], [True, True, False, True, True, True],
                   [False] * 6])
    ts = np.array([[0.05, 0.1, 0.15, 0.2, 0.25, 0.3, 0.45, 0.5, 0.6]] * 3)
    ts[1, 0] = 8.0
    got = _bound_times(types.SimpleNamespace(clone_t=_t(ct), clone_valid=_t(cv)),
                       _t(ts).reshape(3, 3, 3))
    for b in range(3):
        want = j_bound_times(types.SimpleNamespace(clone_t=jnp.asarray(ct[b]),
                                                   clone_valid=jnp.asarray(cv[b])),
                             jnp.asarray(ts[b]).reshape(3, 3))
        s0, s1, lam, cov = (np.asarray(w) for w in want)
        np.testing.assert_array_equal(got[3][b].numpy(), cov, err_msg=f"{b} covered")
        np.testing.assert_array_equal(got[0][b].numpy(), s0, err_msg=f"{b} slot0")
        np.testing.assert_array_equal(got[1][b].numpy(), s1, err_msg=f"{b} slot1")
        np.testing.assert_array_equal(got[2][b].numpy()[cov], lam[cov], err_msg=f"{b} lam")
    assert got[3][0].any() and not got[3][0].all() and not got[3][2].any()


def _unit_quats(rng, n):
    q = rng.normal(size=(n, 4))
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def test_interpolated_rotation_jacobian_matches_jacfwd():
    """psi = log(R(lam)' R(lam)^T) with respect to both clones' JPL attitude
    errors, by jax.jacfwd through JAX's interpolation, against the closed
    form: arbitrary relative rotations, small ones down to 1e-9 rad, and
    lam at 0, 1 and between."""
    rng = np.random.default_rng(0)
    q0 = _unit_quats(rng, 7)
    q1 = _unit_quats(rng, 7)
    for i, ang in zip(range(3, 7), (1e-1, 1e-4, 1e-9, 0.0)):
        d = np.r_[0.5 * ang * rng.normal(size=3), 1.0]
        q1[i] = np.asarray(j_lie.quat_multiply(jnp.asarray(d / np.linalg.norm(d)),
                                               jnp.asarray(q0[i])))
    lam = np.array([0.0, 0.3, 1.0, 0.5, 0.7, 0.2, 0.9])
    R, J0, J1 = interpolate_rotation_jacobian(_t(q0), _t(q1), _t(lam))

    def psi(a, b, q0, q1, lm):
        z = jnp.zeros(3)
        dq0 = j_lie.quat_norm(jnp.concatenate([0.5 * a, jnp.ones(1)]))
        dq1 = j_lie.quat_norm(jnp.concatenate([0.5 * b, jnp.ones(1)]))
        Rp, _ = j_interp(j_lie.quat_multiply(dq0, q0), z, j_lie.quat_multiply(dq1, q1), z, lm)
        return j_lie.log_so3(Rp @ j_interp(q0, z, q1, z, lm)[0].T)

    jac = jax.jit(jax.jacfwd(psi, argnums=(0, 1)))
    for i in range(len(lam)):
        want = jac(jnp.zeros(3), jnp.zeros(3), jnp.asarray(q0[i]), jnp.asarray(q1[i]), lam[i])
        np.testing.assert_allclose(J0[i].numpy(), np.asarray(want[0]), rtol=0, atol=1e-10)
        np.testing.assert_allclose(J1[i].numpy(), np.asarray(want[1]), rtol=0, atol=1e-10)
        Rj = j_interp(jnp.asarray(q0[i]), jnp.zeros(3), jnp.asarray(q1[i]), jnp.zeros(3),
                      lam[i])[0]
        np.testing.assert_allclose(R[i].numpy(), np.asarray(Rj), rtol=0, atol=1e-12)


def _clone_ring(rng, B, C):
    """B clone rings of C poses along a gently turning path (float64
    numpy), their FEJ values a little off, and the camera of the
    simulator (left and right)."""
    c = SimConfig()
    out = []
    for b in range(B):
        th = 0.04 * np.arange(C) + 0.1 * b
        q = np.stack([0.02 * rng.normal(size=C), 0.02 * rng.normal(size=C), np.sin(th / 2),
                      np.cos(th / 2)], -1)
        q /= np.linalg.norm(q, axis=-1, keepdims=True)
        p = np.stack([0.3 * np.arange(C), 0.05 * rng.normal(size=C), 0.02 * rng.normal(size=C)],
                     -1)
        qf = q + 1e-4 * rng.normal(size=q.shape)
        out.append(dict(clone_q=q, clone_p=p,
                        clone_q_fej=qf / np.linalg.norm(qf, axis=-1, keepdims=True),
                        clone_p_fej=p + 1e-3 * rng.normal(size=p.shape)))
    cams = dict(cam_q=np.array([c.cam_ext_q] * 2), cam_p=np.array(
        [c.cam_ext_p, np.asarray(c.cam_ext_p) + [-c.stereo_baseline, 0.0, 0.0]]),
        cam_k=np.array([c.intrinsics] * 2))
    return out, cams


SYS_SHAPE = dict(B=2, F=5, O=4, C=6, clone_off=21, D=21 + 36 + 4)


def test_point_systems_interp_batch_matches_jax():
    """Random features and observations bracketed by two clone slots each
    (equal slots among them), B = 2 sequences against JAX's per-sequence
    `point_systems_interp_batch` (jax.jacfwd): Hx, Hf, r, rowmask."""
    rng = np.random.default_rng(1)
    B, F, O, C, off, D = SYS_SHAPE.values()
    rings, cams = _clone_ring(rng, B, C)
    s0 = rng.integers(0, C - 1, size=(B, F, O))
    s1 = np.minimum(s0 + rng.integers(0, 2, size=(B, F, O)), C - 1)
    lam = np.where(s0 == s1, 0.0, rng.uniform(size=(B, F, O)))
    p_f = np.stack([6.0 + rng.normal(size=(B, F)), rng.normal(size=(B, F)),
                    rng.normal(size=(B, F))], -1)
    uv = rng.uniform(100, 500, size=(B, F, O, 2))
    valid = rng.uniform(size=(B, F, O)) < 0.8
    ring = {k: _t(np.stack([r[k] for r in rings])) for k in rings[0]}
    got = cam_helper.point_systems_interp_batch(
        _t(p_f), _t(uv), _t(s0), _t(s1), _t(lam), _t(valid), ring["clone_q"], ring["clone_p"],
        ring["clone_q_fej"], ring["clone_p_fej"], _t(cams["cam_q"][:1]).expand(B, 4),
        _t(cams["cam_p"][:1]).expand(B, 3), _t(cams["cam_k"][:1]).expand(B, 8), 0, C, off, D)
    for b in range(B):
        r = rings[b]
        want = j_cam_helper.point_systems_interp_batch(
            jnp.asarray(p_f[b]), jnp.asarray(uv[b]), jnp.asarray(s0[b]), jnp.asarray(s1[b]),
            jnp.asarray(lam[b]), jnp.asarray(valid[b]), *(jnp.asarray(r[k]) for k in (
                "clone_q", "clone_p", "clone_q_fej", "clone_p_fej")),
            *(jnp.asarray(cams[k][0]) for k in ("cam_q", "cam_p", "cam_k")), 0, C, off, D)
        for name, g, w in zip(("Hx", "Hf", "r"), got, want):
            np.testing.assert_allclose(g[b].numpy(), np.asarray(w), rtol=0, atol=1e-9,
                                       err_msg=f"{b} {name}")
        np.testing.assert_array_equal(got[3][b].numpy(), np.asarray(want[3]))
    assert (s0 == s1).any() and got[0].abs().max() > 1.0


def test_point_systems_batch_multicam_matches_jax():
    """Random features with a camera index per observation (left and
    right, as the stereo rows concatenate them), B = 2 against JAX's
    per-sequence `point_systems_batch_multicam`."""
    rng = np.random.default_rng(2)
    B, F, O, C, off, D = SYS_SHAPE.values()
    rings, cams = _clone_ring(rng, B, C)
    slot = rng.integers(0, C, size=(B, F, O))
    cam = rng.integers(0, 2, size=(B, F, O))
    p_f = np.stack([6.0 + rng.normal(size=(B, F)), rng.normal(size=(B, F)),
                    rng.normal(size=(B, F))], -1)
    uv = rng.uniform(100, 500, size=(B, F, O, 2))
    valid = rng.uniform(size=(B, F, O)) < 0.8
    ring = {k: _t(np.stack([r[k] for r in rings])) for k in rings[0]}
    cam_t = {k: _t(v)[None].expand((B,) + v.shape) for k, v in cams.items()}
    got = cam_helper.point_systems_batch_multicam(
        _t(p_f), _t(uv), _t(slot), _t(cam), _t(valid), ring["clone_q"], ring["clone_p"],
        ring["clone_q_fej"], ring["clone_p_fej"], cam_t["cam_q"], cam_t["cam_p"],
        cam_t["cam_k"], 0, C, off, D)
    for b in range(B):
        r = rings[b]
        want = j_cam_helper.point_systems_batch_multicam(
            jnp.asarray(p_f[b]), jnp.asarray(uv[b]), jnp.asarray(slot[b]), jnp.asarray(cam[b]),
            jnp.asarray(valid[b]), *(jnp.asarray(r[k]) for k in (
                "clone_q", "clone_p", "clone_q_fej", "clone_p_fej")),
            *(jnp.asarray(cams[k]) for k in ("cam_q", "cam_p", "cam_k")), 0, C, off, D)
        for name, g, w in zip(("Hx", "Hf", "r"), got, want):
            np.testing.assert_allclose(g[b].numpy(), np.asarray(w), rtol=0, atol=1e-9,
                                       err_msg=f"{b} {name}")
        np.testing.assert_array_equal(got[3][b].numpy(), np.asarray(want[3]))


def _rows_scene(n_cams, B=2, C=6, F=40, O=5, interp=False):
    """States of B sequences whose clones sit on the simulator's ground
    truth at 0.1 s steps (sequence b shifted by 2 cm), and noisy
    observations of its landmarks: at clone times (stereo: left and right
    series), or with interp between and at clone times.  Returns (JAX
    states, the port's batch-first state, observation arrays (B,F,O,...))."""
    sim = Simulator(SimConfig(duration=3.0, n_landmarks=350, seed=4))
    c = sim.cfg
    rng = np.random.default_rng(5)
    layout = dict(n_clones=C, n_cams=n_cams, use_wheel=True)
    base = make_state(StateLayout(**layout), priors={
        "imu_th": 1e-3, "imu_p": 1e-3, "imu_v": 1e-2, "imu_bg": 1e-3, "imu_ba": 1e-2},
        device="cpu").to_numpy()
    tc = T0 + 0.1 * np.arange(C)
    t_obs = tc[:O] + (0.05 * (np.arange(O) % 2) if interp else 0.0)
    cam_p = [np.asarray(c.cam_ext_p), np.asarray(c.cam_ext_p) + [-c.stereo_baseline, 0, 0]]
    k = _t(c.intrinsics)
    seqs, obs = [], []
    for b in range(B):
        st = {key: v.copy() for key, v in base.items()}
        poses = [sim.gt_pose(t) for t in tc]
        q = np.stack([q for q, _ in poses])
        p = np.stack([p for _, p in poses]) + 0.02 * b
        st.update(clone_q=q, clone_p=p, clone_q_fej=q, clone_p_fej=p + 1e-3, clone_t=tc.copy(),
                  clone_valid=np.ones(C, bool), time=np.array(tc[-1]),
                  cam_q=np.array([c.cam_ext_q] * n_cams), cam_p=np.stack(cam_p[:n_cams]),
                  cam_k=np.array([c.intrinsics] * n_cams))
        for i in range(C):
            s = StateLayout(**layout).clone(i)
            st["cov"][s:s + 6, s:s + 6] = np.diag([1e-6] * 3 + [1e-4] * 3)
        seqs.append(st)
        per_cam = []
        for ci in range(n_cams):
            uvs = []
            for t in t_obs:
                qt, pt = sim.gt_pose(t)
                R_GtoC = lie.quat_2_rot(_t(c.cam_ext_q)).numpy() @ lie.quat_2_rot(_t(qt)).numpy()
                p_C = (sim.landmarks - pt - 0.02 * b) @ R_GtoC.T + cam_p[ci]
                uv = cam_ops.project(_t(p_C), k, 0).numpy()
                uvs.append(np.where(p_C[:, 2:] > 1.0, uv, -1.0))  # behind: out of view
            per_cam.append(np.stack(uvs, 1))  # (n_landmarks, O, 2)
        obs.append(per_cam)
    # landmarks seen in front of every camera at every time, the first F
    seen = np.ones(len(sim.landmarks), bool)
    for per_cam in obs:
        for uv in per_cam:
            seen &= np.all((uv > 20) & (uv < [c.width - 20, c.height - 20]), axis=(1, 2))
    idx = np.nonzero(seen)[0][:F]
    assert len(idx) == F
    uv = np.stack([[cam_uv[idx] + rng.normal(0, 0.7, cam_uv[idx].shape) for cam_uv in per_cam]
                   for per_cam in obs])  # (B,n_cams,F,O,2)
    uv[:, 0, :3] += 25.0  # three outliers per sequence
    uvn = cam_ops.undistort(_t(uv), k, 0).numpy()
    valid = rng.uniform(size=(B, n_cams, F, O)) < 0.9
    slot = np.broadcast_to(np.arange(O), (B, F, O)).copy()
    js = j_make_state(JLayout(**layout))
    jstates = [js.replace(**{key: jnp.asarray(v) for key, v in st.items()}) for st in seqs]
    return (jstates, FilterState.from_numpy(seqs, StateLayout(**layout), "cpu"),
            dict(uv=uv.astype(np.float32), uvn=uvn.astype(np.float32), valid=valid, slot=slot,
                 t=np.broadcast_to(t_obs, (B, F, O)).copy()))


def _assert_rows_close(got, want, b):
    """The port's (G, c, metrics) against JAX's (G, c, None, metrics)."""
    assert int(got[2]["accepted"][b]) == int(want[3]["accepted"]), b
    for g, w in zip(got[:2], want[:2]):
        w = np.asarray(w)
        np.testing.assert_allclose(g[b].numpy(), w, rtol=0, atol=1e-4 * np.abs(w).max())


def test_camera_msckf_rows_interp_matches_jax():
    """Observations between and at clone times, three outliers a
    sequence: the port's interpolated rows through its plain gate/Gram
    against JAX's through its XLA gate, B = 2."""
    jstates, state, o = _rows_scene(1, interp=True)
    args = (o["uv"][:, 0], o["uvn"][:, 0], o["t"], o["valid"][:, 0])
    got = _camera_msckf_rows_interp(state, *(_t(a) for a in args), 1.5, 8.0, 0, torch.float32)
    for b, js in enumerate(jstates):
        want = j_rows_interp(js, *(jnp.asarray(a[b], jnp.float64) for a in args[:3]),
                             jnp.asarray(args[3][b]), 1.5, 8.0, 0, jnp.float32, as_gram=True)
        _assert_rows_close(got, want, b)
    assert 0 < int(got[2]["accepted"].min()) and int(got[2]["accepted"].max()) < 40


def test_camera_msckf_rows_stereo_matches_jax():
    """Left and right series at clone times, three outliers a sequence:
    the port's stereo rows (M = 4 O) through its plain gate/Gram against
    JAX's through its XLA gate, B = 2."""
    jstates, state, o = _rows_scene(2)
    left = (o["uv"][:, 0], o["uvn"][:, 0], o["slot"], o["valid"][:, 0])
    right = (o["uv"][:, 1], o["uvn"][:, 1], o["valid"][:, 1] & o["valid"][:, 0])
    got = _camera_msckf_rows_stereo(state, *(_t(a) for a in left + right), 1.5, 8.0, 0,
                                    torch.float32)
    for b, js in enumerate(jstates):
        jl = [jnp.asarray(a[b]) for a in left + right]
        for i in (0, 1, 4, 5):
            jl[i] = jl[i].astype(jnp.float64)
        want = j_rows_stereo(js, *jl, 1.5, 8.0, 0, jnp.float32, as_gram=True)
        _assert_rows_close(got, want, b)
    assert 0 < int(got[2]["accepted"].min()) and int(got[2]["accepted"].max()) < 40


def test_rate_policy_copy_matches_jax():
    """The rate policy's copy: accelerations from an IMU stream, the clone
    rate and the (rate, order) pair over a sweep of accelerations, and the
    interpolation noise, equal to JAX's."""
    sim = Simulator(SimConfig(duration=4.0, seed=3))
    t, w, a = sim.imu_stream()
    for n in (3, 20, 150, len(t)):
        assert (dynamic_cloning.estimate_accelerations(t[:n], w[:n], a[:n])
                == j_dyn.estimate_accelerations(t[:n], w[:n], a[:n]))
    for acc in (0.0, 0.05, 0.3, 1.0, 3.0, 20.0, 500.0):
        for hz in (4.0, 10.0, 30.0):
            assert (dynamic_cloning.select_clone_rate(acc, 0.1, 1, max_hz=hz)
                    == j_dyn.select_clone_rate(acc, 0.1, 1, max_hz=hz))
            assert (dynamic_cloning.select_rate_and_order(acc, 0.1, max_hz=hz)
                    == j_dyn.select_rate_and_order(acc, 0.1, max_hz=hz))
            assert (dynamic_cloning.interp_noise_std(acc, hz, 1)
                    == j_dyn.interp_noise_std(acc, hz, 1))


# --- stereo: the right camera and the tracker --------------------------------

def test_render_right_camera_matches_jax():
    """The right camera's frames (with and without line strokes, drawn
    after left ones from the same generator) against JAX's."""
    kw = dict(duration=3.0, n_landmarks=200, n_lines=20, seed=2)
    js, ts = JSimulator(JSimConfig(**kw)), Simulator(SimConfig(**kw))
    for cam in (0, 1):
        np.testing.assert_allclose(ts.render_frame(1.0, cam=cam), js.render_frame(1.0, cam=cam),
                                   rtol=0, atol=1e-6)
    np.testing.assert_allclose(ts.render_frame(1.1, with_lines=False, cam=1),
                               js.render_frame(1.1, with_lines=False, cam=1), rtol=0, atol=1e-6)


STEREO_SIM = dict(duration=6.0, n_landmarks=300, n_lines=0, seed=2)
RIGHT = ("uv_r", "hist_uv_r", "hist_uvn_r")


@pytest.fixture(scope="module")
def stereo_frames():
    """Five stereo pairs of the JAX simulator (tests/test_stereo_fused.py's
    world), with the IMU and wheel windows between them."""
    sim = JSimulator(JSimConfig(**STEREO_SIM))
    imu = sim.imu_stream()
    frames, t_prev = [], T0
    for i in range(5):
        t = T0 + 0.1 * (i + 1)
        frames.append(dict(t=t, img=sim.render_frame(t), img_r=sim.render_frame(t, cam=1),
                           imu=_imu_window(*imu, t_prev, t), wheel=_wheel_window(sim, t_prev, t)))
        t_prev = t
    return sim, frames


def test_track_frame_stereo_matches_jax(stereo_frames, monkeypatch):
    """Five stereo frames through both trackers: the left fields as in
    tests/test_torch_fused_frame.py and every right field, and the right
    observations written only where the left cursor wrote."""
    sim, frames = stereo_frames
    monkeypatch.setattr(klt, "draw_hypotheses", JaxDraws())
    k = np.asarray(sim.cfg.intrinsics)
    jts = j_make_track_state(480, 640, n_pts=64, max_lines=8, max_obs=4)
    tts = frame.make_track_state(480, 640, 64, 8, 4, device="cpu")
    harvested = 0
    for i, f in enumerate(frames):
        jts, jh, _ = j_track_frame(jts, jnp.asarray(f["img"]), jnp.asarray(k), jnp.asarray(f["t"]),
                                   jnp.asarray(i, jnp.int32), use_stereo=True,
                                   img_r=jnp.asarray(f["img_r"]), cam_k_r=jnp.asarray(k))
        tts, th, _ = frame.track_frame(tts, _t(f["img"])[None], _t(k)[None],
                                       torch.tensor([f["t"]], dtype=F64), torch.tensor([i]),
                                       lines=False, img_r=_t(f["img_r"])[None],
                                       cam_k_r=_t(k)[None])
        for name in ("valid", "n_obs", "hist_slot", "rvalid", "hist_rvalid"):
            np.testing.assert_array_equal(getattr(tts, name)[0].numpy(),
                                          np.asarray(getattr(jts, name)), err_msg=f"{i} {name}")
        for j in (3, 7):
            np.testing.assert_array_equal(th[j][0].numpy(), np.asarray(jh[j]), err_msg=f"{i} {j}")
        for name, tol in (("uv", 1e-3), ("hist_uv", 1e-3), ("hist_uvn", 1e-6)):
            np.testing.assert_allclose(getattr(tts, name)[0].numpy(),
                                       np.asarray(getattr(jts, name)), rtol=0, atol=tol,
                                       err_msg=f"{i} {name}")
        # right positions where the association holds (see the docstring)
        rv, hrv, hm = np.asarray(jts.rvalid), np.asarray(jts.hist_rvalid), np.asarray(jh[7])
        for got, want, m, tol in ((tts.uv_r, jts.uv_r, rv, 1e-3),
                                  (tts.hist_uv_r, jts.hist_uv_r, hrv, 1e-3),
                                  (tts.hist_uvn_r, jts.hist_uvn_r, hrv, 1e-6),
                                  (th[5], jh[5], hm, 1e-3), (th[6], jh[6], hm, 1e-6)):
            np.testing.assert_allclose(got[0].numpy()[m], np.asarray(want)[m], rtol=0, atol=tol,
                                       err_msg=f"{i}")
        harvested += int(np.asarray(jh[7]).any(axis=1).sum())
    assert int(tts.rvalid.sum()) >= 0.5 * int(tts.valid.sum()) > 0 and harvested > 0
    left_written = tts.hist_t > -torch.inf
    assert not (tts.hist_rvalid & ~left_written).any()


# --- the frame: dynamic cloning and stereo -----------------------------------

def _do_clone(b, i):
    """The clone pattern of the frame tests: sequence b clones on frames
    where (frame + b) is even, so each sequence has frames without one."""
    return (i + b) % 2 == 0


def _sequences(world, n_seq, layout, stereo=False):
    """Per-sequence JAX states seeded from ground truth (moved by 1 cm per
    sequence; with stereo the right camera installed as camera 1) and the
    world's frames with per-sequence pixel noise on both images; without
    stereo (dynamic cloning) each frame's wheel window runs from the
    sequence's last clone, as the driver selects it."""
    sim, frames = world
    base = _seed_state(sim, JLayout(**layout), T0)
    if stereo:
        c = sim.cfg
        base = base.replace(
            cam_k=base.cam_k.at[1].set(jnp.asarray(c.intrinsics)),
            cam_q=base.cam_q.at[1].set(jnp.asarray(c.cam_ext_q)),
            cam_p=base.cam_p.at[1].set(jnp.asarray(c.cam_ext_p) + jnp.asarray(
                [-c.stereo_baseline, 0.0, 0.0])))
    states, seqs = [], []
    for b in range(n_seq):
        states.append(base.replace(p=base.p + 0.01 * b, p_fej=base.p_fej + 0.01 * b))
        rng = np.random.default_rng(100 + b)

        def noisy(img):
            return np.clip(img + (2e-3 * b) * rng.normal(size=img.shape), 0, 1).astype(np.float32)

        seqs.append([dict(f, img=noisy(f["img"]), **({"img_r": noisy(f["img_r"])} if stereo
                                                       else {})) for f in frames])
        t_clone = T0
        for i, f in enumerate([] if stereo else seqs[-1]):
            f["wheel"] = _wheel_window(sim, t_clone, f["t"], pad=32)
            if _do_clone(b, i):
                t_clone = f["t"]
    return states, seqs


def _jax_kw(mode, f, b, i):
    """JAX fused_frame's mode arguments for sequence b's frame i."""
    if mode == "dynamic":
        return dict(use_dynamic=True, do_clone=jnp.asarray(_do_clone(b, i)))
    return dict(use_stereo=True, use_lines=False, img_r=jnp.asarray(f["img_r"]))


def _port_kw(mode, fs, i):
    """The port's fused_frame mode arguments for frame i of a batch of
    sequences' frames fs."""
    if mode == "dynamic":
        return dict(use_dynamic=True, do_clone=torch.tensor([_do_clone(b, i)
                                                             for b in range(len(fs))]))
    return dict(use_stereo=True, use_lines=False,
                img_r=torch.as_tensor(np.stack([f["img_r"] for f in fs])))


MODES = {"dynamic": dict(n_clones=6, n_cams=1, use_wheel=True),
         "stereo": dict(n_clones=6, n_cams=2, use_wheel=True)}
N_FRAMES = 5


@pytest.fixture(scope="module")
def frame_runs(stereo_frames):
    """Per mode, two sequences through N_FRAMES JAX frames (one compile a
    mode): the seeded states, their inputs, and per frame the JAX state and
    metrics.  Dynamic cloning runs in tests/test_torch_fused_frame.py's
    world with lines, stereo in tests/test_stereo_fused.py's."""
    from tests.test_torch_fused_frame import _scene

    sim, frames = _scene(3, N_FRAMES)
    worlds = {"dynamic": (sim, frames), "stereo": stereo_frames}
    jg = jnp.asarray([0.0, 0.0, 9.81])
    out = {}
    for mode, layout in MODES.items():
        jstates, seqs = _sequences(worlds[mode], 2, layout, stereo=mode == "stereo")
        runs = []
        for b in range(2):
            st, jts, per = jstates[b], j_make_track_state(480, 640, 64, 16, 4, b), []
            for i, f in enumerate(seqs[b]):
                st, jts, jm = j_fused_frame(
                    st, jts, jnp.asarray(f["img"]), *f["imu"], jnp.asarray(f["t"]), *f["wheel"],
                    jnp.asarray(True), jg, SIGMAS, 1.5, 8.0, 2.0, WHEEL_NOISE, min_track=4,
                    **_jax_kw(mode, f, b, i))
                per.append((st, jm))
            runs.append(per)
        out[mode] = (jstates, seqs, runs)
    return out


FRAME_COUNTS = {"dynamic": ("accepted", "wheel_accepted", "tracked", "harvested",
                            "lines_accepted", "line_tracked", "line_harvested"),
                "stereo": ("accepted", "wheel_accepted", "tracked", "harvested")}


@pytest.mark.parametrize("mode", ["dynamic", "stereo"])
@pytest.mark.parametrize("n_seq", [1, 2])
def test_fused_frame_matches_jax(frame_runs, monkeypatch, mode, n_seq):
    """Five images-in frames in each mode, held frame by frame to JAX's:
    dynamic cloning with sequence b cloning where (frame + b) is even
    (points at interpolated poses, lines and clone-to-clone wheel rows),
    and stereo (a second LK pass, M = 4 O rows over two cameras); with
    n_seq = 2 two sequences that differ (state, pixel noise, RANSAC key,
    clone pattern) in one batch."""
    jstates, seqs, runs = frame_runs[mode]
    monkeypatch.setattr(klt, "draw_hypotheses", JaxDraws())
    tstate = FilterState.from_numpy([_jax_state_arrays(s) for s in jstates[:n_seq]],
                                    jstates[0].layout, device="cpu")
    tts = frame.make_track_state(480, 640, 64, 16, 4, batch=n_seq, device="cpu")
    tg = torch.tensor([0.0, 0.0, 9.81], dtype=F64)
    totals = dict.fromkeys(FRAME_COUNTS[mode], 0)
    for i in range(N_FRAMES):
        fs = [s[i] for s in seqs[:n_seq]]

        def stack(get):
            return torch.as_tensor(np.stack([np.asarray(get(f)) for f in fs]))

        tstate, tts, tm = frame.fused_frame(
            tstate, tts, stack(lambda f: f["img"]),
            *(stack(lambda f, j=j: f["imu"][j]) for j in range(3)), stack(lambda f: f["t"]),
            *(stack(lambda f, j=j: f["wheel"][j]) for j in range(3)),
            torch.ones(n_seq, dtype=torch.bool), tg, SIGMAS, 1.5, 8.0, 2.0, WHEEL_NOISE,
            min_track=4, **_port_kw(mode, fs, i))
        for b in range(n_seq):
            jstate, jm = runs[b][i]
            _assert_frame_close(tstate, tm, jstate, jm, b, FRAME_COUNTS[mode])
            for k in totals:
                totals[k] += int(jm[k])
    assert totals["accepted"] > 0 and totals["wheel_accepted"] > 0, totals
    if mode == "dynamic":
        assert int(tstate.clone_valid.sum()) < N_FRAMES * n_seq
    else:
        assert int(tts.rvalid.sum()) > 0


# --- the live driver ---------------------------------------------------------

DRIVER_SIM = dict(duration=2.5, n_landmarks=350, seed=6)
DRIVER_FRAMES = 8


def _small(opts):
    opts.cam.n_pts, opts.cam.max_lines, opts.cam.fused_max_obs = 32, 8, 4
    return opts


@pytest.mark.parametrize("mode", ["dynamic", "stereo"])
def test_feed_image_matches_jax(monkeypatch, mode):
    """Both drivers through one stream of the port's simulator (the JAX
    one's data): tests/test_dynamic_fused.py's options (dynamic cloning
    capped at 10 Hz, lines, wheel) or tests/test_stereo_fused.py's (two
    cameras and a right image a frame, wheel, no lines), with small
    tracker slots; after every frame the same stats and trajectory."""
    monkeypatch.setattr(klt, "draw_hypotheses", JaxDraws())
    stereo = mode == "stereo"
    sim = Simulator(SimConfig(**DRIVER_SIM, n_lines=0 if stereo else 40))
    events = examples.live_events(sim, T0, DRIVER_FRAMES, stereo=stereo)

    def options(tree):
        opts = tree.EstimatorOptions()
        return _small(examples.stereo_options(opts) if stereo else examples.dynamic_options(opts))

    port = VioSystem(options(t_options), device="cpu")
    jsys = JVioSystem(options(j_options))
    for s in (port, jsys):
        examples.live_calibrate(s, sim, T0)
    # without lines JAX still runs its line front-end and counts the lines it
    # harvests as rejected; the port skips that front-end (see the docstring)
    skip = ("line_reject",) if stereo else ()
    n_frames = 0
    for kind, args in events:
        examples.feed(port, kind, args)
        examples.feed(jsys, kind, args)
        assert len(port.traj) == len(jsys.traj)
        if len(jsys.traj) == n_frames:
            continue
        n_frames = len(jsys.traj)
        assert {k: v for k, v in port.stats.items() if k not in skip} == {
            k: v for k, v in jsys.stats.items() if k not in skip}, (port.stats, jsys.stats)
        for (ta, _, pa), (tb, _, pb) in zip(port.traj, jsys.traj, strict=True):
            assert ta == tb
            np.testing.assert_allclose(pa, np.asarray(pb), rtol=0, atol=1e-5)
        cov = np.asarray(jsys.state.cov)
        assert np.max(np.abs(port.state.cov[0].numpy() - cov)) < 1e-4 * np.max(np.abs(cov))
    assert len(port.traj) == DRIVER_FRAMES and port.stats["cam_accept"] > 0
    if stereo:
        assert int(port.track_state.hist_rvalid.sum()) > 0
    else:
        assert 0 < port.stats["clones"] < DRIVER_FRAMES and port.stats["wheel_accept"] > 0


# --- the JAX end-to-end tests' scenarios, on the port alone ------------------

def _run_live(sim, opts, n_frames, stereo=False, nees=False):
    """tests/test_dynamic_fused.py's and tests/test_stereo_fused.py's loop
    through the port's VioSystem: the system, and with nees per frame the
    p/o/v NEES after it."""
    system = VioSystem(opts, device="cpu")
    examples.live_calibrate(system, sim, T0)
    rows = []
    for kind, args in examples.live_events(sim, T0, n_frames, stereo=stereo):
        n = system.stats["updates"]
        examples.feed(system, kind, args)
        if nees and system.stats["updates"] > n:
            st, kin = system.state, sim.gt_kin(system._time)
            d = np.sqrt(np.maximum(st.cov[0].diagonal()[:15].numpy(), 1e-18))
            dR = lie.quat_2_rot(st.q[0]).numpy() @ np.asarray(kin["R_GtoI"]).T
            o = lie.log_so3(torch.as_tensor(dR)).numpy()
            rows.append({"p": np.sum(((st.p[0].numpy() - kin["p_IinG"]) / d[3:6]) ** 2),
                         "o": np.sum((o / d[0:3]) ** 2),
                         "v": np.sum(((st.v[0].numpy() - kin["v_IinG"]) / d[6:9]) ** 2)})
    d = system.state.cov[0].diagonal()
    assert bool(torch.isfinite(d).all()) and bool((d > -1e-9).all())
    errs = [np.linalg.norm(p - sim.gt_pose(t)[1]) for t, _, p in system.traj]
    assert np.isfinite(errs).all()
    return system, float(np.sqrt(np.mean(np.square(errs)))), rows


@pytest.mark.slow
def test_feed_image_dynamic_cloning_nees():
    """tests/test_dynamic_fused.py's scenario and gates."""
    sim = Simulator(SimConfig(duration=12.0, n_landmarks=350, n_lines=40, seed=6))
    s, rmse, rows = _run_live(sim, examples.dynamic_options(t_options.EstimatorOptions()), 90,
                              nees=True)
    frames, clones = s.stats["updates"], s.stats["clones"]
    assert frames >= 80 and clones < frames, (frames, clones)
    assert s.stats["cam_accept"] > 20 and s.stats["wheel_accept"] > clones // 3, s.stats
    assert rmse < 0.5, f"dynamic fused RMSE {rmse:.3f} m"
    assert len(rows[10:]) > 40
    for key in ("p", "o", "v"):
        mean = float(np.mean([r[key] for r in rows[10:]]))
        assert 0.15 < mean < 6.0, f"{key} NEES mean {mean:.2f}"


@pytest.mark.slow
def test_stereo_fused_e2e_beats_mono():
    """tests/test_stereo_fused.py's scenario and gates: stereo within
    0.30 m, accepting more than mono and within 1.25x mono's RMSE."""
    out = {}
    for stereo in (True, False):
        sim = Simulator(SimConfig(duration=9.0, n_landmarks=350, n_lines=0, seed=4))
        s, rmse, _ = _run_live(sim, examples.stereo_options(t_options.EstimatorOptions(), stereo),
                               60, stereo=stereo)
        acc = s.stats["cam_accept"] / max(s.stats["cam_accept"] + s.stats["cam_reject"], 1)
        out[stereo] = (rmse, acc)
    (rmse_s, acc_s), (rmse_m, acc_m) = out[True], out[False]
    assert rmse_s < 0.30, rmse_s
    assert acc_s > acc_m, (acc_s, acc_m)
    assert rmse_s < 1.25 * rmse_m, (rmse_s, rmse_m)
