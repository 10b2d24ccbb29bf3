"""The port's per-track lines against the JAX package, on the CPU.

The simulator's lines (`Simulator.line_frame`, `line_dir_class`), the line
database and its majority vote, the vanishing points and the segment
classification (ties and invalid points included), the direction-constrained
triangulations, the line systems with point-line-coupled (PLC) rows, the
point-to-segment assignment, and `VioSystem.feed_camera` with lines frame by
frame, with `run_sim --lines` without --images.  Inputs are numpy arrays made
from a seed, or the two simulators' streams; both drivers export their mono
MSCKF candidates through the C++ feature store (the JAX driver is handed
the port's build of native/feature_db.cpp, `native_store`), as each does
where the library builds.

Tolerances: `line_frame` ids equal and segments within 1e-12 px, with the
generators in step after it; the line databases and every majority class
equal; the vanishing points within 1e-9 px of max(1, max|uv|) and their
validity equal, the classes equal; `triangulate_direction_ls` ok equal and
n, v within 1e-9 of max(1, max|x|); `triangulate_from_direction` within
1e-14; `line_systems_batch_plc` at P = 0 equal to `line_systems_batch` bit
for bit, and at P = 0 and P = 4 (the first observation's PLC rows masked)
row masks equal and Hx, Hl, r within 1e-9 of max(1, max|x|) on valid rows;
the gate of those rows (k = 4, the zero pivots of the masked first rows)
with its line_ok and row masks equal and rows within 1e-8; the assignment
equal.

The driver, in five modes over 2-2.5 s of simulation (lines mono, in the
scenario of tests/test_lines.py::test_e2e_points_and_lines; lines + W3D_ANG
wheel + dynamic cloning at order 3; lines with sequential updates, without
and with the wheel rows; lines with each frame's attached points from
`assign_points_to_lines` and cam.use_plc), against JAX with the port's
compression factor (`jax_factor_valid_only`, see tests/test_torch_per_track.py):
`stats` (`line_accept` and `line_reject` included) equal after every frame
and `len(traj)` equal; positions within 1e-5 m and the covariance within
1e-3 max|cov| of JAX's (1.7e-7 m and 1.9e-5 measured).  The port's lines
mono run over 4 s started 1e-9 m/s off stays within 1e-7 m of the first
(8.3e-9 m measured).  `run_sim --lines --wheel` and `--lines --plc`: JAX's
summary keys plus `device`, and JAX's frames, updates and acceptance rates
(measured with JAX's run_sim on the CPU).  The slow tests hold the port
alone to the gates of tests/test_lines.py::test_e2e_points_and_lines and
tests/test_line_class.py::test_feed_time_classification_agreement_under_yaw,
recompute the JAX numbers chip_smoke.py holds the card to, and hold the
port's RMSE in test_e2e_points_and_lines's scenario at four seeds within 1%
of JAX's with the port's compression factor.
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
from plviwo_tpu.core.system import VioSystem as JVioSystem
from plviwo_tpu.ops.chi2 import _TABLE as J_CHI2
from plviwo_tpu.sim.simulator import SimConfig as JSimConfig
from plviwo_tpu.sim.simulator import Simulator as JSimulator
from plviwo_tpu.update import cam_helper as j_cam
from plviwo_tpu.update import feature_db as j_fdb
from plviwo_tpu.update import lines as j_lines
from plviwo_tpu_torch import examples, run_sim
from plviwo_tpu_torch import native as port_native
from plviwo_tpu_torch.config.options import EstimatorOptions
from plviwo_tpu_torch.core.system import VioSystem
from plviwo_tpu_torch.ops import lie
from plviwo_tpu_torch.ops.chi2 import _TABLE as T_CHI2
from plviwo_tpu_torch.sim.simulator import SimConfig, Simulator
from plviwo_tpu_torch.update import cam_helper, feature_db, lines
from tests.test_torch_per_track import jax_factor_valid_only  # noqa: F401 (fixture)

F64 = torch.float64


def _t(x, dtype=F64):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


def _close(a, b, tol, what=""):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    scale = max(1.0, float(np.max(np.abs(b)))) if b.size else 1.0
    err = float(np.max(np.abs(a - b))) if b.size else 0.0
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol:.1e} x {scale:.3e}"


# --- the simulator's lines and the line database ---------------------------------

def test_line_frame_matches_jax():
    cfg = dict(duration=4.0, seed=7, n_lines=50, sigma_pix_line=1.0)
    port, jsim = Simulator(SimConfig(**cfg)), JSimulator(JSimConfig(**cfg))
    np.testing.assert_array_equal(port.line_dir_class, jsim.line_dir_class)
    port.imu_stream(), jsim.imu_stream()
    n = 0
    for t in port.cam_times()[::4]:
        ids, seg = port.line_frame(t)
        jids, jseg = jsim.line_frame(t)
        np.testing.assert_array_equal(ids, jids)
        np.testing.assert_allclose(seg, jseg, rtol=0, atol=1e-12)
        n += len(ids)
    assert n > 50
    assert port.rng.normal() == jsim.rng.normal()


def test_line_database_matches_jax():
    """Random updates (classes, attached points), cleanups and removals
    through both stores; the majority vote of every track after each step,
    and the vote's rules on fixed class sequences."""
    rng = np.random.default_rng(12)
    dbs = (feature_db.LineDatabase(), j_fdb.LineDatabase())
    for k in range(60):
        t = 0.1 * k
        for lid in rng.choice(30, size=10, replace=False):
            seg, seg_n = rng.normal(size=4), rng.normal(size=4)
            pids = [int(x) for x in rng.choice(50, size=int(rng.integers(0, 4)), replace=False)]
            D = int(rng.choice(4, p=[0.4, 0.1, 0.1, 0.4]))
            for db in dbs:
                db.update(int(lid), t, seg, seg_n, point_ids=pids, D=D)
        if k % 7 == 3:
            for db in dbs:
                db.cleanup(t - 1.0)
        if k % 5 == 4:
            gone = [int(x) for x in rng.choice(30, size=4, replace=False)]
            for db in dbs:
                db.remove(gone)
        a, b = dbs
        assert len(a) == len(b) and list(a.tracks) == list(b.tracks)
        for lid, tr in a.tracks.items():
            jt = b.tracks[lid]
            assert (tr.times, tr.point_ids, tr.classes, tr.D) == (jt.times, jt.point_ids,
                                                                  jt.classes, jt.D)
            np.testing.assert_array_equal(np.array(tr.segs), np.array(jt.segs))
            np.testing.assert_array_equal(np.array(tr.segs_n), np.array(jt.segs_n))
            assert tr.majority_class() == jt.majority_class()
    for classes in ([3, 3, 3, 3], [1, 3, 3, 3, 3], [0, 0, 0, 1], [1], [1, 2, 0, 0, 1, 0],
                    [2, 2, 0, 0], [0, 0, 0], [1, 2, 3], []):
        want = j_fdb.LineTrack(0, [], [], [], [], classes=list(classes)).majority_class()
        got = feature_db.LineTrack(0, [], [], [], [], classes=list(classes)).majority_class()
        assert got == want, classes
    # no votes at all: the fed class D
    assert feature_db.LineTrack(0, [], [], [], [], classes=[0], D=2).majority_class() == \
        j_fdb.LineTrack(0, [], [], [], [], classes=[0], D=2).majority_class() == 2


# --- vanishing points, classification, assignment ---------------------------------

CAM_Q = np.array([0.5, -0.5, 0.5, -0.5])  # camera z forward = body x
CAM_K = np.array([300.0, 300.0, 320.0, 240.0, -0.05, 0.01, 5e-4, -2e-4])


def _orientations(rng, n):
    qs = [lie.rot_2_quat(lie.exp_so3(_t(rng.normal(0, 0.6, 3)))).numpy() for _ in range(n)]
    # an axis parallel to the image plane: world z along body z (level,
    # camera looking horizontally), so the z point is invalid
    qs.append(np.array([0.0, 0.0, 0.0, 1.0]))
    return np.array(qs)


def test_vanishing_points_and_classes_match_jax():
    """Random orientations (one level, its vertical vanishing point
    invalid) and segments through each point: the points, their validity
    and the classes."""
    rng = np.random.default_rng(5)
    qs = _orientations(rng, 5)
    B = len(qs)
    vps, vv = lines.vanishing_points(_t(qs), _t(np.tile(CAM_Q, (B, 1))), _t(np.tile(CAM_K, (B, 1))))
    segs = []
    for b in range(B):
        jvp, jvv = j_lines.vanishing_points(jnp.asarray(qs[b]), jnp.asarray(CAM_Q),
                                            jnp.asarray(CAM_K))
        np.testing.assert_array_equal(vv[b].numpy(), np.asarray(jvv))
        ok = np.asarray(jvv)
        _close(vps[b].numpy()[ok], np.asarray(jvp)[ok], 1e-9, "vanishing points")
        # segments aimed at each point (short, near it or far), plus random ones
        s = []
        for k in range(3):
            mid = rng.uniform([50, 50], [590, 430], size=(6, 2))
            d = np.asarray(jvp)[k] - mid
            d = d / np.linalg.norm(d, axis=1, keepdims=True)
            half = rng.uniform(10, 60, size=(6, 1))
            s.append(np.concatenate([mid - half * d, mid + half * d], 1)
                     + rng.normal(0, 0.5, (6, 4)))
        s.append(rng.uniform(0, 640, size=(6, 4)))
        segs.append(np.concatenate(s))
    segs = np.stack(segs)
    got = lines.classify_lines(_t(segs), vps, vv)
    for b in range(B):
        want = j_lines.classify_lines(jnp.asarray(segs[b]), *j_lines.vanishing_points(
            jnp.asarray(qs[b]), jnp.asarray(CAM_Q), jnp.asarray(CAM_K)))
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(want))
    counts = np.bincount(got.numpy().ravel(), minlength=4)
    assert all(counts > 5), counts
    assert not bool(vv[-1, 2])


def test_classify_lines_ties_and_invalid_points_match_jax():
    """Equal scores (two coincident vanishing points: the first wins), a
    point marked invalid, and segments that qualify for none (inf scores)."""
    vps = np.array([[320.0, 10000.0], [320.0, 10000.0], [10000.0, 240.0]])
    segs = np.array([[100.0, 100.0, 100.0, 200.0],   # vertical: tie of points 0 and 1
                     [100.0, 100.0, 200.0, 100.0],   # horizontal: point 2
                     [100.0, 100.0, 160.0, 180.0],   # diagonal: none
                     [300.0, 50.0, 301.0, 400.0],    # near vertical
                     [0.0, 0.0, 0.0, 0.0]])          # degenerate
    for valid in ([True, True, True], [False, True, True], [True, True, False],
                  [False, False, False]):
        got = lines.classify_lines(_t(segs)[None], _t(vps)[None], _t(valid, torch.bool)[None])[0]
        want = j_lines.classify_lines(jnp.asarray(segs), jnp.asarray(vps), jnp.asarray(valid))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=str(valid))
    got = lines.classify_lines(_t(segs)[None], _t(vps)[None], torch.ones(1, 3, dtype=torch.bool))
    assert got[0].tolist()[:3] == [1, 3, 0]


def test_assign_points_to_lines_matches_jax():
    rng = np.random.default_rng(8)
    segs = rng.uniform(0, 640, size=(2, 12, 4))
    # points on the segments (with noise), near their ends, and anywhere
    tt = rng.uniform(-0.1, 1.1, size=(2, 12, 3, 1))
    on = segs[:, :, None, :2] + tt * (segs[:, :, None, 2:] - segs[:, :, None, :2])
    pts = np.concatenate([on.reshape(2, 36, 2) + rng.normal(0, 4.0, (2, 36, 2)),
                          rng.uniform(0, 640, size=(2, 30, 2))], 1)
    valid = rng.random((2, 66)) > 0.1
    got = lines.assign_points_to_lines(_t(segs), _t(pts), _t(valid, torch.bool))
    for b in range(2):
        want = j_lines.assign_points_to_lines(jnp.asarray(segs[b]), jnp.asarray(pts[b]),
                                              jnp.asarray(valid[b]))
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(want))
    assert 10 < int(got.sum()) < got.numel() // 4


# --- triangulation and the line systems ------------------------------------------

C_RING, O_OBS, L_LINES = 8, 6, 10


def _line_case(rng, L=L_LINES, O=O_OBS, C=C_RING):
    """A clone ring on a curving path 0.1 s apart (its FEJ copy perturbed),
    L axis-aligned world lines 4-10 m ahead, each observed from O of the
    clones with both endpoints projected (pinhole, 0.5 px noise) and their
    normalized coordinates."""
    ts = 0.1 * np.arange(C)
    q, p = [], []
    for t in ts:
        R = lie.exp_so3(_t([0.05 * np.sin(3 * t), 0.1 * t * t, 0.6 * t])).numpy()
        q.append(lie.rot_2_quat(_t(R)).numpy())
        p.append([3.0 * t, np.sin(2 * t), 0.2 * t * t])
    q, p = np.array(q), np.array(p)
    qf = lie.quat_norm(_t(q + rng.normal(0, 1e-3, q.shape))).numpy()
    pf = p + rng.normal(0, 1e-2, p.shape)
    cls = rng.integers(1, 4, size=L)
    axes = np.eye(3)[cls - 1]
    P0 = p[0] + np.array([7.0, 0.0, 0.0]) + rng.uniform(-3, 3, (L, 3))
    ends = np.stack([P0 - 1.5 * axes, P0 + 1.5 * axes], 1)  # (L,2,3)
    R_ItoC = lie.quat_2_rot(_t(CAM_Q)).numpy()
    cam_p = np.array([0.05, 0.0, 0.0])
    slot = np.stack([rng.permutation(C)[:O] for _ in range(L)])
    seg_uvn = np.zeros((L, O, 4))
    for i in range(L):
        for j in range(O):
            R = R_ItoC @ lie.quat_2_rot(_t(q[slot[i, j]])).numpy()
            pc = (R @ (ends[i] - p[slot[i, j]]).T).T + cam_p
            seg_uvn[i, j] = (pc[:, :2] / pc[:, 2:]).ravel()
    seg_uv = seg_uvn * 300.0 + np.tile([320.0, 240.0], 2) + rng.normal(0, 0.5, (L, O, 4))
    seg_uvn = (seg_uv - np.tile([320.0, 240.0], 2)) / 300.0
    valid = rng.random((L, O)) > 0.15
    valid[:, :2] = True
    n_true = np.cross(P0, axes)
    return dict(q=q, p=p, qf=qf, pf=pf, slot=slot, seg_uv=seg_uv, seg_uvn=seg_uvn, valid=valid,
                axes=axes, n=n_true, cam_q=CAM_Q, cam_p=cam_p,
                cam_k=np.array([300.0, 300.0, 320.0, 240.0, 0, 0, 0, 0]))


def test_triangulate_direction_ls_matches_jax():
    rng = np.random.default_rng(21)
    c = _line_case(rng)
    c["valid"][0, 1:] = False  # one observation: not ok
    dirs = c["axes"] + rng.normal(0, 0.02, c["axes"].shape)
    args = (c["seg_uvn"], c["q"][c["slot"]], c["p"][c["slot"]], c["valid"])
    n, v, ok = lines.triangulate_direction_ls(*(_t(x)[None] for x in args[:3]),
                                              _t(args[3], torch.bool)[None], _t(c["cam_q"])[None],
                                              _t(c["cam_p"])[None], _t(dirs)[None])
    jn, jv, jok = (np.asarray(x) for x in j_lines.triangulate_direction_ls(
        *(jnp.asarray(x) for x in args), jnp.asarray(c["cam_q"]), jnp.asarray(c["cam_p"]),
        jnp.asarray(dirs)))
    np.testing.assert_array_equal(ok[0].numpy(), jok)
    assert jok.sum() == L_LINES - 1
    _close(n[0].numpy()[jok], jn[jok], 1e-9, "n")
    _close(v[0].numpy(), jv, 1e-9, "v")
    # the moments land near the truth (2 cm of direction noise)
    assert np.max(np.abs(jn[jok] - c["n"][jok])) < 0.5


def test_triangulate_from_direction_matches_jax():
    rng = np.random.default_rng(22)
    d, pt = rng.normal(size=(7, 3)), rng.normal(size=(7, 3)) * 5
    got = lines.triangulate_from_direction(_t(d), _t(pt))
    want = j_lines.triangulate_from_direction(jnp.asarray(d), jnp.asarray(pt))
    for a, b in zip(got, want):
        _close(a.numpy(), b, 1e-14)


def _systems(c, plc_uv, plc_valid, n_G, v_G, port):
    lo = dict(n_clones=C_RING, clone_off=15, D=15 + 6 * C_RING + 15)
    ring = [c[k] for k in ("q", "p", "qf", "pf")]
    cam = [c[k] for k in ("cam_q", "cam_p", "cam_k")]
    if port:
        return lines.line_systems_batch_plc(
            _t(n_G)[None], _t(v_G)[None], _t(c["seg_uv"])[None], _t(plc_uv)[None],
            _t(plc_valid, torch.bool)[None], _t(c["slot"], torch.long)[None],
            _t(c["valid"], torch.bool)[None], *(_t(x)[None] for x in ring),
            *(_t(x)[None] for x in cam), *lo.values())
    return j_lines.line_systems_batch_plc(
        jnp.asarray(n_G), jnp.asarray(v_G), jnp.asarray(c["seg_uv"]), jnp.asarray(plc_uv),
        jnp.asarray(plc_valid), jnp.asarray(c["slot"].astype(np.int32)), jnp.asarray(c["valid"]),
        *(jnp.asarray(x) for x in ring), *(jnp.asarray(x) for x in cam), *lo.values())


@pytest.mark.parametrize("P", [0, 4])
def test_line_systems_plc_match_jax(P):
    """The line rows with P attached points per observation (the first
    observation's PLC rows masked, so zero pivots reach the nullspace
    reflectors), against JAX's, then through the gate with k = 4.  At
    P = 0, `line_systems_batch` is `line_systems_batch_plc` bit for bit."""
    rng = np.random.default_rng(30 + P)
    c = _line_case(rng)
    n_G = c["n"] + rng.normal(0, 0.05, c["n"].shape)
    v_G = c["axes"] + rng.normal(0, 0.01, c["axes"].shape)
    # attached points: pixels on (near) each observed segment
    tt = rng.uniform(0, 1, size=(L_LINES, O_OBS, P, 1))
    a, b = c["seg_uv"][..., None, :2], c["seg_uv"][..., None, 2:]
    plc_uv = a + tt * (b - a) + rng.normal(0, 0.7, (L_LINES, O_OBS, P, 2))
    plc_valid = rng.random((L_LINES, O_OBS, P)) > 0.3
    plc_valid[:, 0] = False
    got = _systems(c, plc_uv, plc_valid, n_G, v_G, port=True)
    want = [np.asarray(x) for x in _systems(c, plc_uv, plc_valid, n_G, v_G, port=False)]
    rows = want[3]
    np.testing.assert_array_equal(got[3][0].numpy(), rows)
    assert rows.shape == (L_LINES, (2 + P) * O_OBS)
    for name, x, y in zip(("Hx", "Hl", "r"), got[:3], want[:3]):
        _close(x[0].numpy()[rows], y[rows], 1e-9, name)
    if P == 0:
        plain = lines.line_systems_batch(
            _t(n_G)[None], _t(v_G)[None], _t(c["seg_uv"])[None], _t(c["slot"], torch.long)[None],
            _t(c["valid"], torch.bool)[None], *(_t(c[k])[None] for k in ("q", "p", "qf", "pf")),
            *(_t(c[k])[None] for k in ("cam_q", "cam_p", "cam_k")), C_RING, 15,
            15 + 6 * C_RING + 15)
        for x, y in zip(plain, got):
            assert torch.equal(x, y)
    else:
        assert rows[:, 2 + np.arange(P)].sum() == 0 and rows[:, 2 * O_OBS:].sum() > 0
    # the gate (k = 4) on these rows
    D = 15 + 6 * C_RING + 15
    A = rng.normal(size=(D, D))
    cov = 1e-6 * (A @ A.T / D + np.eye(D))
    gate = cam_helper.msckf_project_and_gate(
        got[0], got[1], got[2], got[3], _t(cov)[None], 2.0**2, _t(T_CHI2), 5.0)
    jgate = [np.asarray(x) for x in j_cam.msckf_project_and_gate(
        *(jnp.asarray(x) for x in want), jnp.asarray(cov), 2.0**2, jnp.asarray(J_CHI2), 5.0)]
    ok = jgate[3]
    np.testing.assert_array_equal(gate[3][0].numpy(), ok)
    np.testing.assert_array_equal(gate[2][0].numpy(), jgate[2])
    assert 0 < ok.sum()
    for name, x, y in zip(("Hn", "rn"), gate[:2], jgate[:2]):
        _close(x[0].numpy()[ok], y[ok], 1e-8, name)


# --- the driver, frame by frame ----------------------------------------------------

LINE_MODES = ("lines_mono", "lines_wheel_dynamic", "lines_sequential", "lines_sequential_wheel",
              "lines_plc")
POS_TOL, COV_TOL = 1e-5, 1e-3  # m, and of max|cov| (see the module docstring)


def _line_scenario(mode):
    """(SimConfig kwargs, option setter, track_events kwargs) of a driver
    mode: tests/test_lines.py::test_e2e_points_and_lines's scenario over 2 s
    (2.5 s with wheel), with W3D_ANG wheel rows and dynamic cloning at order
    3, with sequential updates (without and with the wheel rows), or with
    each frame's attached points and PLC rows."""
    wheel = mode in ("lines_wheel_dynamic", "lines_sequential_wheel")
    sim = dict(duration=2.5 if wheel else 2.0, seed=7, sigma_pix=0.5, n_pts=35,
               sigma_pix_line=1.0, n_lines=50)

    def options(o):
        o.cam.max_msckf, o.cam.sigma_pix, o.cam.min_track_length, o.cam.chi2_mult = 25, 0.5, 4, 5.0
        o.cam.use_lines, o.cam.max_lines, o.cam.sigma_pix_line = True, 20, 2.0
        if wheel:
            w = o.wheel
            w.enabled, w.type, w.chi2_mult = True, "Wheel3DAng", 10.0
            w.noise_w, w.noise_v, w.noise_p = 0.05, 0.05, 0.02
        if mode == "lines_wheel_dynamic":
            o.dynamic_cloning, o.intr_order = True, 3
        if mode.startswith("lines_sequential"):
            o.joint_update = False
        if mode == "lines_plc":
            o.cam.use_plc = True
        return o

    events = dict(lines=True, wheel=wheel, plc=mode == "lines_plc")
    return sim, options, events


def native_store():
    """The port's C++ feature store for a JAX VioSystem (the two packages'
    ctypes wrappers take the same calls), or None where it does not build,
    as the port's VioSystem then has none."""
    return port_native.NativeFeatureDatabase() if port_native.available() else None


def drive(sim_kw, options, events_kw, port):
    """Run one scenario through the port's or JAX's VioSystem (both with
    the C++ feature store, `native_store`; GPS in the world frame); returns
    the system and per frame (stats with whether the GPS is initialized,
    position, covariance, active SLAM ids)."""
    if port:
        sim = Simulator(SimConfig(**sim_kw))
        system = VioSystem(options(EstimatorOptions()), device="cpu")
    else:
        sim = JSimulator(JSimConfig(**sim_kw))
        system = JVioSystem(options(JOptions()))
        system.fdb_native = native_store()
    events = examples.track_events(sim, gps=system.gps is not None, **events_kw)
    c = sim.cfg
    system.set_calibration(np.asarray(c.intrinsics), np.asarray(c.cam_ext_q),
                           np.asarray(c.cam_ext_p))
    if system.opts.wheel.enabled:
        system.set_wheel_calibration(c.wheel_ext_q, c.wheel_ext_p,
                                     [c.wheel_rl, c.wheel_rr, c.wheel_base])
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
            if port:
                st = system.state.to_numpy()
                cov, ids, valid = st["cov"], st["slam_id"], st["slam_valid"]
            else:
                st = system.state
                cov, ids, valid = (np.asarray(x) for x in (st.cov, st.slam_id, st.slam_valid))
            stats = dict(system.stats, gps_initialized=system.gps is not None
                         and system.gps.initialized)
            frames.append((stats, np.array(system.traj[-1][2]), cov,
                           sorted(int(i) for i in ids[valid])))
    return system, frames


def compare(port_frames, jax_frames, pos_tol=POS_TOL, cov_tol=COV_TOL):
    assert len(port_frames) == len(jax_frames)
    for i, ((sa, pa, ca, la), (sb, pb, cb, lb)) in enumerate(zip(port_frames, jax_frames)):
        assert sa == sb, f"frame {i}: {sa} != {sb}"
        assert la == lb, f"frame {i}: SLAM ids {la} != {lb}"
        assert np.max(np.abs(pa - pb)) < pos_tol, f"frame {i}: position"
        assert np.max(np.abs(ca - cb)) < cov_tol * np.max(np.abs(cb)), f"frame {i}: covariance"


@pytest.fixture(scope="module", autouse=True)
def _cache_small_compiles():
    """The JAX driver compiles hundreds of small programs, each under the
    persistent cache's 0.5 s floor: cache them too while this module runs."""
    key = "jax_persistent_cache_min_compile_time_secs"
    old = getattr(jax.config, key)
    jax.config.update(key, 0.0)
    yield
    jax.config.update(key, old)


@pytest.mark.parametrize("mode", LINE_MODES)
def test_driver_lines_match_jax(jax_factor_valid_only, mode):
    sim_kw, options, events_kw = _line_scenario(mode)
    jsys, want = drive(sim_kw, options, events_kw, port=False)
    port, got = drive(sim_kw, options, events_kw, port=True)
    compare(got, want)
    assert len(port.traj) == len(jsys.traj) and port.stats == jsys.stats
    st = port.stats
    assert st["line_accept"] > 3 and st["cam_accept"] > 20 and st["lost_marg_obs"] == 0
    assert set(port.frame_timing) == {"propagate", "cam", "line", "wheel", "update", "frame"}
    if mode == "lines_wheel_dynamic":
        # a clone at fewer than 20 of the 25 camera frames
        assert st["wheel_accept"] > 5 and st["clones"] < 20
        assert port._cur_order == jsys._cur_order
    if mode.startswith("lines_sequential"):
        assert st["updates"] > st["clones"]
    if mode == "lines_plc":
        # attached points reached the line rows
        assert any(any(p) for tr in port.ldb.tracks.values() for p in tr.point_ids)


def _port_positions(sim_kw, options, events_kw, dv):
    """The port's position after every frame, started dv m/s off in x."""
    sim = Simulator(SimConfig(**sim_kw))
    system = VioSystem(options(EstimatorOptions()), device="cpu")
    c, t0 = sim.cfg, float(sim.imu_t[0])
    system.set_calibration(np.asarray(c.intrinsics), np.asarray(c.cam_ext_q),
                           np.asarray(c.cam_ext_p))
    q0, p0 = sim.gt_pose(t0)
    system.initialize_from(t0, np.asarray(q0), p0, sim.gt_kin(t0)["v_IinG"] + [dv, 0.0, 0.0],
                           sim.bg_true[0], sim.ba_true[0])
    for kind, args in examples.track_events(sim, **events_kw):
        examples.feed(system, kind, args)
    return np.array([p for _, _, p in system.traj])


def test_driver_does_not_amplify_rounding():
    """The lines mono scenario over 4 s, started 1e-9 m/s apart: every
    position within 1e-7 m of the other run's (8.3e-9 m measured).  A Gram
    column of rounding noise factored into the compression turned such a
    change into 4.8e-3 m within 4 s (ROADMAP C, hazards)."""
    sim_kw, options, events_kw = _line_scenario("lines_mono")
    sim_kw = dict(sim_kw, duration=4.0)
    a = _port_positions(sim_kw, options, events_kw, 0.0)
    b = _port_positions(sim_kw, options, events_kw, 1e-9)
    assert a.shape == b.shape and len(a) > 30
    assert np.max(np.abs(a - b)) < 1e-7, np.max(np.abs(a - b))


def _run_main(mod, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mod.main(argv)
    return rc, json.loads(buf.getvalue().strip().splitlines()[-1])


JAX_SUMMARY_KEYS = {"frames", "ate_rmse_m", "max_err_m", "updates", "accept_rate", "wall_s",
                    "fps", "distance_m", "clones", "cam_accept_rate", "line_accept_rate",
                    "wheel_accept_rate"}


# plviwo_tpu.run_sim.main(["--platform", "cpu", "--duration", "1.5", ...]) on the
# CPU: (frames, updates, cam_accept_rate, line_accept_rate, wheel_accept_rate)
JAX_RUN_SIM = {("--lines", "--plc"): (13, 10, 0.907, 0.769, 0.0),
               ("--lines", "--wheel"): (13, 13, 0.907, 0.769, 1.0)}


@pytest.mark.parametrize("flags", sorted(JAX_RUN_SIM))
def test_run_sim_lines_matches_jax_summary(flags):
    rc, out = _run_main(run_sim, ["--device", "cpu", "--duration", "1.5", *flags])
    assert rc == 0
    assert set(out) == JAX_SUMMARY_KEYS | {"device", "feature_store"}
    assert out["device"] == "cpu" and out["feature_store"] == "native"
    got = tuple(out[k] for k in ("frames", "updates", "cam_accept_rate", "line_accept_rate",
                                 "wheel_accept_rate"))
    assert got == JAX_RUN_SIM[flags]


# --- the JAX end-to-end tests' scenarios, on the port alone ----------------------

@pytest.mark.slow
def test_e2e_points_and_lines_gates():
    """tests/test_lines.py::test_e2e_points_and_lines's gates: line_accept > 10
    and RMSE < 1.0 m over 10 s."""
    sim = Simulator(SimConfig(duration=10.0, seed=7, sigma_pix=0.5, n_pts=35, sigma_pix_line=1.0,
                              n_lines=50))
    _, options, _ = _line_scenario("lines_mono")
    s = VioSystem(options(EstimatorOptions()), device="cpu")
    examples.live_calibrate(s, sim, float(sim.imu_t[0]))
    for kind, args in examples.track_events(sim, lines=True):
        examples.feed(s, kind, args)
    errs = [np.linalg.norm(p - sim.gt_kin(t)["p_IinG"]) for t, _, p in s.traj]
    rmse = float(np.sqrt(np.mean(np.square(errs))))
    assert s.stats["line_accept"] > 10, s.stats
    assert rmse < 1.0, (rmse, s.stats)


@pytest.mark.slow
def test_feed_time_classification_agreement_under_yaw():
    """tests/test_line_class.py's end-to-end vote: over 70 frames of a
    yawing trajectory, the tracks' majority classes agree with the
    simulator's true axes for > 90% of > 50 checks."""
    sim = Simulator(SimConfig(duration=10.0, seed=4, n_lines=48, sigma_pix_line=1.0))
    o = EstimatorOptions()
    o.cam.use_lines, o.cam.max_lines = True, 40
    s = VioSystem(o, device="cpu")
    examples.live_calibrate(s, sim, float(sim.imu_t[0]))
    cam_ts = sim.cam_times()[:70]
    imu_t, imu_w, imu_a = sim.imu_stream()
    frames = [(float(t), sim.cam_frame(t), sim.line_frame(t)) for t in cam_ts]
    agree = disagree = k = 0
    for i in range(len(imu_t)):
        while k < len(frames) and frames[k][0] <= imu_t[i]:
            t, (ids, uvs), (lids, segs) = frames[k]
            s.feed_camera(t, ids, uvs, lids, segs)
            for lid in lids:
                tr = s.ldb.tracks.get(int(lid))
                if tr is None or len(tr.classes) < 4 or tr.majority_class() == 0:
                    continue
                if tr.majority_class() == int(sim.line_dir_class[int(lid)]):
                    agree += 1
                else:
                    disagree += 1
            k += 1
        s.feed_imu(imu_t[i], imu_w[i], imu_a[i])
        if k >= len(frames):
            break
    total = agree + disagree
    assert total > 50 and agree / total > 0.9, (agree, total)


@pytest.mark.slow
def test_chip_smoke_jax_constants():
    """The JAX driver's numbers that chip_smoke.py holds the card to, on the
    CPU: phase 20's RMSE (LINES_JAX_RMSE), phase 21's ATE and lost_marg_obs
    (KAIST_LINES_JAX_ATE, KAIST_LINES_JAX_LOST).  XLA:CPU on another
    processor may round differently, and phase 20's scenario amplifies
    rounding (PERF.md section 7): a mismatch there means re-measuring, not a
    fault of the port."""
    import chip_smoke

    def run(sim_kw, options, events_kw):
        sim = JSimulator(JSimConfig(**sim_kw))
        s = JVioSystem(options(JOptions()))
        s.fdb_native = None
        examples.live_calibrate(s, sim, float(sim.imu_t[0]))
        for kind, args in examples.track_events(sim, **events_kw):
            examples.feed(s, kind, args)
        errs = [np.linalg.norm(p - np.asarray(sim.gt_kin(t)["p_IinG"])) for t, _, p in s.traj]
        return float(np.sqrt(np.mean(np.square(errs)))), s.stats

    lines_kw = dict(duration=10.0, seed=7, sigma_pix=0.5, n_pts=35, sigma_pix_line=1.0,
                    n_lines=50)
    rmse = run(lines_kw, chip_smoke.lines_options, dict(lines=True))[0]
    assert rmse == pytest.approx(chip_smoke.LINES_JAX_RMSE, rel=1e-6)
    ate, stats = run(dict(duration=15.0, seed=1, n_pts=150),
                     lambda o: chip_smoke.kaist_options(o, lines=True),
                     dict(lines=True, wheel=True))
    assert ate == pytest.approx(chip_smoke.KAIST_LINES_JAX_ATE, rel=1e-6)
    assert stats["lost_marg_obs"] == chip_smoke.KAIST_LINES_JAX_LOST


@pytest.mark.slow
def test_lines_accuracy_matches_jax_across_seeds(jax_factor_valid_only):
    """chip_smoke.py phase 20's scenario (tests/test_lines.py::
    test_e2e_points_and_lines's settings) over 10 s at seeds 3, 7, 8 and
    11, the port and JAX's driver with the port's compression factor
    (`jax_factor_valid_only`) on the CPU: each seed's RMSE within 1% of
    JAX's and its stats equal.  Prints each seed's RMSE."""
    def run(port, seed):
        kw = dict(duration=10.0, seed=seed, sigma_pix=0.5, n_pts=35, sigma_pix_line=1.0,
                  n_lines=50)
        if port:
            sim = Simulator(SimConfig(**kw))
            s = VioSystem(options(EstimatorOptions()), device="cpu")
        else:
            sim = JSimulator(JSimConfig(**kw))
            s = JVioSystem(options(JOptions()))
            s.fdb_native = None
        examples.live_calibrate(s, sim, float(sim.imu_t[0]))
        for kind, args in examples.track_events(sim, lines=True):
            examples.feed(s, kind, args)
        errs = [np.linalg.norm(np.asarray(p) - np.asarray(sim.gt_kin(t)["p_IinG"]))
                for t, _, p in s.traj]
        return float(np.sqrt(np.mean(np.square(errs)))), s.stats

    _, options, _ = _line_scenario("lines_mono")
    for seed in (3, 7, 8, 11):
        (a, sa), (b, sb) = run(True, seed), run(False, seed)
        print(f"seed {seed}: port RMSE {a:.6f} m, JAX {b:.6f} m, ratio {a / b:.5f}")
        assert a < 1.0 and abs(a / b - 1) < 0.01 and sa == sb

