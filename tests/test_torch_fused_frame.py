"""The port's images-in frame against the JAX package, on the CPU.

`plviwo_tpu_torch.core.frame.track_frame` / `fused_frame` (batch-first; on
the CPU the LK and gate/Gram kernels' plain versions) against the JAX
`track_frame` / `fused_frame` with its XLA defaults, on frames rendered by
the JAX simulator: points and wheel (`use_lines=False`), and bench.py's
whole unit, points + lines + wheel + GPS (10 Hz fixes, 4 per frame at
most); `track_frame` also with `lk_conv=False`, both packages on their
gather LK.  RANSAC's hypotheses
come from JAX's threefry PRNG, which the port's counter hash does not
reproduce: the port draws them through `ops.klt.draw_hypotheses`, which
the parity tests replace with a replay of JAX's draws.  Also: the port's simulator and input
builders against the JAX ones, and its copies of the layout and the chi2
table.

Tolerances: track_frame `valid`, `n_obs`, `hist_slot` and the harvest mask
equal, `uv`/`hist_uv` within 1e-3 px, `hist_uvn`/`hist_t` within 1e-6; its
line fields `lvalid`, `l_nobs`, `lhist_slot`, `lattach` and the line
harvest mask equal, `lseg`/`lhist_uv` within 1e-3 px, `lhist_uvn` within
1e-6; fused_frame `accepted`, `wheel_accepted` (with lines and GPS also
`lines_accepted`, `gps_accepted`, `line_tracked`, `line_harvested`), `tracked`
and `harvested` equal per frame, max|dp| < 1e-5
and max|dcov| < 1e-4 max|cov| (the bounds of tests/test_torch_fused_step.py:
float32 camera tensors, another factorization order); the simulator's
landmarks equal, poses and IMU/wheel within 1e-9 (closed-form spline
derivatives against jax.jacfwd), frames within 1e-6, GPS fix times equal
and samples within 1e-9.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plviwo_tpu.core.frame import fused_frame as j_fused_frame
from plviwo_tpu.core.frame import make_track_state as j_make_track_state
from plviwo_tpu.core.frame import track_frame as j_track_frame
from plviwo_tpu.core.layout import StateLayout as JLayout
from plviwo_tpu.ops.chi2 import _TABLE as J_CHI2
from plviwo_tpu.sim.simulator import SimConfig as JSimConfig
from plviwo_tpu.sim.simulator import Simulator as JSimulator
from plviwo_tpu_torch import examples
from plviwo_tpu_torch.core import frame
from plviwo_tpu_torch.core.layout import StateLayout
from plviwo_tpu_torch.core.state import FilterState
from plviwo_tpu_torch.ops import klt, lk_kernel
from plviwo_tpu_torch.ops.chi2 import _TABLE as T_CHI2
from plviwo_tpu_torch.sim.simulator import SimConfig, Simulator
from tests.test_fused_frame import _imu_window, _seed_state, _wheel_window

torch.set_num_threads(1)
F64 = torch.float64
SIM = dict(duration=6.0, n_landmarks=350, n_lines=40, seed=3)
LAYOUT = dict(n_clones=6, n_cams=1, use_wheel=True)
T0, N_PTS = 1.0, 64
SIGMAS = (1.7e-4, 2.0e-3, 1.9e-5, 3.0e-3)
WHEEL_NOISE = (0.05, 0.05, 0.02)
GPS_PAD, GPS_HZ = 4, 10.0
LINES_SEED = 11


class JaxDraws:
    """Stands in for `klt.draw_hypotheses`: replays, from each sequence's
    key and frame counter, the draws of JAX's track_frame for a sequence
    whose key started at PRNGKey(key) and was split once per tracked frame,
    and of ransac_fundamental (split again, two randint calls)."""

    def __call__(self, key, counter, n_hyp, n):
        draws = []
        for seed, count in zip(key.tolist(), counter.tolist()):
            k = jax.random.PRNGKey(seed)
            for _ in range(count + 1):
                k, sub = jax.random.split(k)
            k1, k2 = jax.random.split(sub)
            draws.append([np.asarray(jax.random.randint(kk, (n_hyp, 1), 0, n))[:, 0]
                          for kk in (k1, k2)])
        return tuple(torch.as_tensor(np.stack([d[j] for d in draws])).long() for j in (0, 1))


def _t(a):
    return torch.as_tensor(np.asarray(a))[None]


def _jax_state_arrays(st):
    return {f.name: np.asarray(getattr(st, f.name))
            for f in dataclasses.fields(st) if f.name != "layout"}


def _scene(seed, n_frames):
    """Frames, IMU and wheel windows of the JAX simulator, and per frame
    the GPS fixes in (t_prev, t] of a 10 Hz stream (drawn after the
    frames), padded to GPS_PAD as bench.py pads them."""
    sim = JSimulator(JSimConfig(**dict(SIM, seed=seed)))
    imu = sim.imu_stream()
    frames, t_prev = [], T0
    for i in range(n_frames):
        t = T0 + 0.1 * (i + 1)
        frames.append(dict(t=t, img=sim.render_frame(t),
                           imu=_imu_window(*imu, t_prev, t),
                           wheel=_wheel_window(sim, t_prev, t)))
        t_prev = t
    fixes = [(t, np.asarray(sim.gps_sample(t)))
             for t in T0 + 0.05 + np.arange(n_frames + 1) / GPS_HZ]
    t_prev = T0
    for f in frames:
        gt, gp, gv = np.full(GPS_PAD, f["t"]), np.zeros((GPS_PAD, 3)), np.zeros(GPS_PAD, bool)
        for j, (ft, fp) in enumerate([x for x in fixes if t_prev < x[0] <= f["t"]][:GPS_PAD]):
            gt[j], gp[j], gv[j] = ft, fp, True
        f["gps"] = (gt, gp, gv)
        t_prev = f["t"]
    return sim, frames


@pytest.fixture(scope="module")
def scene():
    """Six frames of the simulator with the bench's seed."""
    return _scene(SIM["seed"], 6)


@pytest.fixture(scope="module")
def lines_scene():
    """Four frames of a simulator whose seed gives accepted line rows by the
    fourth frame (lines need a few frames of track before they triangulate)."""
    return _scene(LINES_SEED, 4)


@pytest.mark.parametrize("kw", [dict(), dict(n_clones=14, use_wheel=True),
                                dict(n_clones=8, n_cams=2, max_slam=5, n_gps=1),
                                dict(n_clones=3, use_wheel=True, n_gps=2)])
def test_layout_copy_matches_jax(kw):
    t, j = StateLayout(**kw), JLayout(**kw)
    assert t.dim == j.dim
    names = ("clone_off", "cam_off", "wheel_off", "wheel_dt", "wheel_ext", "wheel_int",
             "gps_off", "wtoe_off", "slam_off")
    assert [getattr(t, n) for n in names] == [getattr(j, n) for n in names]
    for i in range(t.n_clones):
        assert t.clone(i) == j.clone(i)
    for i in range(t.n_cams):
        assert (t.cam_dt(i), t.cam_ext(i), t.cam_int(i)) == (j.cam_dt(i), j.cam_ext(i), j.cam_int(i))
    for i in range(t.n_gps):
        assert (t.gps_dt(i), t.gps_ext(i)) == (j.gps_dt(i), j.gps_ext(i))


def test_chi2_table_copy_matches_jax():
    np.testing.assert_array_equal(T_CHI2, J_CHI2)


def test_simulator_and_builders_match_jax():
    js, ts = JSimulator(JSimConfig(**SIM)), Simulator(SimConfig(**SIM))
    np.testing.assert_array_equal(ts.landmarks, js.landmarks)
    np.testing.assert_array_equal(ts.bg_true, js.bg_true)
    for t in (0.0, 1.0, 2.37, 5.9):
        for a, b in zip(ts.gt_pose(t), js.gt_pose(t)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-9)
    for a, b in zip(ts.imu_stream(), js.imu_stream()):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-9)
    for t in (1.3, 1.4):
        np.testing.assert_allclose(ts.render_frame(t), js.render_frame(t), rtol=0, atol=1e-6)
    lj = JLayout(**LAYOUT)
    want = _jax_state_arrays(_seed_state(js, lj, T0))
    got = examples.seed_state(ts, StateLayout(**LAYOUT), T0)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-9, err_msg=k)
    imu = ts.imu_stream(), js.imu_stream()
    for a, b in zip(examples.imu_window(*imu[0], 1.0, 1.1), _imu_window(*imu[1], 1.0, 1.1)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-9)
    for a, b in zip(examples.wheel_window(ts, 1.0, 1.1), _wheel_window(js, 1.0, 1.1)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-9)
    # GPS fixes draw from the same generator, after the draws above
    np.testing.assert_array_equal(ts.gps_times(), js.gps_times())
    for t in js.gps_times()[:4]:
        np.testing.assert_allclose(ts.gps_sample(t), np.asarray(js.gps_sample(t)), rtol=0,
                                   atol=1e-9)
    np.testing.assert_array_equal(ts.rng.normal(size=3), js.rng.normal(size=3))


def _track_frame_parity(scene, monkeypatch, lk_conv):
    sim, frames = scene
    monkeypatch.setattr(klt, "draw_hypotheses", JaxDraws())
    k = np.asarray(sim.cfg.intrinsics)
    jts = j_make_track_state(480, 640, n_pts=N_PTS, max_lines=16, max_obs=6)
    tts = frame.make_track_state(480, 640, n_pts=N_PTS, max_lines=16, max_obs=6, device="cpu")
    harvested = line_harvested = 0
    for i, f in enumerate(frames):
        jts, jh, jlh = j_track_frame(jts, jnp.asarray(f["img"]), jnp.asarray(k),
                                     jnp.asarray(f["t"]), jnp.asarray(i, jnp.int32),
                                     lk_conv=lk_conv)
        tts, th, tlh = frame.track_frame(tts, _t(f["img"]), _t(k),
                                         torch.tensor([f["t"]], dtype=F64), torch.tensor([i]),
                                         lk_conv=lk_conv)
        for name in ("valid", "n_obs", "hist_slot", "lvalid", "l_nobs", "lhist_slot", "lattach"):
            np.testing.assert_array_equal(getattr(tts, name)[0].numpy(),
                                          np.asarray(getattr(jts, name)), err_msg=f"{i} {name}")
        np.testing.assert_array_equal(th[3][0].numpy(), np.asarray(jh[3]), err_msg=f"{i} mask")
        np.testing.assert_array_equal(tlh[3][0].numpy(), np.asarray(jlh[3]),
                                      err_msg=f"{i} line mask")
        for name, tol in (("uv", 1e-3), ("hist_uv", 1e-3), ("hist_uvn", 1e-6), ("lseg", 1e-3),
                          ("lhist_uv", 1e-3), ("lhist_uvn", 1e-6)):
            np.testing.assert_allclose(getattr(tts, name)[0].numpy(), np.asarray(getattr(jts, name)),
                                       rtol=0, atol=tol, err_msg=f"{i} {name}")
        for name in ("hist_t", "lhist_t"):
            np.testing.assert_allclose(getattr(tts, name)[0].numpy(), np.asarray(getattr(jts, name)),
                                       rtol=0, atol=1e-6, err_msg=f"{i} {name}")
        harvested += int(jh[3].any(axis=1).sum())
        line_harvested += int(jlh[3].any(axis=1).sum())
    assert int(jts.valid.sum()) >= 48 and harvested > 0
    assert int(jts.lvalid.sum()) >= 4 and line_harvested > 0


def test_track_frame_matches_jax(scene, monkeypatch):
    _track_frame_parity(scene, monkeypatch, lk_conv=True)


def test_track_frame_gather_lk_matches_jax(scene, monkeypatch):
    """`cam.fused_lk_conv=False`: both frames track with their gather LK
    (JAX's `klt.pyramidal_lk`, the port's plain-torch copy), held to the
    same tolerances.  The detector's score is JAX's compiled one (as in
    tests/test_torch_host_tracker.py): on this run two cells' maxima tie
    at the rounding level by the fourth frame, and the port's own score
    orders them the other way."""
    from tests.test_torch_host_tracker import jax_score

    monkeypatch.setattr(klt, "shi_tomasi_score", jax_score)
    launches = lk_kernel.lk_pyramid.launches
    _track_frame_parity(scene, monkeypatch, lk_conv=False)
    assert lk_kernel.lk_pyramid.launches == launches


def _run_jax(state, ts, f, gravity, lines_gps=False):
    kw = dict(use_lines=False)
    if lines_gps:
        kw = dict(use_gps=True, gps_t=jnp.asarray(f["gps"][0]), gps_p=jnp.asarray(f["gps"][1]),
                  gps_valid=jnp.asarray(f["gps"][2]), sigma_gps=0.5, gps_chi2_mult=8.0)
    return j_fused_frame(state, ts, jnp.asarray(f["img"]), *f["imu"], jnp.asarray(f["t"]),
                         *f["wheel"], jnp.asarray(True), gravity, SIGMAS, 1.5, 8.0, 2.0,
                         WHEEL_NOISE, min_track=4, **kw)


def _run_torch(state, ts, fs, gravity, lines_gps=False):
    """One port frame over the sequences' frames fs (a list, one per b);
    points and wheel, or with lines_gps bench.py's whole unit."""
    def stack(get):
        return torch.as_tensor(np.stack([np.asarray(get(f)) for f in fs]))

    kw = dict(use_lines=False)
    if lines_gps:
        kw = dict(use_gps=True, gps_t=stack(lambda f: f["gps"][0]),
                  gps_p=stack(lambda f: f["gps"][1]), gps_valid=stack(lambda f: f["gps"][2]),
                  sigma_gps=0.5, gps_chi2_mult=8.0)
    return frame.fused_frame(
        state, ts, stack(lambda f: f["img"]), *(stack(lambda f, i=i: f["imu"][i]) for i in range(3)),
        stack(lambda f: f["t"]), *(stack(lambda f, i=i: f["wheel"][i]) for i in range(3)),
        torch.ones(len(fs), dtype=torch.bool), gravity, SIGMAS, 1.5, 8.0, 2.0, WHEEL_NOISE,
        min_track=4, **kw)


COUNTS = ("accepted", "wheel_accepted", "tracked", "harvested")
LINE_GPS_COUNTS = COUNTS + ("lines_accepted", "gps_accepted", "line_tracked", "line_harvested")


def _assert_frame_close(tstate, tm, jstate, jm, b=0, counts=COUNTS):
    for k in counts:
        assert int(tm[k][b]) == int(jm[k]), (k, int(tm[k][b]), int(jm[k]))
    assert np.max(np.abs(tstate.p[b].numpy() - np.asarray(jstate.p))) < 1e-5
    cov = np.asarray(jstate.cov)
    assert np.max(np.abs(tstate.cov[b].numpy() - cov)) < 1e-4 * np.max(np.abs(cov))


def _sequences(sim, frames, n_seq, layout=LAYOUT, n_frames=4):
    """Per-sequence inputs: the JAX state seeded from ground truth (moved
    by 1 cm per sequence; with a GPS block, the simulator's lever arm as
    bench.py sets it) and the frames with per-sequence pixel noise."""
    base = _seed_state(sim, JLayout(**layout), T0)
    if base.gps_p.shape[0]:
        base = base.replace(gps_p=base.gps_p.at[0].set(jnp.asarray(sim.cfg.gps_ext_p)))
    states, seqs = [], []
    for b in range(n_seq):
        states.append(base.replace(p=base.p + 0.01 * b, p_fej=base.p_fej + 0.01 * b))
        rng = np.random.default_rng(100 + b)
        seqs.append([dict(f, img=np.clip(f["img"] + (2e-3 * b) * rng.normal(size=f["img"].shape),
                                         0, 1).astype(np.float32)) for f in frames[:n_frames]])
    return states, seqs


@pytest.mark.parametrize("n_seq", [1, 2])
def test_fused_frame_matches_jax(scene, monkeypatch, n_seq):
    """Four images-in frames; with n_seq = 2 the batch holds two sequences
    that differ (state, pixel noise, RANSAC key), each held to its own JAX
    run."""
    sim, frames = scene
    monkeypatch.setattr(klt, "draw_hypotheses", JaxDraws())
    jstates, seqs = _sequences(sim, frames, n_seq)
    tstate = FilterState.from_numpy([_jax_state_arrays(s) for s in jstates],
                                    jstates[0].layout, device="cpu")
    tts = frame.make_track_state(480, 640, n_pts=N_PTS, max_obs=4, batch=n_seq, device="cpu")
    jtss = [j_make_track_state(480, 640, n_pts=N_PTS, max_lines=16, max_obs=4, seed=b)
            for b in range(n_seq)]
    jg, tg = jnp.asarray([0.0, 0.0, 9.81]), torch.tensor([0.0, 0.0, 9.81], dtype=F64)
    accepted = 0
    for i in range(4):
        tstate, tts, tm = _run_torch(tstate, tts, [s[i] for s in seqs], tg)
        for b in range(n_seq):
            jstates[b], jtss[b], jm = _run_jax(jstates[b], jtss[b], seqs[b][i], jg)
            _assert_frame_close(tstate, tm, jstates[b], jm, b)
            accepted += int(jm["accepted"])
    assert accepted > 0 and int(tm["wheel_accepted"].sum()) == n_seq
    # without line rows the line front-end is skipped: no line slot is used
    assert not tts.lvalid.any() and int(tm["line_tracked"].sum()) == 0
    if n_seq == 2:
        assert not torch.equal(tstate.p[0], tstate.p[1])


LINES_GPS_LAYOUT = dict(LAYOUT, n_gps=1)


@pytest.fixture(scope="module")
def lines_gps_run(lines_scene):
    """Two sequences through four frames of bench.py's whole unit in JAX
    (one compile): per sequence the seeded state, its inputs, and per frame
    the JAX state and metrics."""
    sim, frames = lines_scene
    jstates, seqs = _sequences(sim, frames, 2, LINES_GPS_LAYOUT)
    jg = jnp.asarray([0.0, 0.0, 9.81])
    runs = []
    for b in range(2):
        st, jts, out = jstates[b], j_make_track_state(480, 640, N_PTS, 16, 4, b), []
        for f in seqs[b]:
            st, jts, jm = _run_jax(st, jts, f, jg, lines_gps=True)
            out.append((st, jm))
        runs.append(out)
    return jstates, seqs, runs


@pytest.mark.parametrize("n_seq", [1, 2])
def test_fused_frame_lines_gps_matches_jax(lines_gps_run, monkeypatch, n_seq):
    """Four frames of points + lines + wheel + GPS; with n_seq = 2 two
    sequences that differ (state, pixel noise, RANSAC key) in one batch,
    each held to its own JAX run.  Every sensor's rows are accepted."""
    jstates, seqs, runs = lines_gps_run
    monkeypatch.setattr(klt, "draw_hypotheses", JaxDraws())
    tstate = FilterState.from_numpy([_jax_state_arrays(s) for s in jstates[:n_seq]],
                                    jstates[0].layout, device="cpu")
    tts = frame.make_track_state(480, 640, N_PTS, 16, 4, batch=n_seq, device="cpu")
    tg = torch.tensor([0.0, 0.0, 9.81], dtype=F64)
    totals = dict.fromkeys(LINE_GPS_COUNTS, 0)
    for i in range(4):
        tstate, tts, tm = _run_torch(tstate, tts, [s[i] for s in seqs[:n_seq]], tg, lines_gps=True)
        for b in range(n_seq):
            jstate, jm = runs[b][i]
            _assert_frame_close(tstate, tm, jstate, jm, b, LINE_GPS_COUNTS)
            for k in totals:
                totals[k] += int(jm[k])
    assert min(totals.values()) > 0, totals


def test_fused_frame_clone_ring_wrap_matches_jax(scene, monkeypatch):
    """Five frames through a 3-clone ring: the forced drop of the oldest
    clone and the liveness test that rejects observations on a reused slot
    run, and the port still equals JAX frame by frame."""
    sim, frames = scene
    layout = dict(LAYOUT, n_clones=3)
    monkeypatch.setattr(klt, "draw_hypotheses", JaxDraws())
    dropped = []

    def counting_liveness(state, hist_slot, hist_t, obs_mask):
        live = liveness(state, hist_slot, hist_t, obs_mask)
        dropped.append(int((obs_mask & ~live).sum()))
        return live

    liveness = frame._liveness
    monkeypatch.setattr(frame, "_liveness", counting_liveness)
    jstates, seqs = _sequences(sim, frames, 1, layout, n_frames=5)
    tstate = FilterState.from_numpy([_jax_state_arrays(jstates[0])], jstates[0].layout,
                                    device="cpu")
    tts = frame.make_track_state(480, 640, n_pts=N_PTS, max_obs=4, device="cpu")
    jts = j_make_track_state(480, 640, n_pts=N_PTS, max_lines=16, max_obs=4)
    jg, tg = jnp.asarray([0.0, 0.0, 9.81]), torch.tensor([0.0, 0.0, 9.81], dtype=F64)
    for f in seqs[0]:
        tstate, tts, tm = _run_torch(tstate, tts, [f], tg)
        jstates[0], jts, jm = _run_jax(jstates[0], jts, f, jg)
        _assert_frame_close(tstate, tm, jstates[0], jm)
    assert int(tstate.clone_valid.sum()) == 3 and sum(dropped) > 0


def _port_frames(seqs, jstates, n_frames, seed):
    """The port's own frames (its RANSAC hash, no replay) of points + lines
    + wheel + GPS over the sequences of `seqs` as one batch; returns
    per-frame (state, ts, metrics)."""
    tstate = FilterState.from_numpy([_jax_state_arrays(s) for s in jstates],
                                    jstates[0].layout, device="cpu")
    tts = frame.make_track_state(480, 640, n_pts=N_PTS, max_lines=16, max_obs=4, seed=seed,
                                 batch=len(seqs), device="cpu")
    tg = torch.tensor([0.0, 0.0, 9.81], dtype=F64)
    out = []
    for i in range(n_frames):
        tstate, tts, tm = _run_torch(tstate, tts, [s[i] for s in seqs], tg, lines_gps=True)
        out.append((tstate, tts, tm))
    return out


def test_fused_frame_batch_equals_single_sequences(lines_scene):
    """Sequence b of a B = 3 batch (keys 0, 1, 2) runs as it does alone
    with seed b: each sequence's RANSAC draws depend on its own key and
    frame counter only."""
    sim, frames = lines_scene
    jstates, seqs = _sequences(sim, frames, 3, LINES_GPS_LAYOUT)
    batch = _port_frames(seqs, jstates, 4, seed=0)
    for b in range(3):
        alone = _port_frames(seqs[b:b + 1], jstates[b:b + 1], 4, seed=b)
        for (s3, t3, m3), (s1, t1, m1) in zip(batch, alone):
            for k in LINE_GPS_COUNTS:
                assert int(m3[k][b]) == int(m1[k][0]), (b, k)
            for name in ("valid", "n_obs", "lvalid", "l_nobs", "lattach"):
                assert torch.equal(getattr(t3, name)[b], getattr(t1, name)[0]), (b, name)
            assert float((s3.p[b] - s1.p[0]).abs().max()) < 1e-5
            sc = float(s1.cov[0].abs().max())
            assert float((s3.cov[b] - s1.cov[0]).abs().max()) < 1e-4 * sc
    for k in ("accepted", "lines_accepted", "gps_accepted"):
        assert sum(int(m[k].sum()) for _, _, m in batch) > 0, k


def test_track_frame_twice_from_one_state_is_identical(scene):
    """A TrackState is a value: one frame run twice from the same state
    gives the same point and line tracks, histories, harvests and counter."""
    sim, frames = scene
    k = torch.as_tensor(np.asarray(sim.cfg.intrinsics))[None].expand(2, -1)
    ts = frame.make_track_state(480, 640, n_pts=N_PTS, max_lines=16, max_obs=4, batch=2,
                                device="cpu")

    def run(ts, i):
        img = torch.as_tensor(np.stack([frames[i]["img"]] * 2))
        return frame.track_frame(ts, img, k, torch.full((2,), frames[i]["t"], dtype=F64),
                                 torch.full((2,), i))

    ts = run(ts, 0)[0]
    (ta, *ha), (tb, *hb) = run(ts, 1), run(ts, 1)
    for f in dataclasses.fields(ta):
        assert torch.equal(getattr(ta, f.name), getattr(tb, f.name)), f.name
    assert all(torch.equal(x, y) for h, g in zip(ha, hb) for x, y in zip(h, g))
    assert int(ta.counter[0]) == 2 and int(ts.counter[0]) == 1 and int(ta.valid.sum()) > 0
    assert int(ta.lvalid.sum()) > 0


def test_make_track_state_takes_jax_positional_arguments():
    """A positional call written for JAX's (height, width, n_pts, max_lines,
    max_obs, seed) gives the port the same n_pts, max_lines, max_obs and
    key; batch and device are keyword-only."""
    t = frame.make_track_state(480, 640, 48, 16, 6, 3, device="cpu")
    j = j_make_track_state(480, 640, 48, 16, 6, 3)
    assert t.hist_uv.shape[1:] == (48, 6, 2) and j.hist_uv.shape == (48, 6, 2)
    assert t.lhist_uv.shape[1:] == (16, 6, 4) and j.lhist_uv.shape == (16, 6, 4)
    assert t.lattach.shape[1:] == (16, 48) and j.lattach.shape == (16, 48)
    assert t.key.tolist() == [3] and t.counter.tolist() == [0]
    assert frame.make_track_state(32, 32, 4, 2, 2, 5, batch=3, device="cpu").key.tolist() == [5, 6, 7]
    with pytest.raises(TypeError):
        frame.make_track_state(32, 32, 4, 2, 2, 5, 3)


@pytest.mark.parametrize("entry", ["make_state", "from_numpy", "batch_args", "example_inputs",
                                   "make_track_state"])
def test_entry_points_default_to_the_card(entry):
    """Without device="cpu" the entry points put their tensors on the card,
    and raise where there is none."""
    from plviwo_tpu_torch.core.state import make_state

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is usable")
    layout = StateLayout(**LAYOUT)
    calls = {
        "make_state": lambda: make_state(layout),
        "from_numpy": lambda: FilterState.from_numpy(
            make_state(layout, device="cpu").to_numpy(), layout),
        "batch_args": lambda: examples.batch_args(examples.example_inputs(device="cpu"), 2),
        "example_inputs": lambda: examples.example_inputs(),
        "make_track_state": lambda: frame.make_track_state(32, 32, 4, 2, 2),
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]()


@pytest.mark.slow
def test_closed_loop_tracks_the_trajectory():
    """Sixty images-in frames of points, lines and wheel from the
    ground-truth seed (the configuration and gates of
    tests/test_fused_frame.py::test_fused_frame_e2e_tracks_trajectory, with
    the bench's float32 camera tensors), one sequence with pixel noise."""
    sim = Simulator(SimConfig(duration=10.0, n_landmarks=350, n_lines=40, seed=3))
    out = examples.closed_loop(sim, 1, 60, torch.Generator().manual_seed(7))
    assert np.isfinite(out["errs"]).all()
    assert out["rmse"][0] < 0.32 and out["final"][0] < 0.45, (out["rmse"], out["final"])
    assert out["accepted"][0] > 50 and out["wheel_accepted"][0] > 30
    assert out["lines_accepted"][0] > 0
