"""The port's images-in frame against the JAX package, on the CPU.

`plviwo_tpu_torch.core.frame.track_frame` / `fused_frame(use_lines=False)`
(batch-first; on the CPU the LK and gate/Gram kernels' plain versions)
against the JAX `track_frame` / `fused_frame(use_lines=False)` with its XLA
defaults, on frames rendered by the JAX simulator.  RANSAC's hypotheses
come from JAX's threefry PRNG, which the port's counter hash does not
reproduce: the port draws them through `ops.klt.draw_hypotheses`, which
the parity tests replace with a replay of JAX's draws.  Also: the port's simulator and input
builders against the JAX ones, and its copies of the layout and the chi2
table.

Tolerances: track_frame `valid`, `n_obs`, `hist_slot` and the harvest mask
equal, `uv`/`hist_uv` within 1e-3 px, `hist_uvn`/`hist_t` within 1e-6;
fused_frame `accepted` and `wheel_accepted` equal per frame, max|dp| < 1e-5
and max|dcov| < 1e-4 max|cov| (the bounds of tests/test_torch_fused_step.py:
float32 camera tensors, another factorization order); the simulator's
landmarks equal, poses and IMU/wheel within 1e-9 (closed-form spline
derivatives against jax.jacfwd), frames within 1e-6.
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
from plviwo_tpu_torch.ops import klt
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


@pytest.fixture(scope="module")
def scene():
    """Frames, IMU and wheel windows of the JAX simulator for 6 frames."""
    sim = JSimulator(JSimConfig(**SIM))
    imu = sim.imu_stream()
    frames, t_prev = [], T0
    for i in range(6):
        t = T0 + 0.1 * (i + 1)
        frames.append(dict(t=t, img=sim.render_frame(t),
                           imu=_imu_window(*imu, t_prev, t),
                           wheel=_wheel_window(sim, t_prev, t)))
        t_prev = t
    return sim, frames


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


def test_track_frame_matches_jax(scene, monkeypatch):
    sim, frames = scene
    monkeypatch.setattr(klt, "draw_hypotheses", JaxDraws())
    k = np.asarray(sim.cfg.intrinsics)
    jts = j_make_track_state(480, 640, n_pts=N_PTS, max_lines=16, max_obs=6)
    tts = frame.make_track_state(480, 640, n_pts=N_PTS, max_obs=6, device="cpu")
    harvested = 0
    for i, f in enumerate(frames):
        jts, jh, _ = j_track_frame(jts, jnp.asarray(f["img"]), jnp.asarray(k),
                                   jnp.asarray(f["t"]), jnp.asarray(i, jnp.int32))
        tts, th = frame.track_frame(tts, _t(f["img"]), _t(k), torch.tensor([f["t"]], dtype=F64),
                                    torch.tensor([i]))
        for name in ("valid", "n_obs", "hist_slot"):
            np.testing.assert_array_equal(getattr(tts, name)[0].numpy(),
                                          np.asarray(getattr(jts, name)), err_msg=f"{i} {name}")
        np.testing.assert_array_equal(th[3][0].numpy(), np.asarray(jh[3]), err_msg=f"{i} mask")
        for name, tol in (("uv", 1e-3), ("hist_uv", 1e-3), ("hist_uvn", 1e-6)):
            np.testing.assert_allclose(getattr(tts, name)[0].numpy(), np.asarray(getattr(jts, name)),
                                       rtol=0, atol=tol, err_msg=f"{i} {name}")
        np.testing.assert_allclose(tts.hist_t[0].numpy(), np.asarray(jts.hist_t), rtol=0, atol=1e-6)
        harvested += int(jh[3].any(axis=1).sum())
    assert int(jts.valid.sum()) >= 48 and harvested > 0


def _run_jax(state, ts, f, gravity):
    return j_fused_frame(state, ts, jnp.asarray(f["img"]), *f["imu"], jnp.asarray(f["t"]),
                         *f["wheel"], jnp.asarray(True), gravity, SIGMAS, 1.5, 8.0, 2.0,
                         WHEEL_NOISE, use_lines=False, min_track=4)


def _run_torch(state, ts, fs, gravity):
    """One port frame over the sequences' frames fs (a list, one per b)."""
    def stack(get):
        return torch.as_tensor(np.stack([np.asarray(get(f)) for f in fs]))

    return frame.fused_frame(
        state, ts, stack(lambda f: f["img"]), *(stack(lambda f, i=i: f["imu"][i]) for i in range(3)),
        stack(lambda f: f["t"]), *(stack(lambda f, i=i: f["wheel"][i]) for i in range(3)),
        torch.ones(len(fs), dtype=torch.bool), gravity, SIGMAS, 1.5, 8.0, 2.0, WHEEL_NOISE,
        use_lines=False, min_track=4)


def _assert_frame_close(tstate, tm, jstate, jm, b=0):
    for k in ("accepted", "wheel_accepted", "tracked", "harvested"):
        assert int(tm[k][b]) == int(jm[k]), (k, int(tm[k][b]), int(jm[k]))
    assert np.max(np.abs(tstate.p[b].numpy() - np.asarray(jstate.p))) < 1e-5
    cov = np.asarray(jstate.cov)
    assert np.max(np.abs(tstate.cov[b].numpy() - cov)) < 1e-4 * np.max(np.abs(cov))


def _sequences(sim, frames, n_seq, layout=LAYOUT, n_frames=4):
    """Per-sequence inputs: the JAX state seeded from ground truth (moved
    by 1 cm per sequence) and the frames with per-sequence pixel noise."""
    base = _seed_state(sim, JLayout(**layout), T0)
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
    if n_seq == 2:
        assert not torch.equal(tstate.p[0], tstate.p[1])


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
    """The port's own frames (its RANSAC hash, no replay) over the sequences
    of `seqs` as one batch; returns per-frame (state, ts, metrics)."""
    tstate = FilterState.from_numpy([_jax_state_arrays(s) for s in jstates],
                                    jstates[0].layout, device="cpu")
    tts = frame.make_track_state(480, 640, n_pts=N_PTS, max_obs=4, seed=seed,
                                 batch=len(seqs), device="cpu")
    tg = torch.tensor([0.0, 0.0, 9.81], dtype=F64)
    out = []
    for i in range(n_frames):
        tstate, tts, tm = _run_torch(tstate, tts, [s[i] for s in seqs], tg)
        out.append((tstate, tts, tm))
    return out


def test_fused_frame_batch_equals_single_sequences(scene):
    """Sequence b of a B = 3 batch (keys 0, 1, 2) runs as it does alone
    with seed b: each sequence's RANSAC draws depend on its own key and
    frame counter only."""
    sim, frames = scene
    jstates, seqs = _sequences(sim, frames, 3)
    batch = _port_frames(seqs, jstates, 4, seed=0)
    for b in range(3):
        alone = _port_frames(seqs[b:b + 1], jstates[b:b + 1], 4, seed=b)
        for (s3, t3, m3), (s1, t1, m1) in zip(batch, alone):
            for k in ("accepted", "wheel_accepted", "tracked", "harvested"):
                assert int(m3[k][b]) == int(m1[k][0]), (b, k)
            for name in ("valid", "n_obs"):
                assert torch.equal(getattr(t3, name)[b], getattr(t1, name)[0]), (b, name)
            assert float((s3.p[b] - s1.p[0]).abs().max()) < 1e-5
            sc = float(s1.cov[0].abs().max())
            assert float((s3.cov[b] - s1.cov[0]).abs().max()) < 1e-4 * sc
    assert sum(int(m["accepted"].sum()) for _, _, m in batch) > 0


def test_track_frame_twice_from_one_state_is_identical(scene):
    """A TrackState is a value: one frame run twice from the same state
    gives the same tracks, histories, harvest and counter."""
    sim, frames = scene
    k = torch.as_tensor(np.asarray(sim.cfg.intrinsics))[None].expand(2, -1)
    ts = frame.make_track_state(480, 640, n_pts=N_PTS, max_obs=4, batch=2, device="cpu")

    def run(ts, i):
        img = torch.as_tensor(np.stack([frames[i]["img"]] * 2))
        return frame.track_frame(ts, img, k, torch.full((2,), frames[i]["t"], dtype=F64),
                                 torch.full((2,), i))

    ts, _ = run(ts, 0)
    (ta, ha), (tb, hb) = run(ts, 1), run(ts, 1)
    for f in dataclasses.fields(ta):
        assert torch.equal(getattr(ta, f.name), getattr(tb, f.name)), f.name
    assert all(torch.equal(x, y) for x, y in zip(ha, hb))
    assert int(ta.counter[0]) == 2 and int(ts.counter[0]) == 1 and int(ta.valid.sum()) > 0


def test_make_track_state_takes_jax_positional_arguments():
    """A positional call written for JAX's (height, width, n_pts, max_lines,
    max_obs, seed) gives the port the same n_pts, max_obs and key; batch
    and device are keyword-only."""
    t = frame.make_track_state(480, 640, 48, 16, 6, 3, device="cpu")
    j = j_make_track_state(480, 640, 48, 16, 6, 3)
    assert t.hist_uv.shape[1:] == (48, 6, 2) and j.hist_uv.shape == (48, 6, 2)
    assert t.key.tolist() == [3] and t.counter.tolist() == [0]
    assert frame.make_track_state(32, 32, 4, 2, 2, 5, batch=3, device="cpu").key.tolist() == [5, 6, 7]
    with pytest.raises(TypeError):
        frame.make_track_state(32, 32, 4, 2, 2, 5, 3)


@pytest.mark.parametrize("flag", ["use_lines", "use_gps", "use_stereo", "use_dynamic"])
def test_fused_frame_refuses_unported_options(flag):
    """Options the port does not run raise before any work, the JAX default
    use_lines=True included."""
    args = [None] * 17  # state, ts, img, the sensor inputs and constants
    with pytest.raises(NotImplementedError, match="ROADMAP A"):
        frame.fused_frame(*args, **{"use_lines": False, flag: True})
    if flag == "use_lines":
        with pytest.raises(NotImplementedError, match="A6b"):
            frame.fused_frame(*args)


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
