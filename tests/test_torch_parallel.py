"""The port's distributed layer (`plviwo_tpu_torch/parallel/`) against the
JAX package's, on the CPU.

Ranks are spawned processes on the Gloo backend (`replay.run_rank_jobs`,
file rendezvous in a fresh directory); each multi-rank test runs under the
launcher's own timeout, so a hung rank fails its test instead of hanging
it, and the ranks of one world size are started once per module.

Tolerances:
- BA: the shard blocks (H_red, b_red, H_ll, b_l, H_pl) within 1e-9 of JAX's
  `_reduced_system_shard`, relative to each block's largest entry (closed-form
  Jacobians and `index_add` against `jacfwd` and a one-hot product: rounding
  only); `ba_refine` within 1e-9 of JAX's on poses and landmarks; JAX's
  convergence gate (rms1 < 0.05 rms0, sim3-aligned error < 0.01 m); 2 and 4
  ranks against one process within tests/test_ba.py's 1e-8 on poses and
  1e-7 on landmarks (the reduced system sums in another order).
- Replay: `build_sequence_inputs` within 1e-12 of JAX's on the float arrays
  (undistortion's Newton steps in another library), equal on the rest;
  `seed_state` within 1e-15; the sharded full step at world 2 equal to one
  process bit for bit, its summed counts equal to JAX's `batched_full_step`
  summed at the same B (JAX's XLA path counts rows after the projection, its
  kernel path and the port before it: rows = JAX's + 3 accepted), the mean
  reprojection error sum within 1e-6 (float32 camera tensors against JAX's
  float64).
- The worker's shard bit for bit equal to its one-process run; the fused
  frame at world 2 bit for bit equal to one process.
- The leftover functions within 1e-12 of JAX's (exact for the slots and
  masks; the QR projection up to each row's sign, which LAPACK may flip).
- Slow: the config-5 flow at tests/test_batch_replay.py's settings held to
  that test's gates, each sequence's ate_before_m within 1.5x of JAX's.
"""

import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plviwo_tpu.parallel import ba as jba
from plviwo_tpu_torch.core.layout import StateLayout
from plviwo_tpu_torch.core.state import FilterState
from plviwo_tpu_torch.parallel import ba, batch_replay, dryrun, replay, scaling

from test_ba import CAM_P, CAM_Q, _make_problem, _reproj_rms

REPO = Path(__file__).resolve().parents[1]
LAUNCH_TIMEOUT = 300.0  # seconds for a spawned world, every job included


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _problem(n_lm=64):
    """tests/test_ba.py's problem (K 6, L 64, O 6), its first n_lm landmarks."""
    gt, init, obs = _make_problem()
    args = (init[0], init[1], init[2][:n_lm], *(o[:n_lm] for o in obs), np.asarray(CAM_Q),
            np.asarray(CAM_P))
    return gt, args


# landmarks of the sharded BA problems: 63 over 2 ranks pads one masked row
BA_LANDMARKS = {2: 63, 4: 64}


@pytest.fixture(scope="module")
def world2():
    """Every two-rank job of this module, on one pair of spawned ranks."""
    jobs = [(ba.ba_refine, _problem(BA_LANDMARKS[2])[1], dict(iters=4)),
            (dryrun.dryrun_rank, (), None), (scaling.measure_rank, (), dict(n_iter=2))]
    return replay.run_rank_jobs(jobs, 2, device="cpu", timeout=LAUNCH_TIMEOUT)


@pytest.fixture(scope="module")
def world4():
    return replay.run_rank_jobs([(ba.ba_refine, _problem(BA_LANDMARKS[4])[1], dict(iters=4))],
                                4, device="cpu", timeout=LAUNCH_TIMEOUT)


# ---------------------------------------------------------------------------
# BA
# ---------------------------------------------------------------------------

def test_reduced_system_shard_matches_jax():
    """The shard blocks against JAX's within 1e-9 relative."""
    _, init, obs = _make_problem()
    K = init[0].shape[0]
    J = jba._reduced_system_shard(jnp.asarray(init[2]), jnp.asarray(obs[0]),
                                  jnp.asarray(obs[1]), jnp.asarray(obs[2]),
                                  jnp.asarray(init[0]), jnp.asarray(init[1]), CAM_Q, CAM_P, K)
    T = ba._reduced_system_shard(_t(init[2]), _t(obs[0]).long(), _t(obs[1]), _t(obs[2]),
                                 _t(init[0]), _t(init[1]), _t(CAM_Q), _t(CAM_P), K)
    for name, a, b in zip(("H_red", "b_red", "H_ll", "b_l", "H_pl"), J, T):
        a = np.asarray(a)
        assert b.shape == a.shape, name
        assert np.max(np.abs(b.numpy() - a)) <= 1e-9 * np.max(np.abs(a)), name


def test_ba_refine_matches_jax_and_converges():
    """ba_refine within 1e-9 of JAX's, and JAX's convergence gate on it."""
    from plviwo_tpu.eval.align import umeyama

    gt, args = _problem()
    jq, jp, jl, jinfo = jba.ba_refine(*args[:6], CAM_Q, CAM_P, mesh=None, iters=8)
    pq, pp, lm, info = ba.ba_refine(*args, iters=8, device="cpu")
    for a, b in ((jq, pq), (jp, pp), (jl, lm)):
        assert np.max(np.abs(b.numpy() - np.asarray(a))) < 1e-9
    np.testing.assert_allclose(info["gain"].numpy(), np.asarray(jinfo["gain"]), rtol=1e-6,
                               atol=1e-15)
    rms0 = _reproj_rms(*args[:6])
    rms1 = _reproj_rms(pq.numpy(), pp.numpy(), lm.numpy(), *args[3:6])
    assert rms1 < rms0 * 0.05, (rms0, rms1)
    s, R, t = umeyama(pp.numpy(), gt[1], with_scale=True)
    pp_al = (s * (R @ pp.numpy().T)).T + t
    assert np.linalg.norm(pp_al - gt[1], axis=1).max() < 0.01


@pytest.mark.parametrize("world", [2, 4])
def test_ba_ranks_match_one_process(world, request):
    """Landmarks sharded over 2 Gloo ranks (63 landmarks: one masked padding
    row) and 4 (64) against one process: 1e-8 on poses, 1e-7 on landmarks
    (tests/test_ba.py's bounds); every rank ends with the same result."""
    _, args = _problem(BA_LANDMARKS[world])
    pq1, pp1, lm1, _ = ba.ba_refine(*args, iters=4, device="cpu")
    res = request.getfixturevalue(f"world{world}")
    for rank_jobs in res:
        pq, pp, lm, _ = rank_jobs[0]
        assert lm.shape == tuple(lm1.shape)
        np.testing.assert_allclose(pp, pp1.numpy(), atol=1e-8)
        np.testing.assert_allclose(pq, pq1.numpy(), atol=1e-8)
        np.testing.assert_allclose(lm, lm1.numpy(), atol=1e-7)
        np.testing.assert_array_equal(lm, res[0][0][2])


# ---------------------------------------------------------------------------
# replay
# ---------------------------------------------------------------------------

def test_backend_rule_and_shards():
    """NCCL only when every rank has a card of its own; a batch that does not
    divide over the ranks raises."""
    assert replay.backend_for("cuda", 1, 1) == "nccl"
    assert replay.backend_for("cuda", 4, 4) == "nccl"
    assert replay.backend_for("cuda", 2, 1) == "gloo"
    assert replay.backend_for("cpu", 2, 0) == "gloo"
    g = replay.RankGroup(1, 2, torch.device("cpu"), "gloo")
    assert replay.shard_slice(g, 6) == slice(3, 6)
    with pytest.raises(ValueError, match="does not divide"):
        replay.shard_slice(g, 3)


def test_step_no_lone_steps_a_lone_cpu_sequence_alone():
    """On the CPU `replay.step_no_lone` passes a batch of one to the step
    alone, as every larger batch (the CPU's operators round a sequence
    alike at every batch size; only the card's are paired): the step sees
    the batch it was given and its outputs come back as they are."""
    from plviwo_tpu_torch.examples import batch_args, example_inputs_full

    seen = []

    def step(state, *rest, **kw):
        seen.append((state.batch, rest, kw))
        return state, {"n": torch.ones(state.batch)}

    for B in (1, 2):
        state = batch_args(example_inputs_full(device="cpu"), B, device="cpu")[0]
        new, m = replay.step_no_lone(step, 1, state, 9.81, model=0)
        assert new is state and m["n"].shape == (B,)
    assert seen == [(1, (9.81,), {"model": 0}), (2, (9.81,), {"model": 0})]


def test_build_sequence_inputs_and_seed_state_match_jax(monkeypatch):
    """One 3 s sequence: JAX's arrays, array for array, and its seed state.
    JAX's simulator projects (and `build_sequence_inputs` undistorts) each frame's points
    eagerly, compiling anew for every point count; here `project` and
    `undistort` run jitted on rows padded to one length (row by row: the
    same values, one compile each)."""
    from plviwo_tpu.core.layout import StateLayout as JLayout
    from plviwo_tpu.ops import cam as jcam
    from plviwo_tpu.parallel import batch_replay as jbr
    from plviwo_tpu.sim.simulator import SimConfig as JConfig, Simulator as JSim
    from plviwo_tpu_torch.sim.simulator import SimConfig, Simulator

    def padded(fn, fill):
        jit_fn = jax.jit(fn, static_argnums=2)

        def call(x, k, model):
            x = np.asarray(x)
            rows = np.concatenate([x, np.broadcast_to(np.asarray(fill, x.dtype),
                                                      (256 - len(x), x.shape[1]))])
            return np.asarray(jit_fn(rows, k, model))[:len(x)]

        return call

    monkeypatch.setattr(jcam, "undistort", padded(jcam.undistort, [300.0, 200.0]))
    monkeypatch.setattr(jcam, "project", padded(jcam.project, [0.0, 0.0, 5.0]))
    kw = dict(duration=3.0, seed=10, n_pts=45, sigma_pix=0.8)
    n_frames = int((3.0 - 1.0) * 10.0) - 1
    jsim = JSim(JConfig(**kw))
    j = jbr.build_sequence_inputs(jsim, 1.0, n_frames, 10.0, 11, 32, 8, 12)
    sim = Simulator(SimConfig(**kw))
    t = batch_replay.build_sequence_inputs(sim, 1.0, n_frames, 10.0, 11, 32, 8, 12)
    assert set(t) == set(j)
    assert t["dropped"] == j["dropped"]
    for k in set(j) - {"dropped", "frames_obs"}:
        a, b = np.asarray(j[k]), t[k]
        assert a.shape == b.shape and a.dtype == b.dtype, k
        if a.dtype.kind == "f":
            assert np.max(np.abs(a - b), initial=0.0) < 1e-12, k
        else:
            assert np.array_equal(a, b), k
    assert len(t["frames_obs"]) == len(j["frames_obs"])
    for fa, fb in zip(j["frames_obs"], t["frames_obs"]):
        assert list(fa) == list(fb)
        for fid in fa:
            assert np.max(np.abs(np.asarray(fa[fid][1]) - fb[fid][1])) < 1e-12

    jst = jbr.seed_state(jsim, JLayout(n_clones=11, n_cams=1, use_wheel=True), 1.0)
    st = batch_replay.seed_state(sim, StateLayout(n_clones=11, n_cams=1, use_wheel=True), 1.0)
    for f in dataclasses.fields(jst):
        if f.name != "layout":
            np.testing.assert_allclose(st[f.name], np.asarray(getattr(jst, f.name)),
                                       rtol=0, atol=1e-15, err_msg=f.name)


def test_sharded_full_step_matches_one_process_and_jax(world2):
    """World 2: the gathered states equal one process at B = 2 bit for bit,
    each rank ran 2 gate/Gram calls (the plain version on the CPU, no
    launch), and the summed metrics match JAX's batched_full_step at B = 2."""
    from __graft_entry__ import SIGMA_LINE, WHEEL_NOISE, _batch_args, _example_inputs_full
    from plviwo_tpu.parallel.replay import batched_full_step as j_batched

    steps = [r[1]["step"] for r in world2]
    assert steps[0]["bitwise"] and steps[0]["dp"] == 0.0 and steps[0]["dcov"] == 0.0
    assert all(s["backend"] == "gloo" and s["device"] == "cpu" for s in steps)
    assert all(s["launches"] == {"lk_pyramid": 0, "msckf_gram_gate": 0, "line_runlen": 0}
               for s in steps)
    assert steps[0]["agg"] == steps[1]["agg"]
    b = _batch_args(_example_inputs_full(), 2, n_batched=16)
    _, jm = jax.jit(lambda *a: j_batched(*a, model=0, window_size=1.0))(
        *b[:21], SIGMA_LINE, WHEEL_NOISE)
    jagg = {k: np.asarray(jnp.sum(v)) for k, v in jm.items()}
    agg = steps[0]["agg"]
    assert set(agg) == set(jagg)
    for k in ("accepted", "lines_accepted", "wheel_accepted"):
        assert agg[k] == int(jagg[k]), k
    assert agg["rows"] == int(jagg["rows"]) + 3 * agg["accepted"]
    assert abs(agg["avg_reproj"] - float(jagg["avg_reproj"])) < 1e-6


def test_sharded_fused_frame_matches_one_process(world2):
    """World 2: the images-in frame at JAX's dry-run settings tracks points
    and its gathered p equals one process bit for bit."""
    frames = [r[1]["frame"] for r in world2]
    assert frames[0]["tracked"] > 0 and frames[0]["bitwise"] and frames[0]["dp"] == 0.0
    assert frames[0]["tracked"] == frames[1]["tracked"]


def test_failed_rank_fails_the_call():
    """A rank that raises ends the call with its traceback; no rank is left."""
    with pytest.raises(RuntimeError, match="does not divide"):
        replay.run_ranks(batch_replay.replay_rank, 2, kwargs=dict(n_seq=3), device="cpu",
                         timeout=LAUNCH_TIMEOUT)


def test_multiproc_worker_two_processes():
    """`python -m plviwo_tpu_torch.parallel.multiproc_worker` at world 2 on
    the CPU: each shard equals its one-process run bit for bit."""
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    cmd = [sys.executable, "-m", "plviwo_tpu_torch.parallel.multiproc_worker"]
    with tempfile.TemporaryDirectory() as tmp:
        init = (Path(tmp) / "rendezvous").as_uri()
        procs = [subprocess.Popen(cmd + [str(r), "2", init, "--device", "cpu"], cwd=REPO,
                                  env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True) for r in range(2)]
        outs = []
        try:
            for p in procs:
                outs.append((p.communicate(timeout=LAUNCH_TIMEOUT)[0], p.returncode))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    for out, rc in outs:
        lines = [ln for ln in out.splitlines() if ln.startswith("{")]
        assert rc == 0 and lines, out[-2000:]
        res = json.loads(lines[-1])
        assert res["global_devices"] == 2 and res["backend"] == "gloo"
        assert res["shard_equal"] and res["max_abs_dp"] == 0.0, res
        assert res["accepted"] > 0 and res["rows"] > 0, res


def test_scaling_sweep(capsys, world2):
    """`scaling --sweep` (1 rank, n_iter 2, in this process) prints JAX's
    keys with finite, positive rates; at 2 ranks each rank's `measure_rank`
    (what `measure` takes the slowest of) reads a finite, positive rate."""
    assert scaling.main(["--sweep", "--ranks", "1", "--device", "cpu", "--n-iter", "2"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {"mode", "b_per_dev", "physical_cores", "rows", "note"} <= set(out)
    assert [r["devices"] for r in out["rows"]] == [1]
    for r in out["rows"]:
        assert {"weak_efficiency", "comm_factor", "fps_sharded", "fps_solo_same_batch"} <= set(r)
        for k in ("fps_sharded", "fps_solo_same_batch", "weak_efficiency", "comm_factor"):
            assert math.isfinite(r[k]) and r[k] > 0, (k, r)
    assert "cost of sharding" in out["note"]
    for fps, backend in (r[2] for r in world2):
        assert math.isfinite(fps) and fps > 0 and backend == "gloo"


# ---------------------------------------------------------------------------
# the leftover functions of ported modules
# ---------------------------------------------------------------------------

def _state_pair(seed=0):
    """A JAX state and the port's twin (one sequence) with 6 clones of
    distinct times (slot 1 a keyframe, slot 4 invalid), 2 SLAM slots (one
    valid), a random symmetric covariance and a non-trivial orientation."""
    from plviwo_tpu.core.layout import StateLayout as JLayout
    from plviwo_tpu.core.state import make_state as j_make_state

    rng = np.random.default_rng(seed)
    jlo = JLayout(n_clones=6, n_cams=1, use_wheel=True, max_slam=2)
    js = j_make_state(jlo)
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    cq = rng.normal(size=(6, 4))
    cq /= np.linalg.norm(cq, axis=1, keepdims=True)
    A = rng.normal(size=(jlo.dim, jlo.dim))
    js = js.replace(
        q=jnp.asarray(q), q_fej=jnp.asarray(q), p=jnp.asarray(rng.normal(size=3)),
        v=jnp.asarray(rng.normal(size=3)), clone_q=jnp.asarray(cq),
        clone_q_fej=jnp.asarray(cq), clone_p=jnp.asarray(rng.normal(size=(6, 3))),
        clone_p_fej=jnp.asarray(rng.normal(size=(6, 3))),
        clone_t=jnp.asarray([0.3, 0.1, 0.5, 0.2, jnp.inf, 0.4]),
        clone_valid=jnp.asarray([True, True, True, True, False, True]),
        clone_keyframe=jnp.asarray([False, True, False, False, False, False]),
        slam_p=jnp.asarray(rng.normal(size=(2, 3))),
        slam_p_fej=jnp.asarray(rng.normal(size=(2, 3))),
        slam_valid=jnp.asarray([True, False]), cov=jnp.asarray(A @ A.T / jlo.dim))
    arrays = {f.name: np.asarray(getattr(js, f.name))
              for f in dataclasses.fields(js) if f.name != "layout"}
    lo = StateLayout(n_clones=6, n_cams=1, use_wheel=True, max_slam=2)
    return js, FilterState.from_numpy(arrays, lo, device="cpu")


def _leftover(name):
    """(JAX's result, the port's) of one leftover function, as numpy."""
    rng = np.random.default_rng(3)
    js, ts = _state_pair()
    if name == "rot_gtoi":
        from plviwo_tpu.core.state import rot_gtoi as j
        from plviwo_tpu_torch.core.state import rot_gtoi as t
        return [j(js)], [t(ts)[0]]
    if name == "oldest_clone_slot":
        from plviwo_tpu.core.state import oldest_clone_slot as j
        from plviwo_tpu_torch.core.state import oldest_clone_slot as t
        return [j(js)], [t(ts)[0]]
    if name == "num_clones":
        from plviwo_tpu.core.state import num_clones as j
        from plviwo_tpu_torch.core.state import num_clones as t
        return [j(js)], [t(ts)[0]]
    if name == "bounding_clones":
        from plviwo_tpu.core.interp import bounding_clones as j
        from plviwo_tpu_torch.core.interp import bounding_clones as t
        times = [0.25, 0.3, 0.05, 0.45, 0.6]  # between, on a clone, before, between, after
        jr = [j(js.clone_t, js.clone_valid, jnp.asarray(x)) for x in times]
        tr = t(ts.clone_t.expand(5, 6), ts.clone_valid.expand(5, 6),
               torch.tensor(times, dtype=torch.float64))
        return [np.stack([np.asarray(r[i]) for r in jr]) for i in range(4)], list(tr)
    if name == "nullspace_project":
        from plviwo_tpu.core.ekf import nullspace_project as j
        from plviwo_tpu_torch.core.ekf import nullspace_project as t
        Hf, Hx, r = rng.normal(size=(10, 3)), rng.normal(size=(10, 20)), rng.normal(size=10)
        jr = j(jnp.asarray(Hf), jnp.asarray(Hx), jnp.asarray(r))
        tr = t(_t(Hf)[None], _t(Hx)[None], _t(r)[None])
        # Q's columns are unique up to sign: align each projected row's sign
        sign = np.sign(np.sum(np.asarray(jr[0]) * tr[0][0].numpy(), axis=1))
        return list(jr), [tr[0][0] * _t(sign)[:, None], tr[1][0] * _t(sign), tr[2][0]]
    if name == "transform_state_to_enu":
        from plviwo_tpu.update.gps import transform_state_to_enu as j
        from plviwo_tpu_torch.update.gps import transform_state_to_enu as t
        yaw = 0.7
        R = np.array([[np.cos(yaw), -np.sin(yaw), 0.0], [np.sin(yaw), np.cos(yaw), 0.0],
                      [0.0, 0.0, 1.0]])
        p = np.array([3.0, -2.0, 0.5])
        jn, tn = j(js, jnp.asarray(R), jnp.asarray(p)), t(ts, _t(R)[None], _t(p)[None])
        names = ("q", "p", "v", "clone_q", "clone_p", "clone_p_fej", "slam_p", "cov")
        return [getattr(jn, n) for n in names], [getattr(tn, n)[0] for n in names]
    if name == "set_slope_table":
        from plviwo_tpu.core import dynamic_cloning as jd
        from plviwo_tpu_torch.core import dynamic_cloning as td
        table = {(10, 3): 0.002, (5, 1): 0.07}
        keys = [(10, 3), (5, 1), (20, 3), (7, 5)]
        jd.set_slope_table(table)
        td.set_slope_table(table)
        try:
            jv = [jd.slope(*k) for k in keys] + [jd.interp_noise_std(2.0, 10, 3)]
            tv = [td.slope(*k) for k in keys] + [td.interp_noise_std(2.0, 10, 3)]
        finally:
            jd.set_slope_table(None)
            td.set_slope_table(None)
        return [np.asarray(jv)], [np.asarray(tv)]
    raise KeyError(name)


@pytest.mark.parametrize("name", ["nullspace_project", "rot_gtoi", "oldest_clone_slot",
                                  "num_clones", "bounding_clones", "transform_state_to_enu",
                                  "set_slope_table"])
def test_leftover_function_matches_jax(name):
    """Each function of a ported module that had no port, against JAX's."""
    jr, tr = _leftover(name)
    assert len(jr) == len(tr)
    for a, b in zip(jr, tr):
        a = np.asarray(a)
        b = b.numpy() if torch.is_tensor(b) else np.asarray(b)
        assert a.shape == b.shape, (name, a.shape, b.shape)
        if a.dtype.kind in "biu":
            assert np.array_equal(a, b.astype(a.dtype)), name
        else:
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-12, err_msg=name)


# ---------------------------------------------------------------------------
# slow: the config-5 flow against JAX's
# ---------------------------------------------------------------------------

def _jax_reports(n_seq, n_devices, duration):
    from plviwo_tpu.parallel.batch_replay import run_batch_replay as j_run

    assert len(jax.devices()) >= n_devices
    return j_run(n_seq=n_seq, n_devices=n_devices, duration=duration)


@pytest.mark.slow
def test_batch_replay_matches_jax():
    """tests/test_batch_replay.py's settings (2 sequences, 2 ranks, 8 s) and
    gates on the port, each ate_before_m within 1.5x of JAX's."""
    report = batch_replay.run_batch_replay(n_seq=2, ranks=2, duration=8.0, device="cpu",
                                           timeout=900.0)
    jrep = _jax_reports(2, 2, 8.0)
    assert report["n_seq"] == 2 and report["devices"] == 2 and report["backend"] == "gloo"
    assert report["accepted"] > 100, report
    assert report["lines_accepted"] > 20, report
    assert len(report["sequences"]) == 2
    for s, js in zip(report["sequences"], jrep["sequences"]):
        assert np.isfinite(s["ate_before_m"]) and s["ate_before_m"] < 1.0, s
        assert s["ate_before_m"] < 1.5 * js["ate_before_m"], (s, js)
        assert s["ate_after_m"] is not None, s
        assert s["ate_after_m"] <= s["ate_before_kf_m"] * 1.15, s
        g = s["ba_gain"]
        assert g[-1] < g[0] * 1e-2, g


@pytest.mark.slow
def test_chip_smoke_jax_constants():
    """JAX's per-sequence ATEs at chip_smoke.py phase 32's config-5 settings
    (4 sequences, 12 s, JAX's defaults) on the CPU: C5_JAX_ATE_BEFORE."""
    import chip_smoke

    jrep = _jax_reports(4, 4, 12.0)
    got = [s["ate_before_m"] for s in jrep["sequences"]]
    np.testing.assert_allclose(got, chip_smoke.C5_JAX_ATE_BEFORE, rtol=1e-6)
