"""The port's host KLT trackers against the JAX package, on the CPU.

`ops.image.hist_equalize` (the LUT variant), `update.tracker.KltTracker`
and `StereoKltTracker` frame by frame over rendered frames of the JAX
simulator (tests/test_tracker.py::test_image_driven_vio_e2e's scenario:
8 s, seed 2, 350 landmarks; 80 slots, a 12 x 10 grid), and `run_sim
--images --host-tracker`.  JAX's tracker runs as it ships (the gather LK
`klt.pyramidal_lk`), the port's with `klt.draw_hypotheses` replaced by a
replay of JAX's RANSAC draws (`JaxDraws`, tests/test_torch_fused_frame.py)
and its detector's score by JAX's compiled one.

Tolerances: `hist_equalize` bit-equal, pixels on the bin edges and just
beside them included; the detector's Shi-Tomasi score on an equalized
frame within 2e-5 of its maximum of JAX's compiled score and within 2
float32 ulps of JAX's op-by-op one (the score cancels, and XLA fuses it: a
cell maximum that ties at that level picks another pixel, so the tracker
parity replays JAX's compiled score, as it replays JAX's RANSAC draws);
the trackers' ids
equal and their pixels within 1e-3 px after every frame (LK in float32,
the RANSAC gate on its float64 undistortion).  The port's gather LK
`klt.pyramidal_lk` against JAX's on the tracker's own frame pair: `ok`
equal, the pixels of the features kept within 1e-4 px and of every feature
within 1e-3 px (the same float32 operations; sums may add in another
order).  The slow tests hold the port alone to
tests/test_tracker.py's end-to-end gates (the rendered sequence's median
epipolar error under 2/300 normalized units; the image-driven VIO's
updates > 30 and RMSE < 0.6 m).
"""

import contextlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plviwo_tpu.ops import image as j_image
from plviwo_tpu.ops import klt as j_klt
from plviwo_tpu.sim.simulator import SimConfig as JSimConfig
from plviwo_tpu.sim.simulator import Simulator as JSimulator
from plviwo_tpu.update import tracker as j_tracker
from plviwo_tpu_torch import run_sim
from plviwo_tpu_torch.ops import cam as cam_ops
from plviwo_tpu_torch.ops import image, klt, lie, lk_kernel
from plviwo_tpu_torch.update.tracker import KltTracker, StereoKltTracker
from tests.test_torch_fused_frame import JaxDraws

N_FRAMES = 4
TRACKER = dict(n_pts=80, grid_x=12, grid_y=10)


@pytest.fixture(scope="module")
def frames():
    """The first frames of tests/test_tracker.py::test_image_driven_vio_e2e's
    sequence, left and right, from the JAX simulator."""
    sim = JSimulator(JSimConfig(duration=8.0, seed=2, n_landmarks=350))
    sim.imu_stream()
    ts = sim.cam_times()[:N_FRAMES]
    return sim, [(sim.render_frame(t, with_lines=False),
                  sim.render_frame(t, with_lines=False, cam=1)) for t in ts]


def test_hist_equalize_matches_jax():
    rng = np.random.default_rng(0)
    img = rng.uniform(-0.1, 1.1, (2, 48, 64)).astype(np.float32)
    edges = np.arange(257, dtype=np.float32) / 256  # JAX's bin edges, exactly
    np.testing.assert_array_equal(np.asarray(jnp.linspace(0, 1, 257, dtype=jnp.float32)), edges)
    flat = img.reshape(2, -1)
    flat[0, :257] = edges
    flat[1, :257] = np.nextafter(edges, np.float32(-1))
    flat[1, 257:514] = np.nextafter(edges, np.float32(2))
    got = image.hist_equalize(torch.as_tensor(img)).numpy()
    for b in range(2):
        want = np.asarray(j_image.hist_equalize(jnp.asarray(img[b])))
        np.testing.assert_array_equal(got[b], want)


_jax_score = jax.jit(j_image.shi_tomasi_score)


def jax_score(img):
    """Stands in for the port detector's `shi_tomasi_score`: JAX's score of
    the same images (B,H,W), compiled as JAX's detector compiles it."""
    return torch.stack([torch.as_tensor(np.array(_jax_score(jnp.asarray(x)))) for x in img.numpy()])


def test_shi_tomasi_score_on_equalized_frame(frames):
    """The detector's score on a LUT-equalized frame against JAX's compiled
    one: within 2e-5 of its maximum (8.1e-6 measured: the score
    tr/2 - sqrt(tr^2/4 - det) cancels, and XLA fuses the float32 box sums
    and the formula), and op by op (JAX eager) within 2 float32 ulps of it.
    On the first frame one cell's maximum is a tie at that level, and the
    port's detector picks another pixel of the cell, 7.5 px away, so the
    tracker parity below replays JAX's compiled score (`jax_score`)."""
    img = image.hist_equalize(torch.as_tensor(frames[1][0][0])[None])
    got = image.shi_tomasi_score(img)
    scale = float(got.abs().max())
    assert float((got - jax_score(img)).abs().max()) <= 2e-5 * scale
    eager = torch.as_tensor(np.array(j_image.shi_tomasi_score(jnp.asarray(img[0].numpy()))))
    assert float((got[0] - eager).abs().max()) <= 2 * np.spacing(np.float32(scale))


@pytest.fixture
def jax_draws(monkeypatch):
    """The port's host tracker on JAX's RANSAC draws and detector score."""
    monkeypatch.setattr(klt, "draw_hypotheses", JaxDraws())
    monkeypatch.setattr(klt, "shi_tomasi_score", jax_score)


@pytest.mark.parametrize("stereo", [False, True])
def test_klt_tracker_matches_jax(jax_draws, frames, stereo):
    sim, imgs = frames
    k = np.asarray(sim.cfg.intrinsics)
    cls, jcls = ((StereoKltTracker, j_tracker.StereoKltTracker) if stereo
                 else (KltTracker, j_tracker.KltTracker))
    port, ref = cls(cam_k=k, device="cpu", **TRACKER), jcls(cam_k=k, **TRACKER)
    launches = lk_kernel.lk_pyramid.launches
    n_right = 0
    for i, (left, right) in enumerate(imgs):
        if stereo:
            got, want = port.feed_stereo(left, right), ref.feed_stereo(left, right)
            n_right += len(want[2])
        else:
            got, want = port.feed(left), ref.feed(left)
        for j in range(0, len(want), 2):
            np.testing.assert_array_equal(got[j], want[j], err_msg=f"frame {i} ids {j}")
            np.testing.assert_allclose(got[j + 1], want[j + 1], rtol=0, atol=1e-3,
                                       err_msg=f"frame {i} uv {j}")
        np.testing.assert_array_equal(port.ids, ref.ids)
        np.testing.assert_array_equal(port.valid, ref.valid)
    assert len(got[0]) > 40 and int(port.counter[0]) == N_FRAMES - 1  # RANSAC on each pair
    assert not stereo or n_right > 40
    assert lk_kernel.lk_pyramid.launches == launches  # the gather LK launches no kernel


def test_lk_against_jax_gather_lk(frames):
    """The host tracker's LK, the gather form, against JAX's, which JAX's
    host tracker ships with, on the tracker's first frame pair and its
    detections."""
    sim, imgs = frames
    tr = KltTracker(cam_k=np.asarray(sim.cfg.intrinsics), device="cpu", **TRACKER)
    tr.feed(imgs[0][0])
    prev, uv, valid = tr.prev_pyr, tr._uv.float(), tr._valid
    nxt = tr._pyramid(imgs[1][0])
    got_uv, got_ok = klt.pyramidal_lk(prev, nxt, uv, valid, 3, 7, 10)
    want_uv, want_ok = j_klt.pyramidal_lk(tuple(jnp.asarray(p[0].numpy()) for p in prev),
                                          tuple(jnp.asarray(p[0].numpy()) for p in nxt),
                                          jnp.asarray(uv[0].numpy()), jnp.asarray(valid[0].numpy()),
                                          3, 7, 10)
    got_ok, want_ok = got_ok[0].numpy(), np.asarray(want_ok)
    np.testing.assert_array_equal(got_ok, want_ok)
    assert want_ok.sum() >= 60
    d = np.abs(got_uv[0].numpy() - np.asarray(want_uv))
    assert d[want_ok].max() <= 1e-4 and d.max() <= 1e-3, (d[want_ok].max(), d.max())


def _run_main(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = run_sim.main(["--device", "cpu"] + argv)
    return rc, json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("stereo", [False, True])
def test_run_sim_host_tracker(stereo):
    rc, out = _run_main(["--images", "--host-tracker", "--duration", "1.5", "--seed", "2"]
                        + (["--stereo"] if stereo else []))
    assert rc == 0 and out["frames"] == 13 and out["ate_rmse_m"] < 0.1
    assert out["updates"] > 3 and out["cam_accept_rate"] > 0.3, out


# --- tests/test_tracker.py's end-to-end gates, on the port alone ------------------

@pytest.mark.slow
def test_tracker_on_rendered_sequence():
    """The tracker on 10 rendered frames: ids persist and the tracks satisfy
    the true epipolar geometry to sub-pixel level."""
    from plviwo_tpu_torch.sim.simulator import SimConfig, Simulator

    cfg = SimConfig(duration=3.0, seed=2, n_landmarks=300, n_pts=60)
    sim = Simulator(cfg)
    tr = KltTracker(cam_k=np.asarray(cfg.intrinsics), device="cpu", **TRACKER)
    R_ItoC = lie.quat_2_rot(torch.as_tensor(np.asarray(cfg.cam_ext_q))).numpy()
    p_ext = np.asarray(cfg.cam_ext_p)
    k = torch.as_tensor(np.asarray(cfg.intrinsics))

    def cam_pose(t):
        kin = sim.gt_kin(t)
        R_GtoC = R_ItoC @ np.asarray(kin["R_GtoI"])
        return R_GtoC, np.asarray(kin["p_IinG"]) - R_GtoC.T @ p_ext

    prev, epi = None, []
    for t in sim.cam_times()[:10]:
        ids, uvs = tr.feed(sim.render_frame(t, with_lines=False))
        assert len(ids) > 20
        if prev is not None:
            t0, ids0, uvs0 = prev
            common, i1, i0 = np.intersect1d(ids, ids0, return_indices=True)
            assert len(common) > 10, "tracks do not persist"
            (R0, c0), (R1, c1) = cam_pose(t0), cam_pose(t)
            R_rel, t_rel = R1 @ R0.T, R1 @ (c0 - c1)
            E = np.cross(t_rel, R_rel.T, axisa=0, axisb=0).T  # [t]x R
            x0 = cam_ops.undistort_radtan(torch.as_tensor(uvs0[i0]), k).numpy()
            x1 = cam_ops.undistort_radtan(torch.as_tensor(uvs[i1]), k).numpy()
            h0 = np.concatenate([x0, np.ones((len(x0), 1))], 1)
            h1 = np.concatenate([x1, np.ones((len(x1), 1))], 1)
            l1 = h0 @ E.T
            d = np.abs(np.sum(h1 * l1, axis=1)) / np.linalg.norm(l1[:, :2], axis=1)
            epi.extend(d.tolist())
        prev = (t, ids, uvs)
    assert len(epi) > 100
    assert float(np.median(epi)) < 2.0 / 300.0


@pytest.mark.slow
def test_image_driven_vio_e2e():
    """Rendered frames -> the KLT tracker -> the per-track filter."""
    from plviwo_tpu_torch.examples import host_tracker_vio

    rmse, stats, _ = host_tracker_vio(device="cpu")
    assert stats["updates"] > 30, stats
    assert rmse < 0.6, (rmse, stats)


def jax_constants():
    """The JAX driver's numbers that chip_smoke.py phases 23-28 hold the card
    to, on the CPU (the JAX package as it ships, its Python feature store)."""
    import chip_smoke
    from plviwo_tpu import run_sim as j_run_sim
    from plviwo_tpu.config.options import EstimatorOptions as JOptions
    from plviwo_tpu.core.system import VioSystem as JVioSystem
    from plviwo_tpu_torch import examples

    def system(o):
        s = JVioSystem(o)
        s.fdb_native = None
        return s

    def rmse(sim, s):
        errs = [np.linalg.norm(p - np.asarray(sim.gt_kin(t)["p_IinG"])) for t, _, p in s.traj]
        return float(np.sqrt(np.mean(np.square(errs))))

    out = {}
    for name, dynamic in (("CPI_JAX_ATE", False), ("CPI_DYN_JAX_ATE", True)):
        sim = JSimulator(JSimConfig(duration=8.0, seed=3, sigma_pix=0.5, n_pts=45))
        o = chip_smoke.run_sim_options(JOptions(), imu_res=True)
        if dynamic:
            o.dynamic_cloning, o.clone_freq = True, 4
        s = system(o)
        examples.live_calibrate(s, sim, float(sim.imu_t[0]))
        for kind, args in examples.track_events(sim):
            examples.feed(s, kind, args)
        out[name] = rmse(sim, s)
    sim = JSimulator(JSimConfig(duration=8.0, seed=3, sigma_pix=0.5, n_pts=45))
    s = system(chip_smoke.run_sim_options(JOptions(), wheel=True))
    out["AUTO_INIT_JAX_ATE"], out["AUTO_INIT_JAX_T"] = chip_smoke.auto_init_run(
        s, sim, lambda kind, args: examples.feed(s, kind, args))

    def tracked(sim, o, tracker, **kw):
        s = system(o)
        examples.live_calibrate(s, sim, float(sim.imu_t[0]))
        for kind, args in examples.track_events(sim, images=True, **kw):
            examples.feed_tracked(s, tracker, kind, args)
        return rmse(sim, s)

    sim = JSimulator(JSimConfig(duration=8.0, seed=2, n_landmarks=350))
    o = JOptions()
    o.cam.n_pts, o.cam.max_msckf, o.cam.sigma_pix, o.cam.min_track_length, o.cam.chi2_mult = (
        80, 30, 1.5, 4, 8.0)
    out["TRACKER_JAX_RMSE"] = tracked(sim, o, j_tracker.KltTracker(
        cam_k=np.asarray(sim.cfg.intrinsics), **TRACKER))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        j_run_sim.main(["--images", "--host-tracker", "--stereo", "--duration", "8", "--seed", "2"])
    out["STEREO_TRACKER_JAX_ATE"] = json.loads(buf.getvalue().strip().splitlines()[-1])[
        "ate_rmse_m"]
    sim = JSimulator(JSimConfig(duration=8.0, seed=2, sigma_pix=0.5, n_pts=45))
    sim.imu_stream()
    tr = j_tracker.StereoKltTracker(cam_k=np.asarray(sim.cfg.intrinsics), **TRACKER)
    out["STEREO_JAX_RIGHT"] = sum(
        len(tr.feed_stereo(sim.render_frame(t, with_lines=False),
                           sim.render_frame(t, with_lines=False, cam=1))[2])
        for t in sim.cam_times())
    sim = JSimulator(JSimConfig(duration=15.0, seed=1, n_pts=150))
    out["KAIST_TRACKER_JAX_ATE"] = tracked(
        sim, chip_smoke.kaist_options(JOptions()),
        j_tracker.KltTracker(n_pts=150, cam_k=np.asarray(sim.cfg.intrinsics), grid_x=15,
                             grid_y=10), wheel=True)
    out.update(jax_line_constants())
    out.update(jax_tag_desc_constants())
    return out


def jax_tag_desc_constants():
    """The JAX drivers' numbers that chip_smoke.py phases 29-30 set the card's
    beside, on the CPU (the JAX package as it ships): run_sim --tags
    --duration 8 --seed 2's ATE (m, its summary's 4 digits) and
    tests/test_descriptor.py::test_desc_tracker_e2e's RMSE (m)."""
    from plviwo_tpu import run_sim as j_run_sim
    from plviwo_tpu.config.options import EstimatorOptions as JOptions
    from plviwo_tpu.core.system import VioSystem as JVioSystem
    from plviwo_tpu.update.desc_tracker import DescTracker as JDescTracker

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        j_run_sim.main(["--duration", "8", "--seed", "2", "--tags"])
    out = {"TAGS_JAX_ATE": json.loads(buf.getvalue().strip().splitlines()[-1])["ate_rmse_m"]}
    sim = JSimulator(JSimConfig(duration=8.0, seed=2, n_pts=45))
    o = JOptions()
    o.cam.max_msckf, o.cam.sigma_pix, o.cam.min_track_length, o.cam.chi2_mult = 25, 2.0, 4, 8.0
    s = JVioSystem(o)
    c = sim.cfg
    s.set_calibration(c.intrinsics, c.cam_ext_q, c.cam_ext_p)
    imu_t, imu_w, imu_a = sim.imu_stream()
    kin0 = sim.gt_kin(imu_t[0])
    q0, _ = sim.gt_pose(imu_t[0])
    s.initialize_from(float(imu_t[0]), np.asarray(q0), kin0["p_IinG"], kin0["v_IinG"],
                      sim.bg_true[0], sim.ba_true[0])
    tracker = JDescTracker(n_pts=80, cam_k=np.asarray(c.intrinsics), grid_x=12, grid_y=10)
    frames = [(float(t), sim.render_frame(t, with_lines=False)) for t in sim.cam_times()]
    k = 0
    for i in range(len(imu_t)):
        while k < len(frames) and frames[k][0] <= imu_t[i]:
            s.feed_camera(frames[k][0], *tracker.feed(frames[k][1]))
            k += 1
        s.feed_imu(imu_t[i], imu_w[i], imu_a[i])
    errs = [np.linalg.norm(p - np.asarray(sim.gt_kin(t)["p_IinG"])) for t, _, p in s.traj]
    out["DESC_JAX_RMSE"] = float(np.sqrt(np.mean(np.square(errs))))
    return out


def jax_line_constants():
    """The JAX drivers' numbers that chip_smoke.py phases 27-28 hold the card
    to, on the CPU (the JAX package as it ships): phase 26's mono scenario
    with the host line tracker and the wheel, without and with the
    point-line-coupled rows (RMSE, m), and run_kaist --wheel --lines over
    tests/test_kaist_e2e.py::test_run_kaist_e2e's fixture (ATE, m)."""
    import tempfile

    from plviwo_tpu import run_kaist as j_run_kaist
    from plviwo_tpu.config.options import EstimatorOptions as JOptions
    from plviwo_tpu.core.system import VioSystem as JVioSystem
    from plviwo_tpu.sim.kaist_fixture import generate_kaist_fixture
    from plviwo_tpu.update.line_tracker import LineTracker as JLineTracker
    from plviwo_tpu_torch import examples
    from plviwo_tpu_torch.sim.kaist_fixture import write_fixture_config

    out = {}
    for name, plc in (("LINE_TRACKER_JAX_RMSE", False), ("LINE_TRACKER_PLC_JAX_RMSE", True)):
        sim = JSimulator(JSimConfig(duration=8.0, seed=2, n_landmarks=350))
        s = JVioSystem(examples.host_tracker_options(JOptions(), lines=True, wheel=True, plc=plc))
        examples.live_calibrate(s, sim, float(sim.imu_t[0]))
        tracker = j_tracker.KltTracker(cam_k=np.asarray(sim.cfg.intrinsics), **TRACKER)
        lines = JLineTracker(max_lines=s.opts.cam.max_lines, min_length=30.0)
        for kind, args in examples.track_events(sim, wheel=True, images=True, lines=True):
            examples.feed_tracked(s, tracker, kind, args, lines)
        errs = [np.linalg.norm(p - np.asarray(sim.gt_kin(t)["p_IinG"])) for t, _, p in s.traj]
        out[name] = float(np.sqrt(np.mean(np.square(errs))))
    with tempfile.TemporaryDirectory() as d:
        sim = JSimulator(JSimConfig(duration=16.0, n_landmarks=350, n_lines=40, width=640,
                                    height=480, seed=5))
        generate_kaist_fixture(d, sim, t_start=1.0, duration=12.0, cam_hz=8.0)
        master = write_fixture_config(d, sim.cfg)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            j_run_kaist.main(["--root", d, "--config", master, "--wheel", "--lines"])
    out["KAIST_REPLAY_JAX_ATE"] = json.loads(buf.getvalue().strip().splitlines()[-1])[
        "ate_rmse_m"]
    return out


@pytest.mark.slow
def test_chip_smoke_jax_constants():
    """chip_smoke.py's constants for phases 23-30 (the CPI pair, the
    AUTO_INIT_JAX pair, TRACKER_JAX_RMSE, STEREO_TRACKER_JAX_ATE,
    STEREO_JAX_RIGHT, KAIST_TRACKER_JAX_ATE, the LINE_TRACKER pair,
    KAIST_REPLAY_JAX_ATE, TAGS_JAX_ATE, DESC_JAX_RMSE), recomputed with the
    JAX package on the CPU.  XLA:CPU on another processor may round
    differently: a mismatch means re-measuring, not a fault of the port."""
    import chip_smoke

    got = jax_constants()
    print(got)
    for name, value in got.items():
        assert value == pytest.approx(getattr(chip_smoke, name), rel=1e-6), name
