"""The port's fiducial tags and descriptor tracker against the JAX package, on
the CPU.

`ops.aruco` (the tag family, bitmaps and template bank, the NCC volume, the
detector), `update.aruco_tracker.ArucoTracker`, the simulator's ground tags
(`SimConfig.n_tags`), `ops.descriptor` (`describe`, `match`) and
`update.desc_tracker.DescTracker`, on painted 320 x 240 frames and the
simulator's rendered ones.  JAX's detector runs as it ships; the port's
`DescTracker` takes its RANSAC draws from a replay of JAX's
(`JaxDraws`, tests/test_torch_fused_frame.py), its detector score from JAX's
compiled one (`jax_score`, tests/test_torch_host_tracker.py: cell maxima
tie at the rounding level) and its descriptors from JAX's compiled
`describe` (bits of exactly equal samples break either way; `describe`
itself is held to JAX's below).

Tolerances: the tag family, bitmaps, bank and rotated codes equal; the NCC
volume within 2e-5 of JAX's (float32 correlations summed in another
order; the port's largest templates in blocks of taps); detections: the
valid mask, ids and bit counts equal, scores within 1e-4, the refined
corners of valid detections within 1e-3 px, and the port also held to
tests/test_aruco.py's ground-truth corner bounds (1.0 px axis-aligned,
1.8 px rotated); `ArucoTracker` ids equal and corners within 1e-3 px; the
simulator's tag draws within 1e-9 (its path comes from closed-form spline
positions, JAX's from jitted ones), world corners within 1e-9 m, rendered
frames within 1e-6, and the generator's state after them equal; BRIEF bits
equal wherever JAX's two samples differ by more than 1e-6 (the box sums
add in another order, so exact ties on flat equalized regions may break
either way), `match` on the same bits equal; `DescTracker` ids equal and
pixels within 1e-3 px after every frame, one device read a frame.  The
slow tests replay tests/test_aruco.py's and tests/test_descriptor.py's
end-to-end scenarios on the port alone with their gates.
"""

import contextlib
import io
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plviwo_tpu.ops import aruco as j_aruco
from plviwo_tpu.ops import descriptor as j_desc
from plviwo_tpu.ops import image as j_image
from plviwo_tpu.ops import klt as j_klt
from plviwo_tpu.sim.simulator import SimConfig as JSimConfig
from plviwo_tpu.sim.simulator import Simulator as JSimulator
from plviwo_tpu.update.aruco_tracker import ArucoTracker as JArucoTracker
from plviwo_tpu.update.desc_tracker import DescTracker as JDescTracker
from plviwo_tpu_torch import run_sim
from plviwo_tpu_torch.ops import aruco, descriptor, klt
from plviwo_tpu_torch.sim.simulator import SimConfig, Simulator
from plviwo_tpu_torch.update.aruco_tracker import ArucoTracker
from plviwo_tpu_torch.update.desc_tracker import DescTracker
from tests.test_aruco import _base_img, _gt_corners, _paint
from tests.test_torch_fused_frame import JaxDraws
from tests.test_torch_host_tracker import jax_score

# tests/test_aruco.py::test_sim_ground_tags_detected_and_world_consistent's scene
TAG_SIM = dict(duration=8.0, seed=3, n_tags=5, tag_size=0.5, width=320, height=240,
               intrinsics=(300.0, 300.0, 160.0, 120.0, 0.0, 0.0, 0.0, 0.0),
               cam_ext_q=(1.0, 0.0, 0.0, 0.0), cam_ext_p=(0.0, 0.0, 0.0))
SMALL = dict(width=320, height=240,
             intrinsics=(150.0, 150.0, 160.0, 120.0, -0.05, 0.01, 0.0005, -0.0002))


@pytest.fixture(scope="module")
def detectors():
    return j_aruco.TagDetector(max_det=4), aruco.TagDetector(max_det=4, device="cpu")


def test_tag_family_bitmaps_and_bank_match_jax():
    codes = aruco.tag_family()
    np.testing.assert_array_equal(codes, j_aruco.tag_family())
    np.testing.assert_array_equal(aruco._codes_rot4(codes), j_aruco._codes_rot4(codes))
    for c in codes[:4]:
        for quiet in (True, False):
            np.testing.assert_array_equal(aruco.tag_bitmap(c, quiet=quiet),
                                          j_aruco.tag_bitmap(c, quiet=quiet))
    for (T, K, a), (jT, jK, ja) in zip(aruco.template_bank(), j_aruco.template_bank()):
        assert K == jK
        np.testing.assert_array_equal(T, np.asarray(jT))
        np.testing.assert_array_equal(a, np.asarray(ja))


def _scenes():
    """Painted 320 x 240 frames: (name, image, [(tag, cx, cy, s, theta)])."""
    codes = aruco.tag_family()
    out = []
    img = _base_img()
    _paint(img, aruco.tag_bitmap(codes[3]), 160.3, 120.7, 5.0)
    out.append(("axis_aligned", img, [(3, 160.3, 120.7, 5.0, 0.0)]))
    img = _base_img(1)
    _paint(img, aruco.tag_bitmap(codes[7]), 100.0, 130.0, 6.0, 0.9)
    out.append(("rotated", img, [(7, 100.0, 130.0, 6.0, 0.9)]))
    img = _base_img(2)
    _paint(img, aruco.tag_bitmap(codes[0]), 80.0, 60.0, 4.6)
    _paint(img, aruco.tag_bitmap(codes[12]), 230.0, 170.0, 6.8)
    out.append(("two_tags", img, [(0, 80.0, 60.0, 4.6, 0.0), (12, 230.0, 170.0, 6.8, 0.0)]))
    out.append(("none", _base_img(3), []))
    return out


SCENES = _scenes()


@pytest.mark.parametrize("name,img,tags", SCENES, ids=[s[0] for s in SCENES])
def test_detector_matches_jax(detectors, name, img, tags):
    jd, td = detectors
    want = {k: np.asarray(v) for k, v in jd.detect(img).items()}
    got = {k: v.numpy() for k, v in td.detect(img).items()}
    np.testing.assert_array_equal(got["valid"], want["valid"])
    ok = want["valid"]
    for k in ("tag_id", "n_match"):
        np.testing.assert_array_equal(got[k][ok], want[k][ok], err_msg=k)
    np.testing.assert_allclose(got["score"], want["score"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["corners"][ok], want["corners"][ok], rtol=0, atol=1e-3)
    # tests/test_aruco.py's gates on the port alone
    assert sorted(int(i) for i in got["tag_id"][ok]) == sorted(t[0] for t in tags)
    for tag, cx, cy, s, theta in tags:
        i = int(np.nonzero(ok & (got["tag_id"] == tag))[0][0])
        err = np.linalg.norm(got["corners"][i] - _gt_corners(cx, cy, s, theta), axis=-1)
        assert err.max() < (1.0 if name == "axis_aligned" else 1.8), (name, err)


def test_ncc_volume_matches_jax(detectors):
    jd, td = detectors
    img = SCENES[2][1]
    want = np.asarray(j_aruco._ncc_stack_packed(jnp.asarray(img), jd.bank_T))
    got = aruco.ncc_stack(torch.as_tensor(img)[None], td.bank_T)[0].numpy()
    assert got.shape == want.shape == (3, 12, 240, 320)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


def test_refine_corners_matches_jax():
    """The saddle fit alone, from corners 1.5 px off the painted ones."""
    img = SCENES[1][1]
    start = _gt_corners(100.0, 130.0, 6.0, 0.9) + np.array([1.2, -0.9])
    want = np.asarray(j_aruco.refine_corners(jnp.asarray(img), jnp.asarray(start, jnp.float32)))
    got = aruco.refine_corners(torch.as_tensor(img)[None],
                               torch.as_tensor(start, dtype=torch.float32)[None])[0].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def test_aruco_tracker_matches_jax(detectors):
    jd, td = detectors
    img = SCENES[2][1]
    jt, tt = JArucoTracker(detector=jd), ArucoTracker(detector=td)
    (jids, juvs), (ids, uvs) = jt.feed(img), tt.feed(img)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_allclose(uvs, juvs, rtol=0, atol=1e-3)
    assert len(ids) == 8 and ids.min() >= 10_000_000 and tt.host_reads == 1
    assert sorted(tt.last) == sorted(jt.last)


def test_sim_tags_match_jax():
    """The tag draws (after the ground height, before the bias walks), the
    world corners and a rendered frame, then the generator's state."""
    js, ts = JSimulator(JSimConfig(**TAG_SIM)), Simulator(SimConfig(**TAG_SIM))
    np.testing.assert_array_equal(ts.tag_codes, js.tag_codes)
    np.testing.assert_array_equal(ts.tag_bitmaps, js.tag_bitmaps)
    np.testing.assert_allclose(ts.tag_center, js.tag_center, rtol=0, atol=1e-9)
    np.testing.assert_allclose(ts.tag_yaw, js.tag_yaw, rtol=0, atol=1e-9)
    np.testing.assert_allclose(ts.tag_corners_world(), js.tag_corners_world(), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(ts.bg_true, js.bg_true, rtol=0, atol=1e-12)
    t = js.cam_times()[9]  # a tag in view
    img = ts.render_frame(t, with_lines=False)
    np.testing.assert_allclose(img, js.render_frame(t, with_lines=False), rtol=0, atol=1e-6)
    assert (img == 0.0).sum() > 100  # the tag's black cells
    np.testing.assert_array_equal(ts.rng.normal(size=3), js.rng.normal(size=3))


def test_sim_tag_frame_detected_on_the_port():
    """Two rendered ground-tag frames (a tag in view in each) through the
    port's tracker: each corner within 1.5 px of its world corner's
    projection."""
    from plviwo_tpu_torch.ops import lie

    sim = Simulator(SimConfig(**TAG_SIM))
    tr = ArucoTracker(max_tag_id=16, device="cpu")
    corners_w = sim.tag_corners_world()
    R_ItoC = lie.quat_2_rot(torch.tensor(TAG_SIM["cam_ext_q"], dtype=torch.float64)).numpy()
    hits = 0
    for t in sim.cam_times()[9:13:3]:
        ids, uvs = tr.feed(sim.render_frame(t, with_lines=False))
        kin = sim.gt_kin(t)
        for fid, uv in zip(ids, uvs):
            rel = int(fid - tr.id_base)
            p_C = R_ItoC @ (kin["R_GtoI"] @ (corners_w[rel % 16, rel // 16] - kin["p_IinG"]))
            uv_gt = 300.0 * p_C[:2] / p_C[2] + np.array([160.0, 120.0])
            assert np.linalg.norm(uv - uv_gt) < 1.5
            hits += 1
    assert hits == 8


def test_run_sim_tags_on_the_cpu():
    """--tags implies --images and the host tracker: a short replay whose
    frames feed KLT and tag corners."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = run_sim.main(["--device", "cpu", "--tags", "--duration", "0.6", "--seed", "2"])
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert rc == 0 and out["frames"] == 3, out


# --- descriptors ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def desc_frames():
    """Four 320 x 240 frames of tests/test_descriptor.py's e2e scene (seed 2),
    rendered by the JAX simulator."""
    sim = JSimulator(JSimConfig(duration=8.0, seed=2, n_pts=45, **SMALL))
    sim.imu_stream()
    return sim, [sim.render_frame(t, with_lines=False) for t in sim.cam_times()[:4]]


def _equalized(img):
    return np.asarray(j_image.hist_equalize(jnp.asarray(img)))


def test_brief_pattern_and_smoothing_match_jax(desc_frames):
    np.testing.assert_array_equal(descriptor.brief_pattern(), np.asarray(j_desc.brief_pattern()))
    np.testing.assert_array_equal(descriptor.brief_pattern(64, 8.0, 5),
                                  np.asarray(j_desc.brief_pattern(64, 8.0, 5)))
    img = _equalized(desc_frames[1][0])
    got = descriptor._smooth3(torch.tensor(img)[None])[0].numpy()
    np.testing.assert_allclose(got, np.asarray(j_desc._smooth3(jnp.asarray(img))), rtol=0,
                               atol=2e-7)


def test_describe_matches_jax(desc_frames):
    img = _equalized(desc_frames[1][0])
    uv, ok = j_klt.detect_grid(jnp.asarray(img), jnp.zeros((80, 2), jnp.float32),
                               jnp.zeros(80, bool), 12, 10, 80)
    pat = j_desc.brief_pattern()
    want = np.asarray(j_desc.describe(jnp.asarray(img), uv, ok, pat))
    got = descriptor.describe(torch.as_tensor(img)[None], torch.as_tensor(np.asarray(uv))[None],
                              torch.as_tensor(np.asarray(ok))[None],
                              torch.as_tensor(np.asarray(pat)))[0].numpy()
    # JAX's two samples of every bit, on JAX's smoothed image
    sm = j_desc._smooth3(jnp.asarray(img))
    u = np.asarray(uv)[:, None, :]
    p = np.asarray(pat)
    v1 = np.asarray(j_desc._bilinear(sm, jnp.asarray(u[..., 0] + p[:, 0]),
                                     jnp.asarray(u[..., 1] + p[:, 1])))
    v2 = np.asarray(j_desc._bilinear(sm, jnp.asarray(u[..., 0] + p[:, 2]),
                                     jnp.asarray(u[..., 1] + p[:, 3])))
    clear = np.abs(v1 - v2) > 1e-6
    np.testing.assert_array_equal(got[clear], want[clear])
    assert clear.mean() > 0.9 and want.sum() > 1000


def test_match_matches_jax(desc_frames):
    """`match` on JAX's descriptors of two frames (ties in the distances
    included: first index)."""
    pat = j_desc.brief_pattern()
    ds = []
    for img in desc_frames[1][:2]:
        e = jnp.asarray(_equalized(img))
        uv, ok = j_klt.detect_grid(e, jnp.zeros((80, 2), jnp.float32), jnp.zeros(80, bool),
                                   12, 10, 80)
        ds.append((j_desc.describe(e, uv, ok, pat), ok))
    (d1, v1), (d2, v2) = ds
    for max_dist, ratio in ((80.0, 0.8), (120.0, 0.95)):
        want = np.asarray(j_desc.match(d1, v1, d2, v2, max_dist, ratio))
        got = descriptor.match(*(torch.as_tensor(np.asarray(x))[None] for x in (d1, v1, d2, v2)),
                               max_dist, ratio)[0].numpy()
        np.testing.assert_array_equal(got, want)
        assert (want >= 0).sum() > 10


def test_desc_tracker_matches_jax(desc_frames, monkeypatch):
    sim, imgs = desc_frames
    monkeypatch.setattr(klt, "draw_hypotheses", JaxDraws())
    monkeypatch.setattr(klt, "shi_tomasi_score", jax_score)

    def jax_describe(img, uv, valid, pattern):
        return torch.as_tensor(np.array(j_desc.describe(
            jnp.asarray(img[0].numpy()), jnp.asarray(uv[0].numpy()),
            jnp.asarray(valid[0].numpy()), jnp.asarray(pattern.numpy()))))[None]

    monkeypatch.setattr(descriptor, "describe", jax_describe)
    k = np.asarray(sim.cfg.intrinsics)
    port = DescTracker(n_pts=80, cam_k=k, grid_x=12, grid_y=10, device="cpu")
    ref = JDescTracker(n_pts=80, cam_k=k, grid_x=12, grid_y=10)
    for i, img in enumerate(imgs):
        (ids, uvs), (jids, juvs) = port.feed(img), ref.feed(img)
        np.testing.assert_array_equal(ids, jids, err_msg=f"frame {i}")
        np.testing.assert_allclose(uvs, juvs, rtol=0, atol=1e-3, err_msg=f"frame {i}")
        np.testing.assert_array_equal(port.ids, ref.ids)
    assert port.host_reads == len(imgs)
    assert int(port.counter[0]) >= 1 and (port.ids >= 0).sum() > 40
    assert port._next_id < 80 * len(imgs)  # tracks carried between frames


# --- the JAX package's end-to-end tag and descriptor scenarios, on the port alone ----------

@pytest.mark.slow
def test_sim_ground_tags_detected_and_world_consistent():
    """tests/test_aruco.py's scenario: tags painted on the ground seen by a
    nadir camera, every 3rd frame of the first 24: >= 8 corner hits,
    median reprojection against the world corners < 1.5 px, max < 4 px."""
    from plviwo_tpu_torch.ops import cam as cam_ops
    from plviwo_tpu_torch.ops import lie

    cfg = SimConfig(**TAG_SIM)
    sim = Simulator(cfg)
    tracker = ArucoTracker(max_tag_id=16, device="cpu")
    corners_w = sim.tag_corners_world()
    k = torch.as_tensor(cfg.intrinsics, dtype=torch.float64)
    R_ItoC = lie.quat_2_rot(torch.as_tensor(cfg.cam_ext_q, dtype=torch.float64)).numpy()
    errs = []
    for t in sim.cam_times()[::3][:8]:
        ids, uvs = tracker.feed(sim.render_frame(t, with_lines=False))
        kin = sim.gt_kin(t)
        for fid, uv in zip(ids, uvs):
            rel = int(fid - tracker.id_base)
            p_C = R_ItoC @ (kin["R_GtoI"] @ (corners_w[rel % 16, rel // 16] - kin["p_IinG"]))
            assert p_C[2] > 0.1
            uv_gt = cam_ops.project(torch.as_tensor(p_C[None]), k, cam_ops.RADTAN).numpy()[0]
            errs.append(np.linalg.norm(uv - uv_gt))
    errs = np.asarray(errs)
    assert len(errs) >= 8 and np.median(errs) < 1.5 and errs.max() < 4.0, errs


@pytest.mark.slow
def test_tags_e2e_replay():
    """run_sim --tags --duration 8 --seed 2 (tests/test_aruco.py's gate:
    ATE < 1.0 m)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = run_sim.main(["--device", "cpu", "--duration", "8", "--seed", "2", "--tags"])
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert rc == 0 and out["ate_rmse_m"] < 1.0, out


@pytest.mark.slow
def test_desc_tracker_e2e():
    """tests/test_descriptor.py's scenario (8 s, seed 2, 80 slots) through
    the port's `DescTracker` and `feed_camera`: cam_accept > 10 and RMSE <
    1.0 m."""
    from plviwo_tpu_torch import examples

    rmse, stats, _, _ = examples.desc_tracker_vio(device="cpu")
    assert stats["cam_accept"] > 10 and rmse < 1.0, (rmse, stats)
