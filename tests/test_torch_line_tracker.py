"""The port's host line tracker against the JAX package, on the CPU.

`ops.image.bilinear_sample`, the anchor walk `ops.line_detect.
detect_segments`, `merge_segments` and `update.line_tracker.LineTracker`,
and `run_sim --images --host-tracker --lines`.  Inputs are numpy arrays
made from a seed, or frames rendered by the JAX simulator (with lines,
640 x 480: tests/test_line_detect.py::test_line_tracker_on_rendered_sequence's
scenario, seed 2).

Tolerances: `bilinear_sample` within 1e-6 (images in [0, 1]) of JAX's on
every channel, out-of-bounds points included.  `detect_segments`: `valid`
equal on at least 98% of the anchors and the endpoints of at least 97% of
them within 1e-3 px of JAX's.  The walk's alive test is a chain of
thresholds on float32 samples, so a rounding-level difference of the
blurred field (XLA fuses it) may end one walk a step earlier: the share
that agrees is printed (measured on these frames: valid equal on all
anchors, endpoints of 92-95% bit-equal and all within 1.9e-4 px; on a
320 x 240 render one valid flip in 256).  `merge_segments` equal bit for bit
on JAX's own detector output, in both modes, and on the synthetic cases of
tests/test_line_detect.py.  `LineTracker` over 8 frames with the same
images and the same point tracks (the port's `KltTracker` on the CPU feeds
both): line ids and attached point ids equal frame by frame, segments
within 5e-3 px, two device reads a frame.  The slow test holds the port
alone to tests/test_line_detect.py::test_line_tracker_on_rendered_sequence's
gates.
"""

import contextlib
import io
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plviwo_tpu.ops import image as j_image
from plviwo_tpu.ops import line_detect as j_ld
from plviwo_tpu.sim.simulator import SimConfig as JSimConfig
from plviwo_tpu.sim.simulator import Simulator as JSimulator
from plviwo_tpu.update.line_tracker import LineTracker as JLineTracker
from plviwo_tpu_torch import run_sim
from plviwo_tpu_torch.ops import image, line_detect, lk_kernel
from plviwo_tpu_torch.update.line_tracker import LineTracker
from plviwo_tpu_torch.update.tracker import KltTracker

N_FRAMES = 8


@pytest.fixture(scope="module")
def frames():
    """The first frames of the rendered sequence (lines drawn) and the
    port's KLT point tracks on them (ids, pixels)."""
    sim = JSimulator(JSimConfig(duration=2.0, seed=2, n_lines=40))
    sim.imu_stream()
    kt = KltTracker(n_pts=80, cam_k=np.asarray(sim.cfg.intrinsics), device="cpu")
    out = []
    for t in sim.cam_times()[:N_FRAMES]:
        img = sim.render_frame(t, with_lines=True)
        out.append((img,) + kt.feed(img))
    return out


def test_bilinear_sample_matches_jax():
    rng = np.random.default_rng(0)
    stack = rng.random((3, 30, 40)).astype(np.float32)
    xy = rng.uniform(-3.0, 45.0, (7, 5, 2)).astype(np.float32)
    xy[0, 0] = [38.999, 28.999]  # at the clamp
    got = image.bilinear_sample(torch.from_numpy(stack), torch.from_numpy(xy)).numpy()
    for c in range(3):
        want = np.asarray(j_image.bilinear_sample(jnp.asarray(stack[c]), jnp.asarray(xy)))
        np.testing.assert_allclose(got[c], want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("k", [0, 5])
def test_detect_segments_matches_jax(frames, k):
    img = frames[k][0].astype(np.float32)
    segs, length, valid = (np.asarray(x) for x in j_ld.detect_segments(jnp.asarray(img)))
    g_segs, g_length, g_valid = (x.numpy() for x in line_detect.detect_segments(
        torch.from_numpy(img)))
    assert g_segs.shape == segs.shape == (256, 4) and g_segs.dtype == np.float32
    same_valid = (g_valid == valid).mean()
    d = np.abs(g_segs - segs).max(-1)
    close, exact = (d <= 1e-3).mean(), (d == 0).mean()
    print(f"frame {k}: valid equal on {same_valid:.4f}, endpoints within 1e-3 px on "
          f"{close:.4f} (bit-equal {exact:.4f}), max {d.max():.3g} px")
    assert same_valid >= 0.98 and close >= 0.97 and valid.sum() > 50
    np.testing.assert_allclose(g_length[d <= 1e-3], length[d <= 1e-3], rtol=0, atol=2e-3)


@pytest.mark.parametrize("extend", [False, True])
def test_merge_segments_matches_jax(frames, extend):
    for img, _, _ in frames[:2]:
        raw = [np.asarray(x) for x in j_ld.detect_segments(jnp.asarray(img.astype(np.float32)))]
        want = j_ld.merge_segments(*raw, min_length=30.0, extend=extend)
        got = line_detect.merge_segments(*raw, min_length=30.0, extend=extend)
        assert len(want) > 5 and np.array_equal(got, want)
    # tests/test_line_detect.py's synthetic cases: duplicates, extension
    cases = [np.array([[10.0, 10.0, 110.0, 10.0], [40.0, 10.5, 140.0, 10.5],
                       [10.0, 200.0, 110.0, 200.0]]),
             np.array([[10.0, 50.0, 120.0, 50.0], [115.0, 50.4, 220.0, 50.4],
                       [215.0, 49.7, 300.0, 49.7]])]
    for segs, lens in zip(cases, ([100.0] * 3, [110.0, 105.0, 85.0])):
        lens, valid = np.asarray(lens, np.float32), np.ones(3, dtype=bool)
        want = j_ld.merge_segments(jnp.asarray(segs), jnp.asarray(lens), jnp.asarray(valid),
                                   extend=extend)
        assert np.array_equal(line_detect.merge_segments(segs, lens, valid, extend=extend), want)


def test_line_tracker_matches_jax(frames):
    port = LineTracker(max_lines=30, min_length=30.0, device="cpu")
    ref = JLineTracker(max_lines=30, min_length=30.0)
    n_lines = 0
    for i, (img, ids, uvs) in enumerate(frames):
        got, want = port.feed(img, ids, uvs), ref.feed(img, ids, uvs)
        np.testing.assert_array_equal(got[0], want[0], err_msg=f"frame {i} line ids")
        assert len(got[2]) == len(want[2])
        for a, b in zip(got[2], want[2]):
            np.testing.assert_array_equal(a, b, err_msg=f"frame {i} attached ids")
            assert a.dtype == np.int64
        np.testing.assert_allclose(got[1], want[1], rtol=0, atol=5e-3, err_msg=f"frame {i}")
        n_lines += len(got[0])
    assert n_lines > 40 and port._next_id == ref._next_id
    assert port.host_reads == 2 * N_FRAMES  # the detector's output and the attachment


def test_line_tracker_settings_are_jaxs():
    """The tracker's and the walk's fixed settings are JAX's defaults."""
    import inspect

    from plviwo_tpu_torch.update import line_tracker

    tracker = inspect.signature(JLineTracker).parameters
    walk = inspect.signature(j_ld.detect_segments).parameters
    merge = inspect.signature(j_ld.merge_segments).parameters
    got = (line_tracker.ATTACH_DIST, line_tracker.MIDPOINT_GATE, line_detect.LINE_GRID,
           line_detect.WALK_ANCHORS, line_detect.WALK_STEPS, line_detect.MERGE_ANG_TOL,
           line_detect.MERGE_DIST_TOL, False)
    want = (tracker["attach_dist"].default, tracker["midpoint_gate"].default,
            tracker["grid"].default, tracker["n_anchors"].default, walk["max_steps"].default,
            merge["ang_tol"].default, merge["dist_tol"].default, tracker["merge_extend"].default)
    assert got == want
    assert walk["grid"].default == line_detect.LINE_GRID
    assert walk["n_anchors"].default == line_detect.WALK_ANCHORS


def test_line_tracker_without_points(frames):
    """No point tracks: no attachment read, every segment pruned."""
    lt = LineTracker(device="cpu")
    ids, segs, pids = lt.feed(frames[0][0], np.zeros(0, dtype=np.int64), np.zeros((0, 2)))
    assert len(ids) == 0 and pids == [] and lt.host_reads == 1 and lt.prev == []


def _run_main(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = run_sim.main(["--device", "cpu"] + argv)
    return rc, json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("flags", [("--wheel",), ("--plc", "--stereo")])
def test_run_sim_host_tracker_lines(flags):
    """run_sim --images --host-tracker --lines: the point tracker's ids and
    pixels feed the line tracker, both into the per-track path."""
    launches = lk_kernel.lk_pyramid.launches
    rc, out = _run_main(["--images", "--host-tracker", "--lines", "--duration", "1.5",
                         "--seed", "2", *flags])
    assert rc == 0 and out["frames"] == 13 and out["ate_rmse_m"] < 0.1, out
    assert out["updates"] > 3 and out["line_accept_rate"] > 0.3, out
    assert out["feature_store"] == ("python" if "--stereo" in flags else "native")
    assert lk_kernel.lk_pyramid.launches == launches  # the CPU runs the plain LK


@pytest.mark.slow
def test_line_tracker_on_rendered_sequence():
    """tests/test_line_detect.py::test_line_tracker_on_rendered_sequence's
    gates on the port alone: >= 2 lines a frame, ids that persist."""
    from plviwo_tpu_torch.sim.simulator import SimConfig, Simulator

    sim = Simulator(SimConfig(duration=2.0, seed=2, n_lines=40))
    kt = KltTracker(n_pts=80, cam_k=np.asarray(sim.cfg.intrinsics), device="cpu")
    lt = LineTracker(max_lines=30, min_length=30.0, device="cpu")
    persist, prev_ids = 0, None
    for t in sim.cam_times()[:6]:
        img = sim.render_frame(t, with_lines=True)
        lids, _, _ = lt.feed(img, *kt.feed(img))
        assert len(lids) >= 2, f"too few lines tracked at t={t}"
        if prev_ids is not None:
            persist += len(np.intersect1d(lids, prev_ids))
        prev_ids = lids
    assert persist >= 5, f"line ids do not persist (persist={persist})"
