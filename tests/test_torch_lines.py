"""The port's line front-end against the JAX package, on the CPU.

`plviwo_tpu_torch.ops.line_detect.detect_segments_runlen`,
`core.frame._segment_nms` and `core.frame._attach_points` (batch-first)
against their JAX counterparts, on level 1 of the equalized pyramid of
frames rendered by the JAX simulator (the half resolution the frame
detects at), two frames as one B = 2 call; and the port's fixed line
settings against the JAX track_frame's defaults.

Tolerances: the detector's `valid` equal, segments and lengths within
1e-3 px.  Run lengths are sums of 0/1 floats, exact in float32, so a
difference could only come from a pixel within rounding of the support
thresholds (`> cos_tol`, `> mag_thresh`); these frames have none: their
segments agree to about 3e-5 px, the rounding of the snap direction's
sin/cos.  NMS `keep` and the attachments equal, merged endpoints within
1e-3 px.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plviwo_tpu.core.frame import _attach_points as j_attach
from plviwo_tpu.core.frame import _segment_nms as j_nms
from plviwo_tpu.ops import image as j_image
from plviwo_tpu.ops.line_detect import detect_segments_runlen as j_detect
from plviwo_tpu.sim.simulator import SimConfig, Simulator
from plviwo_tpu_torch.core import frame
from plviwo_tpu_torch.ops import line_detect

torch.set_num_threads(1)
# the settings the frame detects with, constants of the port
DETECT = dict(grid=line_detect.LINE_GRID, n_anchors=line_detect.LINE_ANCHORS,
              max_steps=line_detect.LINE_STEPS)


@pytest.fixture(scope="module")
def half_res():
    """Level 1 of the equalized pyramids of two rendered frames (2,240,320)
    and the JAX detector's output on each."""
    sim = Simulator(SimConfig(duration=6.0, n_landmarks=350, n_lines=40, seed=3))
    lv = [np.asarray(j_image.build_pyramid(
        j_image.hist_equalize_quantile(jnp.asarray(sim.render_frame(t))), 3)[1])
        for t in (1.1, 1.4)]
    return np.stack(lv), [[np.asarray(a) for a in j_detect(jnp.asarray(x), **DETECT)] for x in lv]


def test_line_constants_are_the_jax_frames_defaults():
    """The port's fixed line settings are the JAX track_frame's defaults."""
    from plviwo_tpu.core.frame import track_frame as j_track_frame

    want = {k: p.default for k, p in inspect.signature(j_track_frame).parameters.items()}
    got = dict(line_grid=line_detect.LINE_GRID, line_anchors=line_detect.LINE_ANCHORS,
               line_steps=line_detect.LINE_STEPS, min_line_length=frame.MIN_LINE_LENGTH,
               min_track_line=frame.MIN_TRACK_LINE)
    assert got == {k: want[k] for k in got}


def test_shift2d_matches_jax():
    from plviwo_tpu.ops.line_detect import _shift2d as j_shift

    x = np.random.default_rng(0).normal(size=(2, 7, 9)).astype(np.float32)
    for dy, dx in ((0, 0), (1, 0), (-2, 3), (4, -1), (-8, -9), (7, 9)):
        got = line_detect._shift2d(torch.as_tensor(x), dy, dx, fill=-1.5).numpy()
        for b in range(2):
            np.testing.assert_array_equal(got[b], np.asarray(j_shift(jnp.asarray(x[b]), dy, dx,
                                                                     fill=-1.5)))


def test_detect_segments_runlen_matches_jax(half_res):
    imgs, want = half_res
    segs, length, valid = line_detect.detect_segments_runlen(torch.as_tensor(imgs))
    assert segs.shape == (2, 192, 4)
    for b, (ws, wl, wv) in enumerate(want):
        np.testing.assert_array_equal(valid[b].numpy(), wv, err_msg=f"{b} valid")
        np.testing.assert_allclose(segs[b].numpy(), ws, rtol=0, atol=1e-3, err_msg=f"{b} segs")
        np.testing.assert_allclose(length[b].numpy(), wl, rtol=0, atol=1e-3, err_msg=f"{b} len")
        assert wv.sum() > 50 and wl.max() > 30


def _nms_both(segs, lengths, valid):
    got = frame._segment_nms(torch.as_tensor(segs), torch.as_tensor(valid))
    want = [[np.asarray(a) for a in j_nms(jnp.asarray(segs[b]), jnp.asarray(lengths[b]),
                                           jnp.asarray(valid[b]), frame.MIN_LINE_LENGTH)]
            for b in range(segs.shape[0])]
    for b, (ws, wk, _) in enumerate(want):
        np.testing.assert_array_equal(got[1][b].numpy(), wk, err_msg=f"{b} keep")
        np.testing.assert_allclose(got[0][b].numpy(), ws, rtol=0, atol=1e-3, err_msg=f"{b} segs")
    return got


def test_segment_nms_and_attach_match_jax_on_detections(half_res):
    """NMS on the detector's candidates at full-resolution coordinates (as
    the frame calls it), then point attachment of random points and points
    on the kept segments."""
    _, det = half_res
    segs = np.stack([2.0 * d[0] for d in det])
    lengths = np.stack([2.0 * d[1] for d in det])
    valid = np.stack([d[2] for d in det])
    merged, keep = _nms_both(segs, lengths, valid)
    assert 0 < int(keep.sum()) < int(valid.sum())
    rng = np.random.default_rng(1)
    m = merged.numpy()
    on = [m[b, keep[b].numpy()] for b in range(2)]
    uv = np.stack([np.concatenate([
        rng.uniform([0, 0], [640, 480], size=(40, 2)),
        o[:24, :2] + rng.uniform(0.0, 1.0, size=(min(len(o), 24), 1)) * (o[:24, 2:] - o[:24, :2])
        + rng.normal(0, 2.0, size=(min(len(o), 24), 2))])[:60] for o in on]).astype(np.float32)
    pv = rng.uniform(size=(2, uv.shape[1])) < 0.9
    got = frame._attach_points(merged, keep, torch.as_tensor(uv), torch.as_tensor(pv))
    for b in range(2):
        want = j_attach(jnp.asarray(m[b]), jnp.asarray(keep[b].numpy()), jnp.asarray(uv[b]),
                        jnp.asarray(pv[b]))
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(want))
    assert int(got.sum()) > 10


def test_segment_nms_breaks_length_ties_by_index():
    """Equal-length collinear duplicates: the lower index survives and
    absorbs the others' span; a shorter collinear fragment extends it; an
    invalid and a too-short segment are dropped; a crossing segment stays.
    Two sequences, the second with its segments in another order."""
    base = np.array([
        [100.0, 100.0, 200.0, 100.0],   # 0: length 100
        [150.0, 101.0, 250.0, 101.0],   # 1: length 100, collinear, overlaps 0
        [240.0, 100.5, 300.0, 100.5],   # 2: shorter, continues 1
        [100.0, 300.0, 100.0, 340.0],   # 3: other line, length 40
        [120.0, 300.0, 140.0, 300.0],   # 4: too short (20 < 30)
        [400.0, 50.0, 400.0, 250.0],    # 5: invalid
        [150.0, 50.0, 150.0, 150.0],    # 6: crosses 0, perpendicular
    ], np.float32)
    valid = np.array([True, True, True, True, True, False, True])
    perm = np.array([1, 0, 6, 2, 5, 3, 4])
    segs = np.stack([base, base[perm]])
    lengths = np.linalg.norm(segs[..., 2:] - segs[..., :2], axis=-1).astype(np.float32)
    merged, keep = _nms_both(segs, lengths, np.stack([valid, valid[perm]]))
    assert keep[0].tolist() == [True, False, False, True, False, False, True]
    assert keep[1].tolist() == [True, False, True, False, False, True, False]
    # segment 0 absorbed 1 and, through 1's span, 2: it now spans x 100-300
    assert merged[0, 0].tolist() == pytest.approx([100.0, 100.0, 300.0, 100.0], abs=1e-3)
