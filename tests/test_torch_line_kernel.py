"""The identities the run-length kernel (`csrc/line_runlen.cu`) rests on,
on the CPU.

`restated_reaches` below restates the kernel pixel by pixel in numpy, with
its indexing: the support bits of the 8 directions packed in one byte and
OR-dilated over the in-image 3 x 3 neighbourhood; each full-field round
reading, for a pixel p, the window of half-width h around q = p +- s d
along the lateral axis (0 outside the image, and no window at all when q
is outside); the last round at the anchors only.  Each identity is held to
the plain pad-and-slice functions of `ops/line_detect.py`, and the whole
restatement to `line_detect.runlen_reaches`, exactly.  On the card
tests/test_torch_cuda.py holds the kernel to the plain version bit for bit.
"""

import math

import numpy as np
import pytest
import torch

from plviwo_tpu_torch.examples import line_images
from plviwo_tpu_torch.ops import image, line_detect, line_kernel

torch.set_num_threads(1)
DIRS = line_detect._DIRS8.tolist()


def _lateral_x(k):
    return abs(DIRS[k][0]) <= abs(DIRS[k][1])


def _grid(H, W):
    y, x = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    return y, x


def _read(r, wy, wx):
    """r (B, H, W) at pixels (wy, wx) (H, W), 0 outside the image."""
    H, W = r.shape[-2:]
    inside = (wy >= 0) & (wy < H) & (wx >= 0) & (wx < W)
    return np.where(inside, r[:, np.clip(wy, 0, H - 1), np.clip(wx, 0, W - 1)], 0)


def window_max(r, half, lat_x):
    """The kernel's lateral window at every pixel: the max of r over the
    in-image pixels within `half` along x (lat_x) or y."""
    y, x = _grid(*r.shape[-2:])
    out = np.zeros_like(r)
    for t in range(-half, half + 1):
        out = np.maximum(out, _read(r, y + (0 if lat_x else t), x + (t if lat_x else 0)))
    return out


def cont(r, k, sgn, step, half):
    """What round (k, fore (+1) / aft (-1), step) adds where r >= step: the
    window around q = p + sgn step d, 0 where q is outside the image."""
    H, W = r.shape[-2:]
    y, x = _grid(H, W)
    qy, qx = y + sgn * step * DIRS[k][1], x + sgn * step * DIRS[k][0]
    lat_x = _lateral_x(k)
    out = np.zeros_like(r)
    for t in range(-half, half + 1):
        out = np.maximum(out, _read(r, qy + (0 if lat_x else t), qx + (t if lat_x else 0)))
    q_in = (qy >= 0) & (qy < H) & (qx >= 0) & (qx < W)
    return np.where(q_in, out, 0)


def packed_support(dlx, dly, mag):
    """One byte a pixel: bit k is direction k's support, OR-dilated 3 x 3
    over the in-image neighbours; float32 products and sums rounded one by
    one, as the kernel's __fmul_rn / __fadd_rn."""
    _, _, units, cos_tol, mag_thresh = line_kernel.constants()
    f32 = np.float32
    strong = mag > f32(mag_thresh)
    bits = np.zeros(mag.shape, np.uint8)
    for k in range(8):
        c = dlx * f32(units[k]) + dly * f32(units[8 + k])
        bits |= ((np.abs(c) > f32(cos_tol)) & strong).astype(np.uint8) << k
    y, x = _grid(*mag.shape[-2:])
    out = np.zeros_like(bits)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            out |= _read(bits, y + dy, x + dx).astype(np.uint8)
    return out


def restated_fields(dlx, dly, mag, rounds=None):
    """The 16 fields (k, fore / aft) after `rounds` full-field rounds
    (default: all but the last), as uint8 (16, B, H, W)."""
    n, halves = line_kernel.constants()[:2]
    rounds = n - 1 if rounds is None else rounds
    sup = packed_support(dlx, dly, mag)
    out = []
    for k in range(8):
        for sgn in (1, -1):
            r = ((sup >> k) & 1).astype(np.int32)
            for m in range(rounds):
                step = 1 << m
                r = r + np.where(r >= step, cont(r, k, sgn, step, halves[m]), 0)
            assert r.max() <= 255
            out.append(r.astype(np.uint8))
    return np.stack(out)


def restated_reaches(dlx, dly, mag, at):
    """The kernel's (reach_f, reach_b), each (B, A, 8) int16: the last round
    at the anchors only, from the previous round's fields."""
    n, halves = line_kernel.constants()[:2]
    fields = restated_fields(dlx, dly, mag)
    B, H, W = mag.shape
    step, half = 1 << (n - 1), halves[n - 1]
    ay, ax = at // W, at % W
    b = np.arange(B)[:, None]
    reach = np.zeros((2, B, at.shape[1], 8), np.int16)
    for k in range(8):
        lat_x = _lateral_x(k)
        for a, sgn in enumerate((1, -1)):
            r = fields[2 * k + a].astype(np.int32)
            v = r[b, ay, ax]
            qy, qx = ay + sgn * step * DIRS[k][1], ax + sgn * step * DIRS[k][0]
            c = np.zeros_like(v)
            for t in range(-half, half + 1):
                wy, wx = qy + (0 if lat_x else t), qx + (t if lat_x else 0)
                inside = (wy >= 0) & (wy < H) & (wx >= 0) & (wx < W)
                c = np.maximum(c, np.where(inside, r[b, np.clip(wy, 0, H - 1),
                                                     np.clip(wx, 0, W - 1)], 0))
            q_in = (qy >= 0) & (qy < H) & (qx >= 0) & (qx < W)
            reach[a, ..., k] = v + np.where((v >= step) & q_in, c, 0)
    return reach[0], reach[1]


def detector_args(img):
    """The (dlx, dly, mag, at) that `detect_segments_runlen(img)` hands the
    wrapper."""
    seen = []

    def keep(*args):
        seen.append(args)
        return line_detect.runlen_reaches(*args)

    real = line_kernel.line_runlen
    line_kernel.line_runlen = keep
    try:
        line_detect.detect_segments_runlen(img)
    finally:
        line_kernel.line_runlen = real
    assert len(seen) == 1
    return seen[0]


# the frame's level 1 at the fleet's 1280 x 560 (B = 1), a distributed
# sharded frame's 160 x 120 (B = 2), and an odd size
SHAPES = {"fleet_level1": (1, 280, 640), "sharded": (2, 120, 160), "odd": (1, 197, 333)}


@pytest.fixture(scope="module")
def args():
    out = {}
    for name, (B, H, W) in SHAPES.items():
        img = torch.as_tensor(line_images(B, H, W, seed=B + H))
        out[name] = detector_args(img)
    return out


@pytest.mark.parametrize("m", range(7))
def test_lateral_window_of_half_width_2m_minus_1_equals_lat_dilate(m):
    """Round m's window half-width (1, 1, 1, 3, 7, 15, 15) is what
    `_lat_dilate`'s doubling covers up to the round's drift, and the window
    max over the in-image pixels equals it along either lateral axis."""
    rounds, halves = line_kernel.constants()[:2]
    assert rounds == 7 and halves == (1, 1, 1, 3, 7, 15, 15)
    drift = int(math.ceil(0.22 * 2**m))
    assert halves[m] == 2 ** drift.bit_length() - 1
    r = np.random.default_rng(m).integers(0, 2 ** (m + 1) + 1, size=(2, 37, 45)).astype(np.int16)
    for ly, lx in ((0, 1), (1, 0)):
        want = line_detect._lat_dilate(torch.as_tensor(r), drift, ly, lx).numpy()
        np.testing.assert_array_equal(window_max(r, halves[m], lx == 1), want)


@pytest.mark.parametrize("k", range(8))
def test_cont_is_zero_where_the_shifted_centre_leaves_the_image(k):
    """For every round, fore and aft: the kernel's cont equals the plain
    version's shifted dilation, 0 wherever q leaves the image, also where
    the window around q would reach back into it."""
    rounds, halves = line_kernel.constants()[:2]
    H, W = 41, 67
    r = np.random.default_rng(k).integers(1, 64, size=(2, H, W)).astype(np.int16)
    sx, sy = DIRS[k]
    ly, lx = (0, 1) if _lateral_x(k) else (1, 0)
    y, x = _grid(H, W)
    reached_back = 0
    for m in range(rounds):
        step, drift = 1 << m, int(math.ceil(0.22 * 2**m))
        dil = line_detect._lat_dilate(torch.as_tensor(r), drift, ly, lx)
        for sgn in (1, -1):
            want = line_detect._shift2d(dil, sgn * step * sy, sgn * step * sx).numpy()
            got = cont(r, k, sgn, step, halves[m])
            np.testing.assert_array_equal(got, want, err_msg=f"m={m} sgn={sgn}")
            qy, qx = y + sgn * step * sy, x + sgn * step * sx
            out = ~((qy >= 0) & (qy < H) & (qx >= 0) & (qx < W))
            assert not got[:, out].any()
            # q just outside, its window partly inside
            wy, wx = qy + ly * halves[m], qx + lx * halves[m]
            back = out & (((wy >= 0) & (wy < H) & (wx >= 0) & (wx < W))
                          | ((qy - ly * halves[m] >= 0) & (qy - ly * halves[m] < H)
                             & (qx - lx * halves[m] >= 0) & (qx - lx * halves[m] < W)))
            reached_back += int(back.sum())
    # an axis-aligned ray leaves the image across its own axis only, which
    # the lateral window never crosses back
    assert (reached_back > 0) == (sx != 0 and sy != 0)


@pytest.mark.parametrize("case", ["lines", "random"])
def test_packed_dilated_support_equals_the_per_direction_support(case):
    """Bit k of the packed, OR-dilated support byte equals the plain
    version's int16 support of direction k after its two max passes."""
    if case == "lines":
        dlx, dly, mag, _ = detector_args(torch.as_tensor(line_images(2, 60, 90, seed=5)))
    else:
        rng = np.random.default_rng(3)
        ang = rng.uniform(-np.pi, np.pi, size=(2, 60, 90))
        dlx, dly = (torch.as_tensor(f(ang).astype(np.float32)) for f in (np.cos, np.sin))
        mag = torch.as_tensor(rng.uniform(0.0, 0.04, size=ang.shape).astype(np.float32))
    got = packed_support(dlx.numpy(), dly.numpy(), mag.numpy())
    cos_tol = float(np.cos(line_detect.ANG_TOL))
    for k, (sx, sy) in enumerate(DIRS):
        norm = float(np.hypot(sx, sy))
        sup = ((torch.abs(dlx * (sx / norm) + dly * (sy / norm)) > cos_tol)
               & (mag > line_detect.MAG_THRESH)).to(torch.int16)
        s = line_detect._shift2d
        sup = torch.maximum(torch.maximum(s(sup, -1, 0), sup), s(sup, 1, 0))
        sup = torch.maximum(torch.maximum(s(sup, 0, -1), sup), s(sup, 0, 1))
        np.testing.assert_array_equal((got >> k) & 1, sup.numpy(), err_msg=f"k={k}")
        assert 0 < int(sup.sum()) < sup.numel()


def test_runs_never_exceed_128():
    """A level-line direction of (1, 1) everywhere supports directions 0-4
    at every pixel: after the 7 rounds, full field, the longest run is 2^7
    = 128 steps, so uint8 holds every field; on the synthetic lines, too,
    no run passes 128."""
    H, W = 150, 300
    ones = np.ones((1, H, W), np.float32)
    fields = restated_fields(ones, ones, ones, rounds=7)
    assert int(fields.max()) == 128
    dlx, dly, mag, _ = detector_args(torch.as_tensor(line_images(1, H, W, seed=2)))
    fields = restated_fields(dlx.numpy(), dly.numpy(), mag.numpy(), rounds=7)
    assert 1 < int(fields.max()) <= 128


@pytest.mark.parametrize("shape", list(SHAPES))
def test_restated_kernel_equals_the_plain_reaches(args, shape):
    """The numpy restatement of the kernel, the last round at the anchors
    only, returns the plain loop's reaches exactly."""
    dlx, dly, mag, at = args[shape]
    want = line_detect.runlen_reaches(dlx, dly, mag, at)
    got = restated_reaches(dlx.numpy(), dly.numpy(), mag.numpy(), at.numpy())
    for g, w in zip(got, want):
        assert w.dtype == torch.int16 and w.shape == (mag.shape[0], line_detect.LINE_ANCHORS, 8)
        np.testing.assert_array_equal(g, w.numpy())
    assert int(want[0].max()) > 8 and int(want[1].max()) > 8


@pytest.mark.parametrize("shape", list(SHAPES))
def test_wrapper_on_cpu_tensors_returns_the_plain_reaches(args, shape):
    """On CPU tensors the wrapper runs the plain loop, launches nothing."""
    before = line_kernel.reaches.launches
    got = line_kernel.line_runlen(*args[shape])
    want = line_detect.runlen_reaches(*args[shape])
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert line_kernel.reaches.launches == before


def test_wrapper_rejects_another_device():
    dlx, dly, mag, at = (t.to("meta") for t in detector_args(
        torch.as_tensor(line_images(1, 40, 60, seed=1))))
    with pytest.raises(ValueError, match="unsupported device"):
        line_kernel.line_runlen(dlx, dly, mag, at)


def test_detector_reads_the_reaches_through_the_wrappers_module_name(monkeypatch):
    """detect_segments_runlen calls `line_kernel.line_runlen` once, looked
    up at the call, with the anchors of every image."""
    img = image.build_pyramid(torch.as_tensor(line_images(2, 240, 320, seed=9)), 2)[1]
    calls = []
    real = line_kernel.line_runlen

    def spy(*a):
        calls.append(a)
        return real(*a)

    monkeypatch.setattr(line_kernel, "line_runlen", spy)
    segs, length, valid = line_detect.detect_segments_runlen(img)
    assert len(calls) == 1 and calls[0][3].shape == (2, line_detect.LINE_ANCHORS)
    assert int(valid.sum()) > 20 and float(length.max()) > 30
