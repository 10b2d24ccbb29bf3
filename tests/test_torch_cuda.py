"""CUDA kernels of the port against their plain PyTorch versions, on a card.

Every test here needs an NVIDIA card (marker `cuda`) and skips without one.
The file imports no JAX, so it also runs where JAX is not installed; from
the repository root on a machine with a card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(`--noconftest`: tests/conftest.py configures JAX.)

Tolerances: gate/Gram `ok` equal, G and c within atol 2e-5 max|G|, rtol
2e-4 (the bounds of tests/test_msckf_kernel.py); the fused step within
max|dp| < 1e-5 and max|dcov| < 1e-4 max|cov|; the LK kernel `ok` equal on
>= 99% of the features and, where both accept, median |duv| < 1e-3 px and
max < 0.05 px (the bounds of tests/test_lk_kernel.py: the kernel's samples
equal the plain version's, its warp sums take another order); the gather LK
`ok` equal and pixels within 1e-3 px of the CPU's; the tag detector's
detections equal to the CPU's and corners within 1e-3 px; the sharded full
step on two ranks that share the card within 1e-9 of one process.
"""

import numpy as np
import pytest
import torch

from plviwo_tpu_torch.examples import SIGMA_LINE, WHEEL_NOISE, batch_args, example_inputs_full
from plviwo_tpu_torch.ops.chi2 import _TABLE as _CHI2_NP
from plviwo_tpu_torch.ops.msckf_kernel import gram_gate, gram_gate_plain

F32 = np.float32
COUNTS = ("accepted", "lines_accepted", "wheel_accepted")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _systems(rng, B, F, M, D, k, dev):
    """Random per-feature systems (as tests/test_msckf_kernel.py makes them)
    for B sequences, on `dev`."""
    Hx = rng.normal(size=(B, F, M, D)).astype(F32)
    Hf = rng.normal(size=(B, F, M, k)).astype(F32)
    r = rng.normal(size=(B, F, M)).astype(F32)
    rowmask = rng.uniform(size=(B, F, M)) < 0.7
    # features with 0, k + 1, 1 and k valid rows: the early exit (<= k rows)
    # and the least count that still runs the chain
    rowmask[:, 0] = False
    rowmask[:, 1] = np.arange(M) < (k + 1)
    rowmask[:, 2] = np.arange(M) < 1
    rowmask[:, 3] = np.arange(M) < k
    A = rng.normal(size=(B, D, 2 * D)).astype(F32)
    cov = (A @ A.transpose(0, 2, 1) / (2 * D) * 0.05).astype(F32)
    return [torch.as_tensor(a, device=dev) for a in (Hx, Hf, r, rowmask, cov)]


def _gate_vec(M, chi2_mult, dev):
    return torch.as_tensor(_CHI2_NP[: M + 1].astype(F32) * F32(chi2_mult), device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("k,B,F,M,D", [
    (3, 4, 40, 40, 162), (4, 4, 16, 40, 162),  # the filter bench's M and D
    # the CPU tests' shapes: fewer rows than one pass-1 row chunk, and D + 1
    # not a multiple of the pass-2 tile
    (3, 1, 8, 12, 40), (4, 1, 8, 12, 40),
    (3, 64, 128, 16, 124),  # the images-in frame: 128 slots x 8 obs, D = 124
    # the images-in frame with lines and GPS (D = 132): points, lines
    (3, 64, 128, 16, 132), (4, 64, 24, 16, 132),
    # the live driver, one vehicle: 96 point and 20 / 16 line slots x 12 obs
    # (M = 24), D = 116 without GPS (run_sim's default) and 120 with it
    (3, 1, 96, 24, 116), (4, 1, 20, 24, 116), (3, 1, 96, 24, 120), (4, 1, 16, 24, 120),
    # stereo point rows, a feature's left and right series (M = 4 obs): the
    # images-in frame with two cameras (D = 147) and the live driver (D = 127)
    (3, 64, 128, 32, 147), (3, 1, 96, 48, 127),
    # F not a multiple of the features per block; one sequence; M - k > 32;
    # D = 162: 648-byte rows, 8-byte aligned on odd rows; D = 41: rows only
    # 4-byte aligned
    (3, 2, 13, 16, 124), (3, 1, 40, 40, 162), (3, 3, 6, 40, 162), (4, 1, 5, 64, 33),
    (4, 3, 7, 12, 41)])
def test_kernel_matches_plain(cuda_device, k, B, F, M, D):
    Hx, Hf, r, rowmask, cov = _systems(np.random.default_rng(30 + k + M), B, F, M, D, k,
                                       cuda_device)
    w = torch.full(r.shape, 1.0 / 1.3, device=cuda_device)
    gate_vec = _gate_vec(M, 5.0, cuda_device)
    before = gram_gate.launches
    G1, c1, ok1, chi1 = gram_gate(Hx, Hf, r, rowmask, w, cov, gate_vec, 15.0)
    G0, c0, ok0, chi0 = gram_gate_plain(Hx, Hf, r, rowmask, w, cov, gate_vec, 15.0)
    torch.cuda.synchronize()
    assert gram_gate.launches == before + 1
    assert torch.equal(ok1, ok0) and 0 < int(ok1.sum()) < ok1.numel()
    for a, b in ((G1, G0), (c1, c0)):
        sc = float(b.abs().max()) + 1e-9
        torch.testing.assert_close(a, b, atol=2e-5 * sc, rtol=2e-4)
    n = rowmask.sum(-1)
    has = n > k
    torch.testing.assert_close(chi1[has], chi0[has], rtol=1e-3, atol=0.0)
    # the early exit: no projected rows left, nothing accepted, chi2 = 0
    assert not bool(ok1[~has].any()) and bool((chi1[~has] == 0).all())
    assert not bool(ok1[n == k + 1].any())


@pytest.mark.cuda
def test_kernel_selects_away_unwritten_rows(cuda_device):
    """Pass 1 writes the projected rows of accepted features only; pass 2
    must select zeros for the others whatever the scratch memory held (here
    NaN left by a freed tensor that the allocator hands out again)."""
    k, B, F, M, D = 3, 8, 128, 16, 124
    Hx, Hf, r, rowmask, cov = _systems(np.random.default_rng(7), B, F, M, D, k, cuda_device)
    args = (Hx, Hf, r, rowmask, torch.full(r.shape, 1.0 / 1.3, device=cuda_device), cov,
            _gate_vec(M, 5.0, cuda_device), 15.0)
    G0, c0, ok0, _ = gram_gate_plain(*args)
    junk = torch.full((B * F * (M - k) * (D + 1),), float("nan"), device=cuda_device)
    del junk
    G1, c1, ok1, _ = gram_gate(*args)
    torch.cuda.synchronize()
    assert torch.equal(ok1, ok0) and 0 < int(ok1.sum()) < ok1.numel()
    for a, b in ((G1, G0), (c1, c0)):
        torch.testing.assert_close(a, b, atol=2e-5 * (float(b.abs().max()) + 1e-9), rtol=2e-4)


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda_device):
    Hx, Hf, r, rowmask, cov = _systems(np.random.default_rng(5), 1, 4, 10, 24, 3,
                                       cuda_device)
    w = torch.ones_like(r)
    gate_vec = _gate_vec(10, 1.0, cuda_device)
    with pytest.raises(ValueError):
        gram_gate(Hx.double(), Hf, r, rowmask, w, cov, gate_vec, 1.0)
    with pytest.raises(ValueError):
        gram_gate(Hx.transpose(-1, -2).contiguous().transpose(-1, -2), Hf, r, rowmask,
                  w, cov, gate_vec, 1.0)
    with pytest.raises(ValueError):
        gram_gate(Hx, Hf, r, rowmask, w, cov.cpu(), gate_vec, 1.0)
    # more rows than two per lane, or more than eight covariance columns per lane
    for F, M, D in ((4, 65, 24), (4, 10, 257)):
        Hx, Hf, r, rowmask, cov = _systems(np.random.default_rng(6), 1, F, M, D, 3, cuda_device)
        with pytest.raises(ValueError, match="does not take"):
            gram_gate(Hx, Hf, r, rowmask, torch.ones_like(r), cov, _gate_vec(M, 1.0, cuda_device),
                      1.0)


@pytest.mark.cuda
def test_step_kernel_path_matches_plain_path(cuda_device, monkeypatch):
    """fused_step_full on the card launches the kernel twice per frame and
    matches the same step with the plain gate."""
    from plviwo_tpu_torch.core import step

    b = batch_args(example_inputs_full(n_clones=8, F=6, O=5, imu_n=8, L=3, n_wheel=8,
                                       device=cuda_device), 3, cuda_device)

    def run():
        return step.fused_step_full(*b, SIGMA_LINE, WHEEL_NOISE, cam_dtype=torch.float32)

    before = gram_gate.launches
    s1, m1 = run()
    torch.cuda.synchronize()
    assert gram_gate.launches == before + 2
    monkeypatch.setattr(step, "gram_gate", gram_gate_plain)
    s0, m0 = run()
    for k in COUNTS:
        assert torch.equal(m1[k], m0[k]) and int(m1[k].sum()) > 0
    assert float((s1.p - s0.p).abs().max()) < 1e-5
    assert float((s1.cov - s0.cov).abs().max()) < 1e-4 * float(s0.cov.abs().max())


def _lk_inputs(B, n_pts, dev, seed=0):
    from plviwo_tpu_torch.examples import lk_pair
    from plviwo_tpu_torch.sim.simulator import SimConfig, Simulator

    sim = Simulator(SimConfig(duration=3.0, n_landmarks=350, n_lines=40, seed=3))
    gen = torch.Generator(device=dev).manual_seed(seed)
    return lk_pair(sim, B, n_pts, 1.0, gen)


def _assert_lk_close(out, ref, sel=None):
    """The kernel's (uv, ok, err, det) against the plain version's, over the
    features `sel` (all by default)."""
    if sel is not None:
        out, ref = ([t[sel] for t in o] for o in (out, ref))
    (uv1, ok1, err1, det1), (uv0, ok0, err0, det0) = out, ref
    assert float((ok1 == ok0).float().mean()) >= 0.99
    both = ok1 & ok0
    # the per-sequence noise makes the sky's flat 0.5 a texture of noise
    # after equalization: corners there fail, as in the bench
    assert int(both.sum()) >= 0.1 * ok0.numel()
    d = torch.linalg.vector_norm(uv1 - uv0, dim=-1)[both]
    assert float(d.median()) < 1e-3 and float(d.max()) < 0.05, (float(d.median()), float(d.max()))
    torch.testing.assert_close(det1, det0, rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(err1[both], err0[both], rtol=1e-3, atol=1e-6)


def _nan_empty(empty):
    """torch.empty that fills what it returns with NaN (bool: byte 255), so
    an output the kernel leaves unwritten shows."""
    def filled(*args, **kwargs):
        t = empty(*args, **kwargs)
        if t.dtype == torch.bool:
            t.view(torch.uint8).fill_(255)
        else:
            t.fill_(float("nan"))
        return t
    return filled


# case: (B, n_pts, levels, half, variant).  The main path's size, the live
# driver's (one vehicle, 96 slots) and a small one; one and two levels; a
# 7 x 7 window; B * N not a multiple of the features per block; features
# within a few pixels of the border (the patch origins clip); the last
# sequence's images flat (det = 0: no step, not ok); a third of the
# features invalid.
LK_CASES = {
    "main-path": (64, 128, 3, 7, None), "live-driver": (1, 96, 3, 7, None),
    "small": (2, 48, 3, 7, None),
    "levels-1": (2, 48, 1, 7, None), "levels-2": (2, 48, 2, 7, None),
    "half-3": (2, 48, 3, 3, None), "ragged-3x37": (3, 37, 3, 7, None),
    "border": (2, 48, 3, 7, "border"), "flat": (3, 48, 3, 7, "flat"),
    "invalid": (2, 48, 3, 7, "invalid"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(LK_CASES))
def test_lk_kernel_matches_plain(cuda_device, case, monkeypatch):
    from plviwo_tpu_torch.ops import klt, lk_kernel

    B, n_pts, levels, half, variant = LK_CASES[case]
    prev_pyr, next_pyr, uv, valid = _lk_inputs(B, n_pts, cuda_device)
    H, W = prev_pyr[0].shape[-2:]
    sel = torch.ones_like(valid)
    if variant == "border":
        uv[:, :8] = torch.tensor([[1.5, 2.5], [W - 2.3, 3.1], [2.2, H - 1.6], [W - 1.2, H - 2.8],
                                  [W / 2 + 0.3, 0.7], [W / 2 - 0.4, H - 4.2], [4.6, H / 2 + 0.2],
                                  [W - 5.1, H / 2 - 0.6]], device=cuda_device)
        valid[:, :8] = True
    elif variant == "flat":
        prev_pyr, next_pyr = (tuple(torch.cat([p[:-1], torch.full_like(p[-1:], 0.5)])
                                    for p in pyr) for pyr in (prev_pyr, next_pyr))
        sel[-1] = False
    elif variant == "invalid":
        valid[:, ::3] = False
        sel = valid.clone()
    args = (prev_pyr, next_pyr, uv, valid, levels, half, 6)
    before = lk_kernel.lk_pyramid.launches
    with monkeypatch.context() as m:
        m.setattr(torch, "empty", _nan_empty(torch.empty))
        out = lk_kernel.lk_pyramid(*args)
    ref = klt.pyramidal_lk_conv_full(*args)
    torch.cuda.synchronize()
    uv1, ok1, err1, det1 = out
    assert all(bool(torch.isfinite(t).all()) for t in (uv1, err1, det1))
    assert int(ok1.view(torch.uint8).max()) <= 1
    _assert_lk_close(out, ref, sel)
    if variant == "flat":  # no step at any level: uv stays uv_prev, and fails
        for o in (out, ref):
            assert bool((o[3][-1] == 0).all()) and not bool(o[1][-1].any())
            assert torch.equal(o[0][-1], uv[-1])
    if variant == "invalid":
        assert not bool(ok1[~valid].any()) and not bool(ref[1][~valid].any())
    assert lk_kernel.lk_pyramid.launches == before + 1


@pytest.mark.cuda
def test_lk_kernel_rejects_what_it_does_not_take(cuda_device):
    from plviwo_tpu_torch.ops import lk_kernel

    prev_pyr, next_pyr, uv, valid = _lk_inputs(1, 8, cuda_device)
    with pytest.raises(ValueError):
        lk_kernel.pyramidal_lk(prev_pyr, next_pyr, uv.double(), valid, 3)
    with pytest.raises(ValueError):
        lk_kernel.pyramidal_lk(prev_pyr, next_pyr, uv, valid.cpu(), 3)
    with pytest.raises(ValueError):
        lk_kernel.pyramidal_lk(tuple(p[..., ::2] for p in prev_pyr), next_pyr, uv, valid, 3)
    with pytest.raises(ValueError):  # a 29-px patch does not fit a 15-px level
        lk_kernel.pyramidal_lk(tuple(p[:, :15, :15].contiguous() for p in prev_pyr),
                               tuple(p[:, :15, :15].contiguous() for p in next_pyr), uv, valid, 3)
    # a window wider than 16 px (a lane's column of 8 rows, 16 columns)
    with pytest.raises(ValueError, match="does not take"):
        lk_kernel.pyramidal_lk(prev_pyr, next_pyr, uv, valid, 3, half=8)
    lk_kernel.pyramidal_lk(prev_pyr, next_pyr, uv, valid, 3, half=7)


@pytest.mark.cuda
def test_frame_kernel_path_matches_plain_path(cuda_device, monkeypatch):
    """Five images-in frames of points, lines, wheel and GPS at B = 2 (a GPS
    fix between two clones in the fourth): the kernel path launches LK once
    and gate/Gram twice (points, lines) per frame and matches the path with
    both plain versions."""
    from plviwo_tpu_torch import examples
    from plviwo_tpu_torch.core import frame, step
    from plviwo_tpu_torch.core.layout import StateLayout
    from plviwo_tpu_torch.core.state import FilterState
    from plviwo_tpu_torch.ops import klt, lk_kernel
    from plviwo_tpu_torch.sim.simulator import SimConfig, Simulator

    sim = Simulator(SimConfig(duration=3.0, n_landmarks=350, n_lines=40, seed=3))
    layout = StateLayout(n_clones=6, n_cams=1, use_wheel=True, n_gps=1)
    frames = examples.frame_inputs(sim, 2, 5, torch.Generator(device=cuda_device).manual_seed(1),
                                   t0=1.7)
    gravity = torch.tensor([0.0, 0.0, 9.81], dtype=torch.float64, device=cuda_device)

    def run():
        st = FilterState.from_numpy([examples.seed_state(sim, layout, 1.7)] * 2, layout,
                                    cuda_device)
        ts = frame.make_track_state(480, 640, 32, 8, 3, batch=2, device=cuda_device)
        out = []
        for f in frames:
            st, ts, m = frame.fused_frame(
                st, ts, f["img"], *f["imu"], f["t_new"], *f["wheel"],
                torch.ones(2, dtype=torch.bool, device=cuda_device), gravity,
                (1.7e-4, 2.0e-3, 1.9e-5, 3.0e-3), 1.5, 8.0, 2.0, (0.05, 0.05, 0.02),
                use_gps=True, gps_t=f["gps"][0], gps_p=f["gps"][1], gps_valid=f["gps"][2],
                sigma_gps=sim.cfg.sigma_gps, gps_chi2_mult=8.0)
            out.append(m)
        return st, out

    before = (lk_kernel.lk_pyramid.launches, gram_gate.launches)
    s1, m1 = run()
    torch.cuda.synchronize()
    assert (lk_kernel.lk_pyramid.launches, gram_gate.launches) == (before[0] + 5, before[1] + 10)
    monkeypatch.setattr(frame.lk_kernel, "pyramidal_lk", klt.pyramidal_lk_conv)
    monkeypatch.setattr(step, "gram_gate", gram_gate_plain)
    s0, m0 = run()
    for a, b in zip(m1, m0):
        for k in ("tracked", "harvested", "accepted", "wheel_accepted", "line_tracked",
                  "line_harvested", "lines_accepted", "gps_accepted"):
            assert torch.equal(a[k], b[k]), k
    assert int(sum(m["tracked"].sum() for m in m1)) > 0
    assert int(sum(m["line_tracked"].sum() for m in m1)) > 0
    assert int(sum(m["gps_accepted"].sum() for m in m1)) > 0
    assert float((s1.p - s0.p).abs().max()) < 1e-5
    assert float((s1.cov - s0.cov).abs().max()) < 1e-4 * float(s0.cov.abs().max())


@pytest.mark.cuda
def test_kernel_matches_plain_on_interpolated_rows(cuda_device):
    """Rows at interpolated poses (dynamic cloning): each observation's two
    rows carry two 6-column clone blocks (one where both bounding slots
    coincide), at the images-in frame's shape (B = 64, 128 features x 8
    obs, D = 132)."""
    from plviwo_tpu_torch.update.cam_helper import _scatter_clone_band

    k, B, F, O, C, off, D = 3, 64, 128, 8, 14, 21, 132
    rng = np.random.default_rng(11)
    s0 = rng.integers(0, C - 1, size=(B, F, O))
    s1 = np.minimum(s0 + rng.integers(0, 2, size=s0.shape), C - 1)
    blocks = [torch.as_tensor(rng.normal(size=(B, F, O, 2, 6)).astype(F32), device=cuda_device)
              for _ in range(2)]
    Hx = _scatter_clone_band(blocks[0], torch.as_tensor(s0, device=cuda_device), C, off, D,
                             blocks[1], torch.as_tensor(s1, device=cuda_device))
    Hx = Hx.reshape(B, F, 2 * O, D).contiguous()
    Hx[..., :off] = torch.as_tensor(0.1 * rng.normal(size=(B, F, 2 * O, off)).astype(F32),
                                    device=cuda_device)
    _, Hf, r, rowmask, cov = _systems(rng, B, F, 2 * O, D, k, cuda_device)
    rowmask = rowmask & torch.as_tensor(np.repeat(rng.uniform(size=(B, F, O)) < 0.8, 2, -1),
                                        device=cuda_device)
    args = (Hx, Hf, r, rowmask, torch.full(r.shape, 1.0 / 1.3, device=cuda_device), cov,
            _gate_vec(2 * O, 5.0, cuda_device), 15.0)
    G1, c1, ok1, _ = gram_gate(*args)
    G0, c0, ok0, _ = gram_gate_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(ok1, ok0) and 0 < int(ok1.sum()) < ok1.numel()
    for a, b in ((G1, G0), (c1, c0)):
        torch.testing.assert_close(a, b, atol=2e-5 * (float(b.abs().max()) + 1e-9), rtol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["stereo", "dynamic"])
def test_frame_modes_kernel_path_matches_plain_path(cuda_device, monkeypatch, mode):
    """Five images-in frames at B = 2 with points and wheel: stereo (two
    cameras, a right image a frame: two LK launches and one gate/Gram per
    frame) or dynamic cloning (sequence b clones where (frame + b) is even:
    one LK and one gate/Gram); the kernel path matches the plain path."""
    from plviwo_tpu_torch import examples
    from plviwo_tpu_torch.core import frame, step
    from plviwo_tpu_torch.core.layout import StateLayout
    from plviwo_tpu_torch.core.state import FilterState
    from plviwo_tpu_torch.ops import klt, lk_kernel
    from plviwo_tpu_torch.sim.simulator import SimConfig, Simulator

    stereo = mode == "stereo"
    sim = Simulator(SimConfig(duration=3.0, n_landmarks=350, n_lines=40, seed=3))
    layout = StateLayout(n_clones=6, n_cams=2 if stereo else 1, use_wheel=True)
    frames = examples.frame_inputs(sim, 2, 5, torch.Generator(device=cuda_device).manual_seed(1),
                                   t0=1.7, gps_pad=0, stereo=stereo)
    gravity = torch.tensor([0.0, 0.0, 9.81], dtype=torch.float64, device=cuda_device)

    def run():
        st = FilterState.from_numpy([examples.seed_state(sim, layout, 1.7)] * 2, layout,
                                    cuda_device)
        ts = frame.make_track_state(480, 640, 32, 8, 3, batch=2, device=cuda_device)
        out = []
        for i, f in enumerate(frames):
            kw = (dict(use_stereo=True, img_r=f["img_r"]) if stereo else dict(
                use_dynamic=True, do_clone=torch.tensor([(i + b) % 2 == 0 for b in range(2)],
                                                        device=cuda_device)))
            st, ts, m = frame.fused_frame(
                st, ts, f["img"], *f["imu"], f["t_new"], *f["wheel"],
                torch.ones(2, dtype=torch.bool, device=cuda_device), gravity,
                (1.7e-4, 2.0e-3, 1.9e-5, 3.0e-3), 1.5, 8.0, 2.0, (0.05, 0.05, 0.02),
                use_lines=False, **kw)
            out.append(m)
        return st, ts, out

    before = (lk_kernel.lk_pyramid.launches, gram_gate.launches)
    s1, ts1, m1 = run()
    torch.cuda.synchronize()
    lk_per_frame = 2 if stereo else 1
    assert (lk_kernel.lk_pyramid.launches, gram_gate.launches) == (
        before[0] + 5 * lk_per_frame, before[1] + 5)
    monkeypatch.setattr(frame.lk_kernel, "pyramidal_lk", klt.pyramidal_lk_conv)
    monkeypatch.setattr(step, "gram_gate", gram_gate_plain)
    s0, _, m0 = run()
    for a, b in zip(m1, m0):
        for k in ("tracked", "harvested", "accepted", "wheel_accepted"):
            assert torch.equal(a[k], b[k]), k
    assert int(sum(m["accepted"].sum() for m in m1)) > 0
    if stereo:
        assert int(ts1.rvalid.sum()) > 0
    else:
        assert int(s1.clone_valid.sum()) < 10
    assert float((s1.p - s0.p).abs().max()) < 1e-5
    assert float((s1.cov - s0.cov).abs().max()) < 1e-4 * float(s0.cov.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["mono_wheel", "stereo_dynamic"])
def test_per_track_frames_on_the_card_match_the_cpu(cuda_device, mode):
    """The per-track path (feed_camera / feed_stereo, the simulator's data
    association) for 1.5 s of simulation on the card and on the CPU: points
    and wheel with one joint update a frame, or stereo with dynamic cloning
    at order 3 under a 4 Hz cap.  `stats` equal after every frame; positions
    within 1e-6 m and the covariance within 1e-5 max|cov| (9.0e-9 m and
    1.9e-7 measured: the card rounds the float32 IMU transition otherwise)."""
    from plviwo_tpu_torch import examples
    from plviwo_tpu_torch.config.options import EstimatorOptions
    from plviwo_tpu_torch.core.system import VioSystem
    from plviwo_tpu_torch.sim.simulator import SimConfig, Simulator

    def run(device):
        sim = Simulator(SimConfig(duration=1.5, seed=1, sigma_pix=0.5, n_pts=45))
        o = EstimatorOptions()
        o.cam.max_msckf, o.cam.sigma_pix, o.cam.min_track_length, o.cam.chi2_mult = 30, 0.5, 4, 5.0
        if mode == "mono_wheel":
            o.wheel.enabled, o.wheel.noise_w, o.wheel.noise_v, o.wheel.noise_p = True, 0.05, 0.05, 0.02
        else:
            o.cam.max_n, o.cam.min_track_length = 2, 6
            o.dynamic_cloning, o.clone_freq, o.intr_order = True, 4, 3
        s = VioSystem(o, device=device)
        examples.live_calibrate(s, sim, float(sim.imu_t[0]))
        out = []
        for kind, args in examples.track_events(sim, stereo=mode != "mono_wheel",
                                                wheel=o.wheel.enabled):
            n = len(s.traj)
            examples.feed(s, kind, args)
            if len(s.traj) > n:
                out.append((dict(s.stats), s.traj[-1][2], s.state.cov[0].cpu().numpy()))
        return out

    card, cpu = run(cuda_device), run("cpu")
    assert len(card) == len(cpu) > 3
    for (sa, pa, ca), (sb, pb, cb) in zip(card, cpu):
        assert sa == sb
        assert np.max(np.abs(pa - pb)) < 1e-6
        assert np.max(np.abs(ca - cb)) < 1e-5 * np.max(np.abs(cb))
    assert card[-1][0]["cam_accept"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["lines", "slam_invdepth"])
def test_per_track_lines_and_slam_on_the_card_match_the_cpu(cuda_device, mode):
    """Per-track lines (tests/test_lines.py's scenario, 2 s) and SLAM
    landmarks (8 inverse-depth slots, every visible point tracked, 2 s) on
    the card and on the CPU: `stats` and the active landmark ids equal after
    every frame, positions within 1e-6 m and the covariance within 1e-5
    max|cov| (2.6e-8 m and 4.9e-7 measured), and no kernel launched on the
    card (no TPU kernel lies on this path)."""
    from plviwo_tpu_torch import examples
    from plviwo_tpu_torch.config.options import EstimatorOptions
    from plviwo_tpu_torch.core.system import VioSystem
    from plviwo_tpu_torch.ops import lk_kernel
    from plviwo_tpu_torch.sim.simulator import SimConfig, Simulator

    lines = mode == "lines"

    def run(device):
        sim = Simulator(SimConfig(duration=2.0, seed=7 if lines else 1, sigma_pix=0.5,
                                  n_pts=35 if lines else 100, sigma_pix_line=1.0, n_lines=50))
        o = EstimatorOptions()
        o.cam.max_msckf, o.cam.sigma_pix, o.cam.min_track_length, o.cam.chi2_mult = 25, 0.5, 4, 5.0
        if lines:
            o.cam.use_lines, o.cam.max_lines, o.cam.sigma_pix_line = True, 20, 2.0
        else:
            o.cam.max_slam, o.cam.feat_rep = 8, "GLOBAL_FULL_INVERSE_DEPTH"
        s = VioSystem(o, device=device)
        examples.live_calibrate(s, sim, float(sim.imu_t[0]))
        out = []
        for kind, args in examples.track_events(sim, lines=lines):
            n = len(s.traj)
            examples.feed(s, kind, args)
            if len(s.traj) > n:
                st = s.state
                ids = sorted(st.slam_id[0][st.slam_valid[0]].tolist())
                out.append((dict(s.stats), s.traj[-1][2], st.cov[0].cpu().numpy(), ids))
        return out

    lk_kernel.lk_pyramid.launches = gram_gate.launches = 0
    card = run(cuda_device)
    assert lk_kernel.lk_pyramid.launches == gram_gate.launches == 0
    cpu = run("cpu")
    assert len(card) == len(cpu) > 10
    for (sa, pa, ca, la), (sb, pb, cb, lb) in zip(card, cpu):
        assert sa == sb and la == lb
        assert np.max(np.abs(pa - pb)) < 1e-6
        assert np.max(np.abs(ca - cb)) < 1e-5 * np.max(np.abs(cb))
    if lines:
        assert card[-1][0]["line_accept"] > 3
    else:
        assert max(len(f[3]) for f in card) >= 3


def _system_on(system, device):
    """A copy of a mono per-track VioSystem with its device state on
    `device` (its C++ feature store, which cannot be copied, rebuilt from
    the Python store's tracks)."""
    import copy
    import dataclasses

    from plviwo_tpu_torch import native

    out = copy.deepcopy(system, {id(system.fdb_native): None})
    if system.fdb_native is not None:
        out.fdb_native = native.NativeFeatureDatabase()
        for fid, tr in out.fdb.tracks.items():
            for t, uv, uvn in zip(tr.times, tr.uvs, tr.uvns):
                out.fdb_native.update(fid, t, uv, uvn)
    for name, value in list(vars(out).items()):
        if isinstance(value, torch.Tensor):
            setattr(out, name, value.to(device))
        elif dataclasses.is_dataclass(value) and not isinstance(value, type):
            setattr(out, name, dataclasses.replace(value, **{
                f.name: getattr(value, f.name).to(device) for f in dataclasses.fields(value)
                if isinstance(getattr(value, f.name), torch.Tensor)}))
    out.device = torch.device(device)
    return out


@pytest.mark.cuda
def test_per_track_frame_from_one_state_matches_the_cpu(cuda_device):
    """tests/test_lines.py's scenario (points + lines, mono) for 3 s: each
    frame starts on the card from the CPU run's state and is processed on
    both, then compared: `stats` equal, positions within 1e-6 m and the
    covariance within 1e-5 max|cov| (1.9e-8 m and 7.6e-8 measured).
    A Gram column of rounding noise, which the card gets where the CPU gets
    an exact zero, once moved one frame's result by up to 3e-2 m."""
    from plviwo_tpu_torch import examples
    from plviwo_tpu_torch.config.options import EstimatorOptions
    from plviwo_tpu_torch.core.system import VioSystem
    from plviwo_tpu_torch.sim.simulator import SimConfig, Simulator

    sim = Simulator(SimConfig(duration=3.0, seed=7, sigma_pix=0.5, n_pts=35, sigma_pix_line=1.0,
                              n_lines=50))
    o = EstimatorOptions()
    o.cam.max_msckf, o.cam.sigma_pix, o.cam.min_track_length, o.cam.chi2_mult = 25, 0.5, 4, 5.0
    o.cam.use_lines, o.cam.max_lines, o.cam.sigma_pix_line = True, 20, 2.0
    cpu = VioSystem(o, device="cpu")
    examples.live_calibrate(cpu, sim, float(sim.imu_t[0]))
    card, frames, worst = None, 0, (0.0, 0.0)
    for kind, args in examples.track_events(sim, lines=True):
        if card is None:
            card = _system_on(cpu, cuda_device)
        n = len(cpu.traj)
        examples.feed(cpu, kind, args)
        examples.feed(card, kind, args)
        if len(cpu.traj) > n:
            assert card.stats == cpu.stats
            a, b = card.state, cpu.state
            dp = max(float(torch.max(torch.abs(a.p.cpu() - b.p))),
                     float(torch.max(torch.abs(a.clone_p.cpu() - b.clone_p))))
            dc = float(torch.max(torch.abs(a.cov.cpu() - b.cov)) / torch.max(torch.abs(b.cov)))
            worst = (max(worst[0], dp), max(worst[1], dc))
            frames, card = frames + 1, None
    print(f"{frames} frames, max |dp| {worst[0]:.3e} m, max |dcov| {worst[1]:.3e} max|cov|")
    assert frames > 25 and cpu.stats["line_accept"] > 3
    assert worst[0] < 1e-6 and worst[1] < 1e-5


@pytest.mark.cuda
def test_interpolation_weights_on_the_card_match_the_cpu(cuda_device):
    """The per-track interpolation table's Vandermonde powers are equal on
    the card and on the CPU bit for bit, and the table's weights, FEJ poses
    and Jacobians (`interp._poly_jacobian`, order 3) agree within 1e-12 of
    max(1, max|x|) (the inverses of the Vandermonde differ by rounding)."""
    from plviwo_tpu_torch.core import interp
    from plviwo_tpu_torch.ops import lie

    rng = np.random.default_rng(0)
    n, T = 3, 4096
    # clone offsets from the anchor, 0.05-0.15 s apart (the Vandermonde stays
    # well conditioned, as with the driver's clone times)
    dts = np.cumsum(rng.uniform(0.05, 0.15, (T, n)), axis=-1)
    dts = torch.as_tensor(np.concatenate([np.zeros((T, 1)), dts], -1))
    dt_eval = torch.as_tensor(rng.uniform(0.0, 1.0, T)) * dts[:, -1]
    dt_eval[::4] = dts[::4, 2]  # measurements at a clone's time
    q = lie.exp_so3(torch.as_tensor(rng.normal(0, 0.05, (T, n + 1, 3))))
    q = lie.rot_2_quat(q)
    p = torch.as_tensor(rng.normal(0, 1.0, (T, n + 1, 3)))
    x = dts[:, 1:] / dts[:, -1:]
    assert torch.equal(interp._powers(x.to(cuda_device), n).cpu(), interp._powers(x, n))
    cpu = interp._poly_jacobian(q, p, dts, dt_eval)
    card = interp._poly_jacobian(*(t.to(cuda_device) for t in (q, p, dts, dt_eval)))
    for a, b in zip(card, cpu):
        scale = max(1.0, float(torch.max(torch.abs(b))))
        assert float(torch.max(torch.abs(a.cpu() - b))) <= 1e-12 * scale


@pytest.fixture
def line_frames(cuda_device):
    """Rendered frames with lines (seed 2, 640 x 480) and the CPU KLT
    tracker's point tracks on them."""
    from plviwo_tpu_torch.sim.simulator import SimConfig, Simulator
    from plviwo_tpu_torch.update.tracker import KltTracker

    sim = Simulator(SimConfig(duration=2.0, seed=2, n_lines=40))
    kt = KltTracker(n_pts=80, cam_k=np.asarray(sim.cfg.intrinsics), device="cpu")
    out = []
    for t in sim.cam_times()[:8]:
        img = sim.render_frame(t, with_lines=True)
        out.append((img,) + kt.feed(img))
    return out


@pytest.mark.cuda
def test_line_tracker_on_the_card_matches_the_cpu(cuda_device, line_frames):
    """The anchor walk and the line tracker on the card against the CPU on
    the same frames and point tracks: the walk's candidates within 1e-3 px
    (valid equal), line ids and attached ids equal, segments within 1e-3 px."""
    from plviwo_tpu_torch.ops import line_detect
    from plviwo_tpu_torch.update.line_tracker import LineTracker

    img = torch.as_tensor(line_frames[0][0], dtype=torch.float32)
    card = [x.cpu() for x in line_detect.detect_segments(img.to(cuda_device))]
    cpu = line_detect.detect_segments(img)
    assert torch.equal(card[2], cpu[2]) and int(cpu[2].sum()) > 50
    assert float((card[0] - cpu[0]).abs().max()) <= 1e-3
    on_card = LineTracker(max_lines=30, min_length=30.0, device=cuda_device)
    on_cpu = LineTracker(max_lines=30, min_length=30.0, device="cpu")
    n = 0
    for img, ids, uvs in line_frames:
        got, want = on_card.feed(img, ids, uvs), on_cpu.feed(img, ids, uvs)
        np.testing.assert_array_equal(got[0], want[0])
        assert len(got[2]) == len(want[2])
        for a, b in zip(got[2], want[2]):
            np.testing.assert_array_equal(a, b)
        if len(got[0]):
            np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-3)
        n += len(got[0])
    assert n > 40 and on_card.host_reads == 2 * len(line_frames)


@pytest.mark.cuda
def test_run_kaist_on_the_card(cuda_device, tmp_path):
    """run_kaist over a 2 s fixture (640 x 480 at 8 Hz) on the card: the
    summary, the native store, no LK launch (the host tracker runs JAX's
    gather LK in plain torch)."""
    import contextlib
    import io
    import json

    from plviwo_tpu_torch import run_kaist
    from plviwo_tpu_torch.ops import lk_kernel
    from plviwo_tpu_torch.sim.kaist_fixture import generate_kaist_fixture, write_fixture_config
    from plviwo_tpu_torch.sim.simulator import SimConfig, Simulator

    sim = Simulator(SimConfig(duration=4.0, n_landmarks=350, n_lines=40, seed=5))
    root = str(tmp_path / "fixture")
    generate_kaist_fixture(root, sim, t_start=1.0, duration=2.0, cam_hz=8.0)
    master = write_fixture_config(str(tmp_path), sim.cfg)
    lk_kernel.lk_pyramid.launches = 0
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = run_kaist.main(["--root", root, "--config", master, "--wheel", "--lines"])
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert rc == 0 and out["frames"] == 16 and out["device"] == torch.cuda.get_device_name(0)
    assert out["feature_store"] == "native" and out["ate_rmse_m"] < 0.5, out
    assert lk_kernel.lk_pyramid.launches == 0


@pytest.mark.cuda
def test_gather_lk_on_the_card_matches_the_cpu(cuda_device):
    """The host trackers' gather LK (plain torch) on the card against the
    CPU on two consecutive 640 x 480 frames, 80 detections."""
    from plviwo_tpu_torch.ops import image, klt
    from plviwo_tpu_torch.sim.simulator import SimConfig, Simulator

    sim = Simulator(SimConfig(duration=3.0, seed=2, n_landmarks=350))
    ts = sim.cam_times()[:2]
    out = {}
    for dev in ("cpu", cuda_device):
        pyrs = [image.build_pyramid(image.hist_equalize(torch.as_tensor(
            sim.render_frame(t, with_lines=False), device=dev)[None]), 3) for t in ts]
        none = torch.zeros((1, 1), dtype=torch.bool, device=dev)
        uv, ok = klt.detect_grid(pyrs[0][0], torch.zeros((1, 1, 2), device=dev), none, 12, 10, 80,
                                 min_px_dist=10.0)
        if dev == "cpu":
            start = (uv, ok)
        uv, ok = start[0].to(dev), start[1].to(dev)
        out[str(dev)] = [x[0].cpu().numpy() for x in klt.pyramidal_lk(*pyrs, uv, ok, 3, 7, 10)]
    (cu, cok), (gu, gok) = out["cpu"], out[str(cuda_device)]
    np.testing.assert_array_equal(gok, cok)
    assert cok.sum() > 40
    np.testing.assert_allclose(gu[cok], cu[cok], rtol=0, atol=1e-3)


@pytest.mark.cuda
def test_tag_detector_on_the_card_matches_the_cpu(cuda_device):
    """The ArUco detector (FP32 NCC bank, peaks, decode, corner refinement)
    on painted 640 x 480 frames, the card against the CPU."""
    import chip_smoke
    from plviwo_tpu_torch.ops import aruco

    card, cpu = aruco.TagDetector(device=cuda_device), aruco.TagDetector(device="cpu")
    for img, tags in chip_smoke.tag_frames():
        got = {k: v.cpu().numpy() for k, v in card.detect(img).items()}
        want = {k: v.numpy() for k, v in cpu.detect(img).items()}
        ok = want["valid"]
        np.testing.assert_array_equal(got["valid"], ok)
        np.testing.assert_array_equal(got["tag_id"][ok], want["tag_id"][ok])
        assert sorted(int(t) for t in got["tag_id"][ok]) == sorted(t[0] for t in tags)
        np.testing.assert_allclose(got["corners"][ok], want["corners"][ok], rtol=0, atol=1e-3)


@pytest.mark.cuda
def test_sharded_full_step_two_ranks_on_one_card(cuda_device):
    """Two ranks share the card over Gloo: the sharded full step within 1e-9
    of one process (`dryrun.dryrun_step` raises otherwise), each rank's shard
    on the card with its 2 gate/Gram launches (points, lines)."""
    from plviwo_tpu_torch.parallel import dryrun
    from plviwo_tpu_torch.parallel.replay import run_ranks

    res = run_ranks(dryrun.dryrun_step, 2, device="cuda", timeout=300.0)
    assert res[0]["dp"] < 1e-9 and res[0]["dcov"] < 1e-9
    for r in res:
        assert r["backend"] == "gloo" and r["device"] == str(cuda_device)
        assert r["launches"] == {"lk_pyramid": 0, "msckf_gram_gate": 2}
        assert r["agg"]["accepted"] > 0 and r["agg"]["lines_accepted"] > 0
