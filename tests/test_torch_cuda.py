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
equal the plain version's, its warp sums take another order).
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


# case: (B, n_pts, levels, half, variant).  The main path's size and a small
# one; one and two levels; a 7 x 7 window; B * N not a multiple of the
# features per block; features within a few pixels of the border (the patch
# origins clip); the last sequence's images flat (det = 0: no step, not
# ok); a third of the features invalid.
LK_CASES = {
    "main-path": (64, 128, 3, 7, None), "small": (2, 48, 3, 7, None),
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
    """Three images-in frames at B = 2: the kernel path launches each kernel
    once per frame and matches the path with both plain versions."""
    from plviwo_tpu_torch import examples
    from plviwo_tpu_torch.core import frame, step
    from plviwo_tpu_torch.core.layout import StateLayout
    from plviwo_tpu_torch.core.state import FilterState
    from plviwo_tpu_torch.ops import klt, lk_kernel
    from plviwo_tpu_torch.sim.simulator import SimConfig, Simulator

    sim = Simulator(SimConfig(duration=3.0, n_landmarks=350, n_lines=40, seed=3))
    layout = StateLayout(n_clones=6, n_cams=1, use_wheel=True)
    imu = sim.imu_stream()
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    frames, t_prev = [], 1.0
    for i in range(3):
        t = 1.0 + 0.1 * (i + 1)
        win = (examples.imu_window(*imu, t_prev, t) + (np.array([t]),)
               + examples.wheel_window(sim, t_prev, t))
        frames.append((examples.noisy_batch(sim.render_frame(t), 2, gen),)
                      + tuple(torch.as_tensor(np.stack([a, a]), device=cuda_device) for a in win))
        t_prev = t
    gravity = torch.tensor([0.0, 0.0, 9.81], dtype=torch.float64, device=cuda_device)

    def run():
        st = FilterState.from_numpy([examples.seed_state(sim, layout, 1.0)] * 2, layout,
                                    cuda_device)
        ts = frame.make_track_state(480, 640, n_pts=32, max_obs=3, batch=2, device=cuda_device)
        out = []
        for img, it, iw, ia, tn, wt, w1, w2 in frames:
            st, ts, m = frame.fused_frame(
                st, ts, img, it, iw, ia, tn[:, 0], wt, w1, w2,
                torch.ones(2, dtype=torch.bool, device=cuda_device), gravity,
                (1.7e-4, 2.0e-3, 1.9e-5, 3.0e-3), 1.5, 8.0, 2.0, (0.05, 0.05, 0.02),
                use_lines=False)
            out.append(m)
        return st, out

    before = (lk_kernel.lk_pyramid.launches, gram_gate.launches)
    s1, m1 = run()
    torch.cuda.synchronize()
    assert (lk_kernel.lk_pyramid.launches, gram_gate.launches) == (before[0] + 3, before[1] + 3)
    monkeypatch.setattr(frame.lk_kernel, "pyramidal_lk", klt.pyramidal_lk_conv)
    monkeypatch.setattr(step, "gram_gate", gram_gate_plain)
    s0, m0 = run()
    for a, b in zip(m1, m0):
        for k in ("tracked", "harvested", "accepted", "wheel_accepted"):
            assert torch.equal(a[k], b[k]), k
    assert int(sum(m["tracked"].sum() for m in m1)) > 0
    assert float((s1.p - s0.p).abs().max()) < 1e-5
    assert float((s1.cov - s0.cov).abs().max()) < 1e-4 * float(s0.cov.abs().max())
