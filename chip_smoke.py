"""Drive the PyTorch port on one CUDA card and check it.

Run from the repository root:  python3 chip_smoke.py

Phases (any failure raises, so the exit code is non-zero):
  1. device: requires torch.cuda; prints the card's name and power limit;
  2. build: compiles every CUDA source of the port (the MSCKF gate/Gram
     kernel and the pyramidal LK kernel) with nvcc for sm_90a;
  3. gate/Gram kernel vs its plain PyTorch version at the filter bench's
     shapes (B = 128, M = 40, D = 162; points k = 3, F = 40 and lines
     k = 4, F = 16) and at the images-in frame's (k = 3, B = 64, F = 128,
     M = 16, D = 124), with times and bounds;
  4. LK kernel vs its plain version at the images-in frame's shapes
     (B = 64, N = 128, 640 x 480, 3 levels, W = 15, 6 iterations) on two
     consecutive simulator frames with per-sequence pixel noise, with times
     and bound;
  5. filter-only path: `fused_step_full` at the bench width (B = 128, 22
     clones, 40 point tracks x 20 obs, 16 line tracks, 32 IMU and 32 wheel
     samples) — one step with real point, line and wheel rows and exactly
     two gate/Gram launches, the same step with the plain gate, then
     chained steps timed as frames/s;
  6. images-in path: `core.frame.fused_frame` (mono points + wheel, as
     `VioSystem.feed_image` runs by default) at the bench's images-in width
     (B = 64 sequences, 640 x 480, 128 slots x 8 obs, D = 124) on the
     port's simulator: 6 warm-up and 12 timed frames with one LK and one
     gate/Gram launch each, accepted point and wheel rows, every sequence
     within 0.45 m of ground truth; the same 18 frames through the plain
     LK give the same tracked count and accepted total within 1%;
  7. both kernels vs their plain versions on the arguments the images-in
     path gave them in its last frame (most gate/Gram features have too few
     rows and exit early), with times and bounds.
The last three lines are the kernels' JSON record, the card's name and
power limit, and {"ok": true, "device": {...}}.  The script imports no
JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

# the filter bench's width (bench.py: bench_filter_only)
B, N_CLONES, F_PTS, N_OBS, L_LINES, IMU_N, N_WHEEL = 128, 22, 40, 20, 16, 32, 32
N_CHAINED = 10
M_ROWS = 2 * N_OBS
SIGMA_PIX, CHI2_MULT = 1.0, 1.0
# the images-in width (bench.py: bench_images_in, lines and GPS off)
B_IMG, H_IMG, W_IMG, N_PTS, MAX_OBS, GRID = 64, 480, 640, 128, 8, (16, 12)
N_WARM, N_TIMED = 6, 12
# H100 SXM peaks (NVIDIA datasheet): HBM bytes/s, FP32 FLOP/s
PEAK_BYTES, PEAK_F32 = 3.35e12, 67e12


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def random_systems(rng, Bn, F, M, D, k, frac_valid=0.7):
    """Random per-feature systems, as tests/test_msckf_kernel.py makes them,
    for Bn sequences (numpy, float32)."""
    Hx = rng.normal(size=(Bn, F, M, D)).astype(np.float32)
    Hf = rng.normal(size=(Bn, F, M, k)).astype(np.float32)
    r = rng.normal(size=(Bn, F, M)).astype(np.float32)
    rowmask = rng.uniform(size=(Bn, F, M)) < frac_valid
    rowmask[:, 0] = False
    rowmask[:, 1] = np.arange(M) < (k + 1)
    A = rng.normal(size=(Bn, D, 2 * D)).astype(np.float32)
    cov = (A @ A.transpose(0, 2, 1) / (2 * D) * 0.05).astype(np.float32)
    return Hx, Hf, r, rowmask, cov


def cuda_ms(fn, n_iter=20):
    """Mean milliseconds per call of fn on the card (CUDA events, warmed)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(n_iter):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / n_iter


def bound_ms(n_bytes, n_ops):
    """Least time on the card: bytes over the memory rate or FP32 operations
    over the peak rate, whichever is longer.  Returns (ms, bound_by)."""
    tb, to = n_bytes / PEAK_BYTES, n_ops / PEAK_F32
    return 1e3 * max(tb, to), "bytes" if tb >= to else "operations"


def gram_bound(rowmask, ok, D, k):
    """Bound of one gate/Gram call from what its inputs need: the valid rows
    of Hx, Hf, r, w (and every mask byte), the covariances, the outputs;
    per feature with n >= k + 2 valid rows the Householder sweeps, Hv cov,
    the symmetric half of S, the Cholesky and solve, and for accepted
    features the symmetric half of the Gram [Hv | rv]^T [Hv | rv]."""
    Bn, F, M = rowmask.shape
    n = rowmask.sum(-1).double()
    rows = float(n.sum())
    n_bytes = (rows * (D + k + 2) * 4 + Bn * F * M + Bn * D * D * 4 + (M + 1) * 4
               + Bn * D * D * 4 + Bn * D * 4 + Bn * F * 5)
    live = n >= k + 2
    p = (n - k).clamp(min=0)
    ops = (2 * n * (k + D + 1) + k * 4 * n * (k + D + 1) + p * D * D * 2
           + p * (p + 1) * D + p**3 / 3 + p * p)
    ops = float((ops * live).sum() + (p * (D + 1) * (D + 2) * ok).sum())
    return bound_ms(n_bytes, ops)


def gram_args(k, Bn, F, M, D, dev):
    """The gate/Gram kernel's arguments on random systems at one shape."""
    import torch

    from plviwo_tpu_torch.core.step import _chi2_table32

    rng = np.random.default_rng(10 + k + M)
    Hx, Hf, r, rowmask, cov = (torch.as_tensor(a, device=dev)
                               for a in random_systems(rng, Bn, F, M, D, k))
    sigma, chi2_mult = 1.3, 5.0
    gate_vec = _chi2_table32(dev)[:M + 1] * chi2_mult
    w = torch.full(r.shape, 1.0 / sigma, dtype=torch.float32, device=dev)
    return (Hx, Hf, r, rowmask, w, cov, gate_vec, 15.0)


def check_gram(out, ref, tag):
    """Hold a gate/Gram result to the plain version's: `ok` equal, G and c
    within the bounds of tests/test_msckf_kernel.py (atol 2e-5 max|G|, rtol
    2e-4).  Returns max |dG|, |dc|."""
    import torch

    (G1, c1, ok1, _), (G0, c0, ok0, _) = out, ref
    if not torch.equal(ok0, ok1):
        raise AssertionError(f"{tag}: ok differs in {int((ok0 != ok1).sum())} features")
    for name, a, b in (("G", G1, G0), ("c", c1, c0)):
        sc = float(b.abs().max()) + 1e-9
        torch.testing.assert_close(a, b, atol=2e-5 * sc, rtol=2e-4, msg=f"{tag} {name}")
    return max(float((G1 - G0).abs().max()), float((c1 - c0).abs().max()))


def phase_gram(tag, args):
    """gate/Gram kernel vs plain version on one call's arguments."""
    import torch

    from plviwo_tpu_torch.ops.msckf_kernel import gram_gate, gram_gate_plain

    out = gram_gate(*args)
    ref = gram_gate_plain(*args)
    torch.cuda.synchronize()
    err = check_gram(out, ref, tag)
    ok1 = out[2]
    n_ok = int(ok1.sum())
    if not 0 < n_ok < ok1.numel():
        raise AssertionError(f"{tag}: gate accepted {n_ok} of {ok1.numel()}")
    ms = cuda_ms(lambda: gram_gate(*args))
    plain_ms = cuda_ms(lambda: gram_gate_plain(*args))
    rowmask, D, k = args[3], args[0].shape[-1], args[1].shape[-1]
    bms, by = gram_bound(rowmask, ok1, D, k)
    live = int((rowmask.sum(-1) > k).sum())
    print(f"gate/Gram {tag}: ok {n_ok}/{ok1.numel()} ({live} with > k rows), max|dG|={err:.3e} "
          f"(max|G| {float(ref[0].abs().max()):.3e}), kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {bms:.4f} ms ({by})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by)


def lk_bound(prev_pyr, next_pyr, uv_prev, levels, half, iters, drift, drift_fine):
    """Bound of one LK launch from what its inputs need: the pixels under
    the union of the footprints in every level of both pyramids, read once
    — in `prev` the (W+3)^2 region at the extended template's taps, in
    `next` the target patch, PS^2 (its origins follow the plain version's
    level loop) — the per-feature inputs and outputs, and the FP32 work per
    feature and level (template taps, gradients, normal matrix, `iters`
    steps of sampling and the 2x2 solve, the final error)."""
    import torch
    import torch.nn.functional as F

    from plviwo_tpu_torch.ops import klt

    Bn, N, _ = uv_prev.shape
    W = 2 * half + 1
    NR = W + 3
    covered = 0.0

    def footprint(img, oy, ox, size):
        H, Wd = img.shape[-2:]
        mark = torch.zeros((Bn, H * Wd), device=img.device)
        mark.scatter_(1, oy * Wd + ox, 1.0)
        mark = F.pad(mark.view(Bn, 1, H, Wd), (size - 1, 0, size - 1, 0))
        return float(F.max_pool2d(mark, size, stride=1).sum())

    def tap_region(u, o, PS, KS):  # start of the template's tap region in the image
        k = torch.floor(u - o.to(u.dtype) - (half + 1)).clamp(-1, KS - 1).to(torch.int64)
        return o + k.clamp(0, PS - NR)

    uv = uv_prev / 2.0 ** (levels - 1)
    for l in range(levels - 1, -1, -1):
        D = drift if l == levels - 1 else drift_fine
        PS, KS = W + 2 * D + 4, 2 * D + 3
        H, Wd = prev_pyr[l].shape[-2:]
        up = uv_prev / 2.0**l
        oyp = klt._origin(up[..., 1], half + D + 2, H - PS)
        oxp = klt._origin(up[..., 0], half + D + 2, Wd - PS)
        covered += footprint(prev_pyr[l], tap_region(up[..., 1], oyp, PS, KS),
                             tap_region(up[..., 0], oxp, PS, KS), NR)
        covered += footprint(next_pyr[l], klt._origin(uv[..., 1], half + D + 1, H - PS),
                             klt._origin(uv[..., 0], half + D + 1, Wd - PS), PS)
        uv = klt._lk_level_conv(prev_pyr[l], next_pyr[l], up, uv, half, iters, D)[0]
        if l > 0:
            uv = uv * 2.0
    n_bytes = 4 * covered + Bn * N * (9 + 17)
    per_level = (W + 2) ** 2 * 9 + W * W * (4 + 6) + iters * (W * W * 14 + 10) + W * W * 11
    return bound_ms(n_bytes, float(Bn * N * levels * per_level))


def lk_args(dev):
    """The LK kernel's arguments at the images-in frame's shapes: two
    consecutive simulator frames with per-sequence pixel noise, the corners
    detected in the first, 3 levels, half 7, 6 iterations, the defaults'
    max_err and drift budgets."""
    import torch

    from plviwo_tpu_torch.examples import lk_pair
    from plviwo_tpu_torch.sim.simulator import SimConfig, Simulator

    sim = Simulator(SimConfig(duration=3.0, n_landmarks=350, n_lines=40, seed=3,
                              width=W_IMG, height=H_IMG))
    gen = torch.Generator(device=dev).manual_seed(7)
    return (*lk_pair(sim, B_IMG, N_PTS, 1.0, gen), 3, 7, 6, 0.08, 5, 2)


def check_lk(out, ref, tag):
    """Hold an LK result to the plain version's with the bounds of
    tests/test_torch_cuda.py (those of tests/test_lk_kernel.py): `ok` equal
    on >= 99% of the features and true for >= 10% in both; where both accept,
    median |duv| < 1e-3 px and max < 0.05 px and err within rtol 1e-3; det
    within rtol 1e-4, atol 1e-6 everywhere.  Returns (ok agreement, median,
    max |duv|)."""
    import torch

    (uv1, ok1, err1, det1), (uv0, ok0, err0, det0) = out, ref
    agree = float((ok1 == ok0).float().mean())
    both = ok1 & ok0
    d = torch.linalg.vector_norm(uv1 - uv0, dim=-1)[both]
    med = float(d.median()) if d.numel() else float("nan")
    mx = float(d.max()) if d.numel() else float("nan")
    if not (agree >= 0.99 and int(both.sum()) >= 0.1 * ok0.numel() and med < 1e-3
            and mx < 0.05):
        raise AssertionError(f"{tag}: LK kernel vs plain: ok agree {agree:.4f}, both "
                             f"{int(both.sum())}, median |duv| {med:.3e}, max {mx:.3e}")
    torch.testing.assert_close(det1, det0, rtol=1e-4, atol=1e-6, msg=f"{tag} det")
    torch.testing.assert_close(err1[both], err0[both], rtol=1e-3, atol=1e-6, msg=f"{tag} err")
    return agree, med, mx


def phase_lk(tag, args):
    """LK kernel vs plain version on one call's arguments (`lk_pyramid`'s,
    all ten positional), with times and bound."""
    import torch

    from plviwo_tpu_torch.ops import klt, lk_kernel

    out = lk_kernel.lk_pyramid(*args)
    ref = klt.pyramidal_lk_conv_full(*args)
    torch.cuda.synchronize()
    agree, med, mx = check_lk(out, ref, tag)
    ms = cuda_ms(lambda: lk_kernel.lk_pyramid(*args))
    plain_ms = cuda_ms(lambda: klt.pyramidal_lk_conv_full(*args), n_iter=5)
    prev_pyr, next_pyr, uv, valid, levels, half, iters, _, drift, drift_fine = args
    bms, by = lk_bound(prev_pyr, next_pyr, uv, levels, half, iters, drift, drift_fine)
    print(f"LK {tag} B={uv.shape[0]} N={uv.shape[1]}: valid {int(valid.sum())}, ok kernel "
          f"{int(out[1].sum())}, plain {int(ref[1].sum())}, agree {agree:.5f}; median |duv| "
          f"{med:.3e} px, max {mx:.3e} px; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{bms:.4f} ms ({by})")
    return dict(max_abs_err=mx, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by)


def ptxas_report(log, kernel):
    """The `-Xptxas -v` report of the entry function whose name holds
    `kernel`: its stack and spills, then its registers."""
    lines = [line.strip() for line in log.splitlines()]
    entry = next((line.split("'")[1] for line in lines
                  if "Compiling entry function" in line and kernel in line), None)
    props = next((i for i, line in enumerate(lines)
                  if entry and line.endswith(f"Function properties for {entry}")), None)
    if props is None or props + 1 >= len(lines):
        raise AssertionError(f"ptxas: no report for {kernel} in the build log")
    regs = next((line for line in lines[props + 2:] if "registers" in line), "")
    return f"{lines[props + 1]}; {regs.split(':', 1)[-1].strip()}"


def lk_spills(log):
    """`ptxas_report` of the LK kernel; raises unless it reports no spill
    stores and no spill loads."""
    report = ptxas_report(log, "lk_pyramid_kernel")
    if "0 bytes spill stores, 0 bytes spill loads" not in report:
        raise AssertionError(f"ptxas: the LK kernel spills: {report}")
    return report


def step_args(dev):
    from plviwo_tpu_torch.examples import batch_args, example_inputs_full

    args = example_inputs_full(n_clones=N_CLONES, F=F_PTS, O=N_OBS, imu_n=IMU_N,
                               L=L_LINES, n_wheel=N_WHEEL, device=dev)
    return batch_args(args, B, dev)


def run_step(state, per_frame, gravity, sigmas):
    import torch

    from plviwo_tpu_torch.core.step import fused_step_full
    from plviwo_tpu_torch.examples import SIGMA_LINE, WHEEL_NOISE

    return fused_step_full(state, *per_frame, gravity, sigmas, SIGMA_PIX, CHI2_MULT,
                           SIGMA_LINE, WHEEL_NOISE, model=0, window_size=1.0,
                           cam_dtype=torch.float32)


def plain_gate_step(state, per_frame, gravity, sigmas):
    """The same step with the step module's gate bound to the plain version
    (the wrapper itself never takes the plain path for CUDA tensors)."""
    from plviwo_tpu_torch.core import step
    from plviwo_tpu_torch.ops.msckf_kernel import gram_gate, gram_gate_plain

    step.gram_gate = gram_gate_plain
    try:
        return run_step(state, per_frame, gravity, sigmas)
    finally:
        step.gram_gate = gram_gate


def phase_filter_only(dev):
    import torch

    from plviwo_tpu_torch.ops.msckf_kernel import gram_gate

    b = step_args(dev)
    state0, per_frame, (gravity, sigmas) = b[0], b[1:17], b[17:19]
    D = state0.layout.dim
    torch.cuda.synchronize()

    gram_gate.launches = 0
    t0 = time.perf_counter()
    s1, m1 = run_step(state0, per_frame, gravity, sigmas)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    if gram_gate.launches != 2:
        raise AssertionError(f"first step launched the kernel {gram_gate.launches} times")
    counts = {k: int(m1[k].sum()) for k in ("accepted", "lines_accepted", "wheel_accepted")}
    if min(counts.values()) <= 0:
        raise AssertionError(f"first step accepted nothing in some sensor: {counts}")
    if tuple(s1.cov.shape) != (B, D, D) or tuple(s1.p.shape) != (B, 3):
        raise AssertionError(f"bad shapes p {tuple(s1.p.shape)} cov {tuple(s1.cov.shape)}")

    out = s1
    finite = torch.ones((), dtype=torch.bool, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(N_CHAINED):
        out, _ = run_step(out, per_frame, gravity, sigmas)
        finite = finite & torch.isfinite(out.p).all() & torch.isfinite(out.cov).all()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = gram_gate.launches
    if launches != 2 * (N_CHAINED + 1):
        raise AssertionError(f"{launches} kernel launches in {N_CHAINED + 1} steps")
    if not bool(finite):
        raise AssertionError("p or cov went non-finite in the chained steps")

    s0, m0 = plain_gate_step(state0, per_frame, gravity, sigmas)
    torch.cuda.synchronize()
    counts0 = {k: int(m0[k].sum()) for k in counts}
    if counts0 != counts:
        raise AssertionError(f"kernel-path counts {counts} != plain-path {counts0}")
    dp = float((s1.p - s0.p).abs().max())
    dcov = float((s1.cov - s0.cov).abs().max())
    sc = float(s0.cov.abs().max())
    # slice tolerance of tests/test_msckf_kernel.py::test_fused_step_pallas_matches_xla
    if not (dp < 1e-5 and dcov < 1e-4 * sc):
        raise AssertionError(f"kernel vs plain step: |dp|={dp:.3e} |dcov|={dcov:.3e} (max|cov| {sc:.3e})")
    fps = B * N_CHAINED / wall
    print(f"filter-only path: B={B} D={D} counts {counts} (plain path equal), "
          f"|dp|={dp:.3e} |dcov|={dcov:.3e} max|cov|={sc:.3e}; first step {first_s:.3f} s; "
          f"{N_CHAINED} chained steps {wall:.4f} s = {fps:.1f} frames/s")
    return launches, fps


def images_in_inputs(dev):
    """The bench's images-in sequence on the port's simulator: 18 frames of
    B_IMG sequences (per-sequence pixel noise), IMU and wheel windows."""
    import torch

    from plviwo_tpu_torch.examples import frame_inputs
    from plviwo_tpu_torch.sim.simulator import SimConfig, Simulator

    sim = Simulator(SimConfig(duration=6.0, n_landmarks=350, n_lines=40, seed=3,
                              width=W_IMG, height=H_IMG))
    gen = torch.Generator(device=dev).manual_seed(7)
    return sim, frame_inputs(sim, B_IMG, N_WARM + N_TIMED, gen)


def run_images_in(sim, frames, dev, capture=None):
    """The 18 frames through `fused_frame` from the ground-truth seed.
    Returns (final state, per-frame metrics, tracked after the warm-up,
    frames/s of the timed frames).  A dict `capture` receives the arguments
    of the last frame's gate/Gram call under "gram_gate" and those of its LK
    call, all ten positional, under "lk"."""
    import inspect

    import torch

    from plviwo_tpu_torch import examples
    from plviwo_tpu_torch.core import frame, step
    from plviwo_tpu_torch.ops import lk_kernel

    if capture is not None:
        gram, lk = step.gram_gate, lk_kernel.pyramidal_lk
        lk_sig = inspect.signature(lk)

        def recording_gram(*args):
            capture["gram_gate"] = args
            return gram(*args)

        def recording_lk(*args, **kwargs):
            bound = lk_sig.bind(*args, **kwargs)
            bound.apply_defaults()
            capture["lk"] = tuple(bound.arguments.values())
            return lk(*args, **kwargs)

        step.gram_gate, lk_kernel.pyramidal_lk = recording_gram, recording_lk
        try:
            return run_images_in(sim, frames, dev)
        finally:
            step.gram_gate, lk_kernel.pyramidal_lk = gram, lk
    from plviwo_tpu_torch.core.layout import StateLayout
    from plviwo_tpu_torch.core.state import FilterState

    c = sim.cfg
    layout = StateLayout(n_clones=14, n_cams=1, use_wheel=True)
    state = FilterState.from_numpy([examples.seed_state(sim, layout, 1.0)] * B_IMG, layout, dev)
    ts = frame.make_track_state(H_IMG, W_IMG, n_pts=N_PTS, max_obs=MAX_OBS, seed=0,
                                batch=B_IMG, device=dev)
    gravity = torch.tensor([0.0, 0.0, 9.81], dtype=torch.float64, device=dev)
    sigmas = (c.sigma_w, c.sigma_a, c.sigma_wb, c.sigma_ab)
    wheel_valid = torch.ones(B_IMG, dtype=torch.bool, device=dev)
    metrics, tracked_warm, t_start = [], None, None
    for i, f in enumerate(frames):
        if i == N_WARM:
            torch.cuda.synchronize()
            tracked_warm = int(metrics[-1]["tracked"].sum())
            t_start = time.perf_counter()
        state, ts, m = frame.fused_frame(
            state, ts, f["img"], *f["imu"], f["t_new"], *f["wheel"], wheel_valid, gravity,
            sigmas, 1.5, 8.0, 2.0, (0.05, 0.05, 0.02), model=0, window_size=1.0,
            cam_dtype=torch.float32, min_track=4, grid_x=GRID[0], grid_y=GRID[1],
            use_lines=False)
        metrics.append(m)
    torch.cuda.synchronize()
    fps = B_IMG * N_TIMED / (time.perf_counter() - t_start)
    return state, metrics, tracked_warm, fps


def phase_images_in(dev):
    import torch

    from plviwo_tpu_torch.ops import klt, lk_kernel
    from plviwo_tpu_torch.ops.msckf_kernel import gram_gate

    sim, frames = images_in_inputs(dev)
    n = len(frames)
    captured = {}
    lk_kernel.lk_pyramid.launches = 0
    gram_gate.launches = 0
    state, metrics, tracked_warm, fps = run_images_in(sim, frames, dev, captured)
    launches = {"lk_pyramid": lk_kernel.lk_pyramid.launches,
                "msckf_gram_gate": gram_gate.launches}
    if launches != {"lk_pyramid": n, "msckf_gram_gate": n}:
        raise AssertionError(f"{launches} kernel launches in {n} frames, want one each per frame")

    def totals(ms):
        timed = ms[N_WARM:]
        return {"accepted": int(sum(int(m["accepted"].sum()) for m in timed)),
                "wheel_accepted": int(sum(int(m["wheel_accepted"].sum()) for m in timed)),
                "tracked_final": int(ms[-1]["tracked"].sum())}

    tot = totals(metrics)
    if not (tracked_warm > 0 and tot["accepted"] > 0 and tot["wheel_accepted"] > 0):
        raise AssertionError(f"images-in path: tracked after warm-up {tracked_warm}, {tot}")
    if not (bool(torch.isfinite(state.p).all()) and bool(torch.isfinite(state.cov).all())):
        raise AssertionError("images-in path: p or cov is not finite")
    p_gt = torch.as_tensor(sim.gt_pose(frames[-1]["t"])[1], device=dev)
    err = torch.linalg.vector_norm(state.p - p_gt, dim=-1)
    if float(err.max()) >= 0.45:  # the bound of tests/test_fused_frame.py:159
        raise AssertionError(f"images-in path: final |p - p_gt| up to {float(err.max()):.3f} m")

    # the same frames with the plain LK (the frame module's LK bound to it)
    lk = lk_kernel.pyramidal_lk
    lk_kernel.pyramidal_lk = klt.pyramidal_lk_conv
    try:
        _, metrics0, _, fps0 = run_images_in(sim, frames, dev)
    finally:
        lk_kernel.pyramidal_lk = lk
    tot0 = totals(metrics0)
    if (tot0["tracked_final"] != tot["tracked_final"]
            or abs(tot0["accepted"] - tot["accepted"]) > 0.01 * tot["accepted"]):
        raise AssertionError(f"images-in path: kernel LK {tot} vs plain LK {tot0}")
    print(f"images-in path: B={B_IMG} {W_IMG}x{H_IMG} n_pts={N_PTS} D={state.layout.dim}: "
          f"tracked after warm-up {tracked_warm}, timed {tot} (plain LK {tot0}); final "
          f"|p - p_gt| max {float(err.max()):.4f} m, mean {float(err.mean()):.4f} m; "
          f"launches {launches}; {fps:.1f} frames/s (plain LK {fps0:.1f})")
    return launches, fps, captured


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available; this script needs a CUDA card",
              file=sys.stderr)
        return 2
    repo = Path(__file__).resolve().parent
    if not (repo / "plviwo_tpu_torch" / "csrc" / "lk_pyramid.cu").exists():
        print(f"chip_smoke: no plviwo_tpu_torch package beside {__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(repo))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    from plviwo_tpu_torch.ops.cuda_lib import build_library

    lib, build_s, log = build_library()
    print(f"build: {lib.name} in {build_s:.2f} s")
    for line in log.splitlines():
        if line.startswith("==") or "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())
    print(f"  ptxas, LK kernel: {lk_spills(log)}")

    gram_filter = [phase_gram(f"k={k} B={B} F={F} M={M_ROWS} D=162",
                              gram_args(k, B, F, M_ROWS, 162, dev))
                   for k, F in ((3, F_PTS), (4, L_LINES))]
    gram_img = phase_gram(f"k=3 B={B_IMG} F={N_PTS} M={2 * MAX_OBS} D=124",
                          gram_args(3, B_IMG, N_PTS, 2 * MAX_OBS, 124, dev))
    lk = phase_lk("synthetic", lk_args(dev))

    filter_launches, filter_fps = phase_filter_only(dev)
    img_launches, img_fps, frame_args = phase_images_in(dev)
    # the kernels on the inputs the images-in path gave them in its last frame
    gram_frame = phase_gram("captured images-in frame " + "x".join(
        str(n) for n in frame_args["gram_gate"][0].shape), frame_args["gram_gate"])
    lk_frame = phase_lk("captured images-in frame", frame_args["lk"])
    print(f"frames/s: filter-only {filter_fps:.1f} at B={B}, images-in {img_fps:.1f} at "
          f"B={B_IMG} on {card}")

    # the filter-only shapes: one frame's two calls (k = 3 and k = 4) summed
    gram_filter_sum = {k: sum(g[k] for g in gram_filter)
                       for k in ("ms", "plain_ms", "bound_ms")}
    print(json.dumps({"kernels": [
        {"name": "msckf_gram_gate", "route": "cuda",
         "source": "plviwo_tpu_torch/csrc/msckf_gram_gate.cu",
         "replaces": "plviwo_tpu/ops/msckf_kernel.py:205",
         "launches": img_launches["msckf_gram_gate"],
         "max_abs_err": max(g["max_abs_err"] for g in gram_filter + [gram_img, gram_frame]),
         "ms": gram_img["ms"], "plain_ms": gram_img["plain_ms"],
         "bound_ms": gram_img["bound_ms"], "bound_by": gram_img["bound_by"],
         "library_ms": None,
         "launches_by_path": {"images_in": img_launches["msckf_gram_gate"],
                              "filter_only": filter_launches},
         "filter_only_shapes": gram_filter_sum,
         "captured_frame": {k: gram_frame[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}},
        {"name": "lk_pyramid", "route": "cuda",
         "source": "plviwo_tpu_torch/csrc/lk_pyramid.cu",
         "replaces": "plviwo_tpu/ops/lk_kernel.py:141",
         "launches": img_launches["lk_pyramid"],
         "max_abs_err": max(lk["max_abs_err"], lk_frame["max_abs_err"]),
         "ms": lk["ms"], "plain_ms": lk["plain_ms"], "bound_ms": lk["bound_ms"],
         "bound_by": lk["bound_by"], "library_ms": None,
         "captured_frame": {k: lk_frame[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}}
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
