"""Drive the PyTorch port on one CUDA card and check it.

Run from the repository root:  python3 chip_smoke.py

Phases (any failure raises, so the exit code is non-zero):
  1. device: requires torch.cuda; prints the card's name and power limit;
  2. build: compiles every CUDA source of the port (the MSCKF gate/Gram
     kernel and the pyramidal LK kernel) with nvcc for sm_90a;
  3. gate/Gram kernel vs its plain PyTorch version at the filter bench's
     shapes (B = 128, M = 40, D = 162; points k = 3, F = 40 and lines
     k = 4, F = 16) and at the images-in frame's (B = 64, M = 16, D = 132;
     points k = 3, F = 128 and lines k = 4, F = 24), with times and bounds;
  4. LK kernel vs its plain version at the images-in frame's shapes
     (B = 64, N = 128, 640 x 480, 3 levels, W = 15, 6 iterations) on two
     consecutive simulator frames with per-sequence pixel noise, with times
     and bound;
  5. filter-only path: `fused_step_full` at the bench width (B = 128, 22
     clones, 40 point tracks x 20 obs, 16 line tracks, 32 IMU and 32 wheel
     samples) — one step with real point, line and wheel rows and exactly
     two gate/Gram launches, the same step with the plain gate, then
     chained steps timed as frames/s;
  6. images-in path: `core.frame.fused_frame` as bench.py's images-in unit
     (mono points, run-length lines, W3D_ANG wheel and GPS rows; B = 64
     sequences, 640 x 480, 128 point slots x 8 obs, 24 line slots, up to 4
     GPS fixes a frame, D = 132) on the port's simulator: 6 warm-up and 12
     timed frames with one LK and two gate/Gram launches (points, lines)
     each; accepted point, line, wheel and GPS rows and tracked lines in
     the timed frames, every sequence within 0.45 m of ground truth; the
     same 18 frames through the plain LK give the same tracked count, and
     accepted point and line totals within 1%;
  7. both kernels vs their plain versions on the arguments the images-in
     path gave them in its last frame (both gate/Gram calls, points and
     lines; most features have too few rows and exit early), with times
     and bounds;
  8. closed loop: 60 frames of points, lines and wheel at B = 4 (the
     configuration and gates of tests/test_fused_frame.py:113-162 with
     float32 camera tensors): every sequence's RMSE < 0.32 m, final error
     < 0.45 m, accepted > 50 and wheel > 30;
  9. live driver: tests/test_gps_fused.py's 130-frame scenario (points,
     lines, wheel, GPS in a yawed and offset ENU frame) through the port's
     `VioSystem` at B = 1 (96 point and 16 line slots x 12 obs, D = 120),
     held to that test's gates and to one LK and two gate/Gram launches per
     frame: frames/s, the frame latency's p50 and p90, the host time
     outside the frame and the GPS init's wall time;
  10. both kernels vs their plain versions on the live driver's own
     arguments (B = 1, M = 24, D = 120), with times and bounds;
  11. stereo images-in: phase 6 with a right image per sequence and two
     cameras (D = 147, point rows M = 32): two LK launches (temporal, L->R)
     and two gate/Gram launches per frame, >= 50% of the tracked slots
     associated in the right image, phase 6's gates and plain-LK check;
  12. dynamic images-in: phase 6 (D = 132) with sequence b cloning on
     frames where (frame + b) is even and clone-to-clone wheel windows: one
     LK and two gate/Gram launches per frame (points on interpolated
     poses), the kernel path equal to the plain path, every sequence's
     RMSE < 0.5 m;
  13. live driver, dynamic cloning: tests/test_dynamic_fused.py's 90
     frames through `VioSystem` at B = 1, held to that test's gates (NEES
     included), one LK and two gate/Gram launches per frame;
  14. live driver, stereo: tests/test_stereo_fused.py's 60 frames, stereo
     and mono, held to that test's gates; two LK and one gate/Gram launch
     per stereo frame;
  15. both kernels vs their plain versions on the new paths' own
     arguments: the stereo frame's point call (M = 32, D = 147) and L->R LK
     call, the dynamic frame's and the dynamic driver's interpolated rows,
     the stereo driver's point call (M = 48, D = 127);
  16. the per-track path (`VioSystem.feed_camera`, the simulator's data
     association), mono: tests/test_e2e_vio.py's 15 s scenario held to its
     five gates; frames/s, frame latency p50/p90, median stage ms, syncs
     per frame (sync debug mode), and no kernel launch (JAX's per-track
     path reaches no pallas_call);
  17. the per-track path at the KAIST width (configs/kaist: clone rate
     20 Hz, window 1 s, order 3, dynamic cloning, 150 points, 40 MSCKF
     features, W3D_ANG wheel; D = 172): ATE < 1.0 m and within 1.5x of JAX's
     driver on the CPU, lost_marg_obs as JAX's; readings as phase 16;
  18. per-track stereo against mono through run_sim (8 s, seed 2): stereo
     ATE below mono's;
  19. the interpolation order at a 4 Hz clone cap (tests/test_poly_interp_e2e.py,
     orders 1 and 3): both RMSE < 1.0 m, order 3 within 1.15x of order 1,
     updates > 10, lost_marg_obs 0; readings as phase 16.
  20. per-track points + lines, mono: tests/test_lines.py::
     test_e2e_points_and_lines's scenario (10 s, seed 7, 20 lines an
     update): line_accept > 10, RMSE < 1.0 m and within 1.5x of JAX's driver
     on the CPU;
     readings as phase 16, the "line" stage included;
  21. the per-track path at the KAIST width with lines (phase 17 with
     config_camera.yaml's 40 lines at sigma_pix_line 2.5; L = 40 lines x 44
     rows, D = 172): ATE < 1.0 m and within 1.5x of JAX's driver on the
     CPU, lost_marg_obs as JAX's, line_accept > 0; readings as phase 16;
  22. SLAM landmarks: tests/test_slam.py's scenario in both representations
     (>= 3 active slots, RMSE < 1.0 m, landmarks within 2 m of the truth),
     then tests/test_joint_update.py's live replay with 6 slots and GPS,
     joint (inverse depth: the GPS init marginalizes the landmarks) and
     sequential, held to that test's parity gate; readings as phase 16.
  23. CPI-interpolated poses (use_imu_res): run_sim --imu-res --duration 8
     --seed 3's scenario: ATE < 0.2 m, cam_accept_rate > 0.5 and within 1.5x
     of JAX's driver on the CPU; then with dynamic cloning under a 4 Hz cap
     (most measurements between clones): RMSE < 1.0 m and within 1.5x of
     JAX's; the widest `build_cpi_table` call against the same call on the
     CPU within 1e-9, its host operators and time; readings as phase 16;
  24. the IMU+wheel auto-initialization: run_sim --wheel --auto-init
     --duration 8 --seed 3's scenario with no ground-truth seed: the init
     time equal to JAX's driver's, ATE (position and yaw aligned) < 0.1 m
     and within 1.5x of JAX's, no device read and no synchronizing call on
     an IMU sample before the initialization;
  25. ZUPT: tests/test_zupt.py's two streams (stationary from a wrong start
     velocity: applied > 0, |v| < 0.05 m/s; moving: applied == 0), syncs
     per IMU sample and those outside a ZUPT update;
  26. the host KLT trackers (`update/tracker.py`, JAX's gather LK in plain
     torch) on rendered frames into the per-track path:
     tests/test_tracker.py::test_image_driven_vio_e2e's scenario (updates >
     30, RMSE < 0.6 m and within 1.5x of JAX's tracker as it ships), run_sim
     --images --host-tracker --stereo's (within 1.5x of JAX's; the right
     observations kept), and phase 17's KAIST width fed by a 150-point
     tracker (ATE < 1.0 m and within 1.5x of JAX's driver with JAX's
     tracker): no kernel launch; readings as phase 16 plus the tracker's ms
     a frame and its host operators in one frame.
  27. the host line tracker (`update/line_tracker.py`, the anchor walk) on
     rendered frames with lines: phase 26's mono scenario with the lines and
     the wheel (run_sim --images --host-tracker --lines --wheel's
     settings), then with the point-line-coupled rows: RMSE within 1.5x of
     JAX's driver with JAX's trackers as they ship, line_accept > 0, no
     kernel launch; the line tracker on the card against its CPU run on the
     same frames and point tracks (line ids and attached ids equal, segments
     within 1e-3 px); readings as phase 16 plus the trackers' ms a frame and
     the line tracker's host operators a frame;
  28. `run_kaist` over a KAIST-layout fixture written here by the port's
     `generate_kaist_fixture` at tests/test_kaist_e2e.py::test_run_kaist_e2e's
     settings (640 x 480, 8 Hz, 12 s) with that test's layered config and
     --wheel --lines: that test's gates (frames >= 90, clones > 50, updates
     > 30, ATE < 1.0 m) and ATE within 1.5x of JAX's run_kaist; no kernel
     launch; the native feature store taken; p50 / p90 a frame of the point
     tracker, the line tracker and the filter, syncs a frame, and whether
     PyYAML and Pillow are installed (the port reads neither).
  29. fiducial tags (`ops/aruco.py`, `update/aruco_tracker.py`, the
     simulator's ground tags): the detector on three painted 640 x 480
     frames, card against CPU and both against the painted corners; the NCC
     bank in FP32 with TF32 switched on globally (within 1e-4 of float64);
     tests/test_aruco.py's ground-tag world consistency (>= 8 hits, median <
     1.5 px, max < 4 px); run_sim --tags --duration 8 --seed 2 (ATE < 1.0 m,
     beside JAX's); the NCC and detector ms a frame, the tracker's ms;
  30. the descriptor tracker (`update/desc_tracker.py`):
     tests/test_descriptor.py::test_desc_tracker_e2e's scenario
     (cam_accept > 10, RMSE < 1.0 m, beside JAX's), its ms and reads a frame;
  31. run_sim --record --viz-dir on the card (per-track and images-in),
     `eval ate`, `rpe` and `nees` over the recorded files, a checkpoint
     halfway through a replay resumed on the card and equal to the unbroken
     run, and the syncs a frame with the recorder and viz off and on.
  32. the distributed layer (`plviwo_tpu_torch/parallel`) on the one card, its
     ranks child processes sharing it over Gloo (`phase_distributed`): the
     dry run at world 2 and 4 (sharded full step and images-in frame within
     1e-9 of one process, launches per rank), the multi-process worker at
     world 2, config 5 (4 sequences of 12 s, BA) at 4 ranks against 1 rank
     with tests/test_batch_replay.py's gates scaled to it and JAX's ATEs,
     both kernels against their plain versions on these paths' own
     arguments, a lone sequence's replay against its pair's (the pairing's
     cost), and the scaling harness at 1, 2 and 4 ranks with its unsharded
     control.
Phases 16-31 launch no kernel (asserted): no TPU kernel lies on JAX's
per-track path, CPI, ZUPT, the initializers, its host trackers (gather LK),
the tag and descriptor trackers or the utilities.  Synthetic gate/Gram checks
also run at the stereo shapes.
The last three lines are the kernels' JSON record, the card's name and
power limit, and {"ok": true, "device": {...}}.  The script imports no
JAX.
"""

from __future__ import annotations

import contextlib
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
# the images-in width (bench.py: bench_images_in, with lines and GPS)
B_IMG, H_IMG, W_IMG, N_PTS, MAX_OBS, GRID = 64, 480, 640, 128, 8, (16, 12)
MAX_LINES, D_IMG = 24, 132
N_WARM, N_TIMED = 6, 12
# the closed loop (tests/test_fused_frame.py:113-162)
B_LOOP, N_LOOP = 4, 60
# the live driver (tests/test_gps_fused.py:109-190): one vehicle, B = 1
LIVE_T0, LIVE_FRAMES, LIVE_YAW, LIVE_ENU_T = 1.0, 130, 0.4, (40.0, -20.0, 1.0)
LIVE_PTS, LIVE_LINES, LIVE_OBS = 96, 20, 12  # run_sim's slots and fused_max_obs
LIVE_KEEP = 10  # frames whose gate/Gram arguments are kept for the kernel checks
# tests/test_dynamic_fused.py's and tests/test_stereo_fused.py's frames
DYN_FRAMES, STEREO_FRAMES = 90, 60
# JAX's driver (Python feature store) on the CPU at phase 17's settings: its ATE (m)
# and lost_marg_obs over the 15 s (PERF.md section 6)
KAIST_JAX_ATE, KAIST_JAX_LOST = 0.028162140214340308, 4
# the same at phase 21's settings (ATE, lost_marg_obs), and at phase 20's its RMSE (m)
# (tests/test_torch_per_track_lines.py::test_chip_smoke_jax_constants recomputes these)
LINES_JAX_RMSE = 0.10217998200056672
KAIST_LINES_JAX_ATE, KAIST_LINES_JAX_LOST = 0.031129871097390037, 3
# JAX's drivers on the CPU at phases 23-26's settings (tests/test_torch_host_tracker.py::
# test_chip_smoke_jax_constants recomputes these): phase 23's ATE (m), without and with
# dynamic cloning at 4 Hz; phase 24's ATE after position-and-yaw alignment (m) and init time
# (s); phase 26's RMSE with JAX's tracker as it ships (m), run_sim --images --host-tracker
# --stereo's ATE (m, its summary's 4 digits) and the right observations its tracker keeps,
# and the KAIST width's ATE with JAX's tracker (m)
CPI_JAX_ATE, CPI_DYN_JAX_ATE = 0.15762159651808336, 0.07863738852446397
AUTO_INIT_JAX_ATE, AUTO_INIT_JAX_T = 0.03385969507346896, 0.02
TRACKER_JAX_RMSE, STEREO_TRACKER_JAX_ATE, STEREO_JAX_RIGHT = 0.4643161454991923, 0.1918, 5733
KAIST_TRACKER_JAX_ATE = 0.11601727665645131
# phase 27's RMSE with JAX's trackers as they ship (m), without and with the
# point-line-coupled rows, and phase 28's ATE from JAX's run_kaist (m), recomputed by
# the same test
LINE_TRACKER_JAX_RMSE, LINE_TRACKER_PLC_JAX_RMSE = 0.07870616962629386, 0.07929164920492474
KAIST_REPLAY_JAX_ATE = 0.10269945706667286
# phase 29's ATE from JAX's run_sim --tags --duration 8 --seed 2 (m, its summary's 4 digits)
# and phase 30's RMSE from tests/test_descriptor.py::test_desc_tracker_e2e's scenario (m),
# JAX as it ships on the CPU, recomputed by the same test
TAGS_JAX_ATE, DESC_JAX_RMSE = 0.2949, 0.25226061231847174
# phase 32's config 5 (BASELINE.json configs[4]) at JAX's defaults: 4 sequences of 12 s
# (seeds 10-13), 11 clones, 32 points, 8 obs, 12 lines, keyframes every 3 frames, 5 BA
# iterations; JAX's run_batch_replay on the CPU: each sequence's ate_before_m (m)
# (tests/test_torch_parallel.py::test_chip_smoke_jax_constants recomputes these)
C5 = dict(n_seq=4, duration=12.0, n_clones=11, F=32, O=8, L=12, kf_stride=3, ba_iters=5,
          seed0=10)
C5_JAX_ATE_BEFORE = (0.24754664597279855, 0.23174230482213568, 0.22302863746678608,
                     0.20565519042092892)
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


def gram_work(rowmask, ok, D, k):
    """(bytes, FP32 operations) of one gate/Gram call from what its inputs
    need: the valid rows
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
    return n_bytes, ops


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


def phase_gram(tag, args, mixed=True):
    """gate/Gram kernel vs plain version on one call's arguments; with mixed,
    the call must accept some features and reject others."""
    import torch

    from plviwo_tpu_torch.ops.msckf_kernel import gram_gate, gram_gate_plain

    out = gram_gate(*args)
    ref = gram_gate_plain(*args)
    torch.cuda.synchronize()
    err = check_gram(out, ref, tag)
    ok1 = out[2]
    n_ok = int(ok1.sum())
    if mixed and not 0 < n_ok < ok1.numel():
        raise AssertionError(f"{tag}: gate accepted {n_ok} of {ok1.numel()}")
    ms = cuda_ms(lambda: gram_gate(*args))
    plain_ms = cuda_ms(lambda: gram_gate_plain(*args))
    rowmask, D, k = args[3], args[0].shape[-1], args[1].shape[-1]
    work = gram_work(rowmask, ok1, D, k)
    bms, by = bound_ms(*work)
    live = int((rowmask.sum(-1) > k).sum())
    print(f"gate/Gram {tag}: ok {n_ok}/{ok1.numel()} ({live} with > k rows), max|dG|={err:.3e} "
          f"(max|G| {float(ref[0].abs().max()):.3e}), kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {bms:.4f} ms ({by})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, work=work)


def gram_bound(rowmask, ok, D, k):
    """Bound of one gate/Gram call (`bound_ms` of `gram_work`)."""
    return bound_ms(*gram_work(rowmask, ok, D, k))


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
    return dict(max_abs_err=mx, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                n=int(uv.shape[1]))


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


def gram_ptxas(log):
    """`-Xptxas -v` of every gate/Gram entry function (pass 1 per
    `lane_cols` instantiation, pass 2): name, stack and spills, registers.
    Reported, not gated: the kernel's registers are tuned per
    instantiation."""
    names = [line.split("'")[1] for line in log.splitlines()
             if "Compiling entry function" in line
             and any(k in line for k in ("gate_project", "gram"))]
    return [f"{name}: {ptxas_report(log, name)}" for name in dict.fromkeys(names)]


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
    B_IMG sequences (per-sequence pixel noise), IMU, wheel and GPS windows."""
    import torch

    from plviwo_tpu_torch.examples import frame_inputs
    from plviwo_tpu_torch.sim.simulator import SimConfig, Simulator

    sim = Simulator(SimConfig(duration=6.0, n_landmarks=350, n_lines=40, seed=3,
                              width=W_IMG, height=H_IMG))
    gen = torch.Generator(device=dev).manual_seed(7)
    return sim, frame_inputs(sim, B_IMG, N_WARM + N_TIMED, gen)


@contextlib.contextmanager
def recording(capture, n_gram=2):
    """Bind the frame's gate/Gram and LK entries to wrappers that record
    their arguments: capture["gram_gate"] holds the last n_gram gate/Gram
    calls (a frame makes two, points then lines), capture["lk"] the last
    LK call's ten positional arguments."""
    import inspect

    from plviwo_tpu_torch.core import step
    from plviwo_tpu_torch.ops import lk_kernel

    gram, lk = step.gram_gate, lk_kernel.pyramidal_lk
    lk_sig = inspect.signature(lk)

    def recording_gram(*args):
        capture["gram_gate"] = (capture.get("gram_gate", []) + [args])[-n_gram:]
        return gram(*args)

    def recording_lk(*args, **kwargs):
        bound = lk_sig.bind(*args, **kwargs)
        bound.apply_defaults()
        capture["lk"] = tuple(bound.arguments.values())
        return lk(*args, **kwargs)

    step.gram_gate, lk_kernel.pyramidal_lk = recording_gram, recording_lk
    try:
        yield capture
    finally:
        step.gram_gate, lk_kernel.pyramidal_lk = gram, lk


def do_clone(b, i):
    """The dynamic images-in phase's clone pattern: sequence b clones on
    frames where (frame + b) is even."""
    return (i + b) % 2 == 0


def run_images_in(sim, frames, dev, capture=None, lines_gps=True, mode=None):
    """The 18 frames through `fused_frame` from the ground-truth seed: the
    bench's whole unit, or with lines_gps=False points and wheel only
    (D = 124); mode "stereo" adds the right images (two cameras, D = 147),
    mode "dynamic" clones per `do_clone` with the frames' clone-to-clone
    wheel windows (`wheel_dyn`).  Returns (final state, per-frame metrics
    (with "err", |p - p_gt| per sequence, in dynamic mode), tracked after
    the warm-up, frames/s of the timed frames, final TrackState).  A dict
    `capture` receives the arguments of the last frame's two gate/Gram
    calls, points then lines, under "gram_gate" and those of its last LK
    call (stereo: the L->R one), all ten positional, under "lk"."""
    import torch

    from plviwo_tpu_torch import examples
    from plviwo_tpu_torch.core import frame

    if capture is not None:
        with recording(capture):
            return run_images_in(sim, frames, dev, mode=mode)
    from plviwo_tpu_torch.core.layout import StateLayout
    from plviwo_tpu_torch.core.state import FilterState

    c = sim.cfg
    layout = StateLayout(n_clones=14, n_cams=2 if mode == "stereo" else 1, use_wheel=True,
                         n_gps=int(lines_gps))
    state = FilterState.from_numpy([examples.seed_state(sim, layout, 1.0)] * B_IMG, layout, dev)
    ts = frame.make_track_state(H_IMG, W_IMG, N_PTS, MAX_LINES, MAX_OBS, 0, batch=B_IMG,
                                device=dev)
    gravity = torch.tensor([0.0, 0.0, 9.81], dtype=torch.float64, device=dev)
    sigmas = (c.sigma_w, c.sigma_a, c.sigma_wb, c.sigma_ab)
    wheel_valid = torch.ones(B_IMG, dtype=torch.bool, device=dev)
    metrics, tracked_warm, t_start = [], None, None
    for i, f in enumerate(frames):
        if i == N_WARM:
            torch.cuda.synchronize()
            tracked_warm = int(metrics[-1]["tracked"].sum())
            t_start = time.perf_counter()
        kw = dict(use_lines=False)
        if lines_gps:
            kw = dict(use_gps=True, gps_t=f["gps"][0], gps_p=f["gps"][1], gps_valid=f["gps"][2],
                      sigma_gps=c.sigma_gps, gps_chi2_mult=8.0)
        wheel = f["wheel"]
        if mode == "stereo":
            kw.update(use_stereo=True, img_r=f["img_r"])
        elif mode == "dynamic":
            kw.update(use_dynamic=True, do_clone=torch.tensor(
                [do_clone(b, i) for b in range(B_IMG)], device=dev))
            wheel = f["wheel_dyn"]
        state, ts, m = frame.fused_frame(
            state, ts, f["img"], *f["imu"], f["t_new"], *wheel, wheel_valid, gravity,
            sigmas, 1.5, 8.0, 2.0, (0.05, 0.05, 0.02), model=0, window_size=1.0,
            cam_dtype=torch.float32, min_track=4, grid_x=GRID[0], grid_y=GRID[1], **kw)
        if mode == "dynamic":
            p_gt = torch.as_tensor(sim.gt_pose(f["t"])[1], device=dev)
            m = dict(m, err=torch.linalg.vector_norm(state.p - p_gt, dim=-1))
        metrics.append(m)
    torch.cuda.synchronize()
    fps = B_IMG * N_TIMED / (time.perf_counter() - t_start)
    return state, metrics, tracked_warm, fps, ts


TIMED = ("accepted", "lines_accepted", "wheel_accepted", "gps_accepted")


def check_near_truth(sim, frames, state, dev, what):
    """p and cov finite and every sequence within 0.45 m of ground truth
    (the bound of tests/test_fused_frame.py:159); returns the errors."""
    import torch

    if not (bool(torch.isfinite(state.p).all()) and bool(torch.isfinite(state.cov).all())):
        raise AssertionError(f"{what}: p or cov is not finite")
    p_gt = torch.as_tensor(sim.gt_pose(frames[-1]["t"])[1], device=dev)
    err = torch.linalg.vector_norm(state.p - p_gt, dim=-1)
    if float(err.max()) >= 0.45:
        raise AssertionError(f"{what}: final |p - p_gt| up to {float(err.max()):.3f} m")
    return err


def phase_images_in_points(sim, frames, dev):
    """The images-in frame with lines and GPS off (`feed_image`'s points +
    wheel, D = 124): one LK and one gate/Gram launch per frame, no line
    front-end, accepted point and wheel rows, every sequence near truth."""
    from plviwo_tpu_torch.ops import lk_kernel
    from plviwo_tpu_torch.ops.msckf_kernel import gram_gate

    n = len(frames)
    lk_kernel.lk_pyramid.launches = 0
    gram_gate.launches = 0
    state, metrics, tracked_warm, fps, _ = run_images_in(sim, frames, dev, lines_gps=False)
    launches = {"lk_pyramid": lk_kernel.lk_pyramid.launches,
                "msckf_gram_gate": gram_gate.launches}
    if launches != {"lk_pyramid": n, "msckf_gram_gate": n}:
        raise AssertionError(f"points-only: {launches} kernel launches in {n} frames, want one "
                             "each per frame")
    tot = {k: int(sum(int(m[k].sum()) for m in metrics[N_WARM:]))
           for k in ("accepted", "wheel_accepted", "line_tracked")}
    if not (tracked_warm > 0 and tot["accepted"] > 0 and tot["wheel_accepted"] > 0
            and tot["line_tracked"] == 0 and state.layout.dim == 124):
        raise AssertionError(f"points-only: tracked after warm-up {tracked_warm}, {tot}, "
                             f"D = {state.layout.dim}")
    err = check_near_truth(sim, frames, state, dev, "points-only")
    print(f"images-in path, points + wheel (lines and GPS off): B={B_IMG} D={state.layout.dim}: "
          f"tracked after warm-up {tracked_warm}, timed {tot}; final |p - p_gt| max "
          f"{float(err.max()):.4f} m; launches {launches}; {fps:.1f} frames/s")
    return launches, fps


def phase_images_in(sim, frames, dev):
    import torch

    from plviwo_tpu_torch.ops import klt, lk_kernel
    from plviwo_tpu_torch.ops.msckf_kernel import gram_gate

    n = len(frames)
    captured = {}
    lk_kernel.lk_pyramid.launches = 0
    gram_gate.launches = 0
    state, metrics, tracked_warm, fps, _ = run_images_in(sim, frames, dev, captured)
    launches = {"lk_pyramid": lk_kernel.lk_pyramid.launches,
                "msckf_gram_gate": gram_gate.launches}
    if launches != {"lk_pyramid": n, "msckf_gram_gate": 2 * n}:
        raise AssertionError(f"{launches} kernel launches in {n} frames, want one LK and two "
                             "gate/Gram per frame")

    def totals(ms):
        timed = ms[N_WARM:]
        out = {k: int(sum(int(m[k].sum()) for m in timed)) for k in TIMED + ("line_tracked",)}
        out["tracked_final"] = int(ms[-1]["tracked"].sum())
        return out

    tot = totals(metrics)
    if not (tracked_warm > 0 and min(tot.values()) > 0):
        raise AssertionError(f"images-in path: tracked after warm-up {tracked_warm}, {tot}")
    if state.layout.dim != D_IMG:
        raise AssertionError(f"images-in path: D = {state.layout.dim}, want {D_IMG}")
    err = check_near_truth(sim, frames, state, dev, "images-in path")

    # the same frames with the plain LK (the frame module's LK bound to it)
    lk = lk_kernel.pyramidal_lk
    lk_kernel.pyramidal_lk = klt.pyramidal_lk_conv
    try:
        _, metrics0, _, fps0, _ = run_images_in(sim, frames, dev)
    finally:
        lk_kernel.pyramidal_lk = lk
    tot0 = totals(metrics0)
    if (tot0["tracked_final"] != tot["tracked_final"]
            or any(abs(tot0[k] - tot[k]) > 0.01 * tot[k] for k in ("accepted", "lines_accepted"))):
        raise AssertionError(f"images-in path: kernel LK {tot} vs plain LK {tot0}")
    print(f"images-in path: B={B_IMG} {W_IMG}x{H_IMG} n_pts={N_PTS} max_lines={MAX_LINES} "
          f"D={state.layout.dim}: tracked after warm-up {tracked_warm}, timed {tot} (plain LK "
          f"{tot0}); final |p - p_gt| max {float(err.max()):.4f} m, mean "
          f"{float(err.mean()):.4f} m; launches {launches}; {fps:.1f} frames/s (plain LK "
          f"{fps0:.1f})")
    return launches, fps, captured


def phase_closed_loop(dev):
    """60 frames of points, lines and wheel at B = 4, each sequence held to
    the gates of tests/test_fused_frame.py:150-159."""
    import torch

    from plviwo_tpu_torch.examples import closed_loop
    from plviwo_tpu_torch.sim.simulator import SimConfig, Simulator

    sim = Simulator(SimConfig(duration=10.0, n_landmarks=350, n_lines=40, seed=3,
                              width=W_IMG, height=H_IMG))
    t0 = time.perf_counter()
    out = closed_loop(sim, B_LOOP, N_LOOP, torch.Generator(device=dev).manual_seed(7))
    wall = time.perf_counter() - t0
    for b in range(B_LOOP):
        print(f"closed loop, sequence {b}: RMSE {out['rmse'][b]:.4f} m, final "
              f"{out['final'][b]:.4f} m, accepted {out['accepted'][b]}, lines "
              f"{out['lines_accepted'][b]}, wheel {out['wheel_accepted'][b]}")
    ok = (np.isfinite(out["errs"]).all() and (out["rmse"] < 0.32).all()
          and (out["final"] < 0.45).all() and (out["accepted"] > 50).all()
          and (out["wheel_accepted"] > 30).all())
    if not ok:
        raise AssertionError("closed loop: a sequence missed the gates RMSE < 0.32 m, final "
                             "< 0.45 m, accepted > 50, wheel > 30")
    print(f"closed loop: B={B_LOOP}, {N_LOOP} frames in {wall:.2f} s")


def phase_live_driver(dev):
    """The live driver at B = 1: tests/test_gps_fused.py's scenario (16 s,
    seed 5, lines, W3D_ANG wheel, GPS in a frame yawed by 0.4 rad and offset
    by (40, -20, 1) m; 130 frames at 10 Hz from a ground-truth seed at 1 s)
    through the port's `VioSystem` on the card, held to that test's gates
    (the 4-DoF init completed, >= 3 fused fixes, RMSE of the last 30 poses
    in ENU < 1.0 m, covariance diagonal finite and > -1e-9) and to exactly
    one LK and two gate/Gram launches per frame.  The sensor stream is drawn
    before the run (`examples.live_events`), so the times hold no rendering.
    Returns (launches, readings, the last LK and LIVE_KEEP frames'
    gate/Gram arguments)."""
    import torch

    from plviwo_tpu_torch import examples
    from plviwo_tpu_torch.config.options import EstimatorOptions
    from plviwo_tpu_torch.core.system import VioSystem
    from plviwo_tpu_torch.ops import lk_kernel
    from plviwo_tpu_torch.ops.msckf_kernel import gram_gate
    from plviwo_tpu_torch.sim.simulator import SimConfig, Simulator

    sim = Simulator(SimConfig(duration=16.0, n_landmarks=350, n_lines=40, width=W_IMG,
                              height=H_IMG, seed=5, sigma_gps=0.3))
    c, s = np.cos(LIVE_YAW), np.sin(LIVE_YAW)
    R = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    t_enu = np.asarray(LIVE_ENU_T)
    t0 = time.perf_counter()
    events = examples.live_events(sim, LIVE_T0, LIVE_FRAMES, (R, t_enu))
    stream_s = time.perf_counter() - t0
    system = VioSystem(examples.live_options(EstimatorOptions(), gps=True), device=dev)
    examples.live_calibrate(system, sim, LIVE_T0)
    timing, init_frame, capture = [], None, {}
    with recording(capture, n_gram=2 * LIVE_KEEP):
        torch.cuda.synchronize()
        lk_kernel.lk_pyramid.launches = 0
        gram_gate.launches = 0
        t0 = time.perf_counter()
        for kind, args in events:
            n = system.stats["updates"]
            examples.feed(system, kind, args)
            if system.stats["updates"] > n:
                timing.append(system.frame_timing)
                if init_frame is None and system.gps.initialized:
                    init_frame = len(timing) - 1
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"lk_pyramid": lk_kernel.lk_pyramid.launches,
                    "msckf_gram_gate": gram_gate.launches}
    n = system.stats["updates"]
    errs = [np.linalg.norm(p - (R @ sim.gt_kin(t)["p_IinG"] + t_enu))
            for t, _, p in system.traj[-30:]]
    rmse = float(np.sqrt(np.mean(np.square(errs))))
    d = system.state.cov[0].diagonal()
    ok = (system.gps.initialized and system.stats["gps_fused"] >= 3 and rmse < 1.0
          and bool(torch.isfinite(d).all()) and bool((d > -1e-9).all()))
    lat = np.array([f["frame"] for f in timing])
    host = np.array([f["host"] for f in timing])
    out = dict(frames=n, fps=n / wall, p50_ms=float(np.percentile(lat, 50)),
               p90_ms=float(np.percentile(lat, 90)), first_ms=float(lat[0]),
               host_ms=float(host.mean()), gps_init_ms=float("nan") if init_frame is None
               else timing[init_frame]["gps"], init_frame=init_frame, rmse=rmse,
               D=system.layout.dim)
    print(f"live driver (B=1, D={out['D']}, 640x480, 96 point / 16 line slots x 12 obs): "
          f"stats {system.stats}, gps {system.gps.stats}; GPS init at frame {init_frame}; "
          f"last-30 RMSE in ENU {rmse:.4f} m; launches {launches}")
    print(f"live driver timing: {n} frames in {wall:.3f} s = {out['fps']:.2f} frames/s at B=1; "
          f"frame latency p50 {out['p50_ms']:.3f} ms, p90 {out['p90_ms']:.3f} ms (first "
          f"{out['first_ms']:.3f} ms); host time outside fused_frame {out['host_ms']:.3f} ms "
          f"a frame; GPS init {out['gps_init_ms']:.3f} ms; sensor stream drawn in {stream_s:.2f} s")
    if n != LIVE_FRAMES or launches != {"lk_pyramid": n, "msckf_gram_gate": 2 * n}:
        raise AssertionError(f"live driver: {n} frames, launches {launches}; want "
                             f"{LIVE_FRAMES} frames, one LK and two gate/Gram per frame")
    if not ok:
        raise AssertionError("live driver: missed the gates of tests/test_gps_fused.py "
                             "(GPS initialized, gps_fused >= 3, last-30 RMSE < 1.0 m, "
                             "covariance diagonal finite and > -1e-9)")
    return launches, out, capture


def phase_live_kernels(capture):
    """Both kernels against their plain versions on the live driver's own
    arguments (B = 1, M = 24): the LK call of the last frame, and the
    gate/Gram calls (points k = 3, lines k = 4) of the newest kept frame in
    which each call accepts some features and rejects others."""
    from plviwo_tpu_torch.ops import cuda_lib
    from plviwo_tpu_torch.ops.msckf_kernel import gram_gate_plain

    lib = cuda_lib.library()
    calls = capture["gram_gate"]
    M, D = calls[0][0].shape[2], calls[0][0].shape[3]
    smem = {k: lib.msckf_gram_gate_smem_bytes(M, D, k) for k in (3, 4)}
    if not all(0 < b <= cuda_lib.SMEM_LIMIT for b in smem.values()):
        raise AssertionError(f"gate/Gram does not take M={M} D={D}: {smem}")
    print(f"gate/Gram pass-1 shared memory at M={M}, D={D}: {smem[3]} B (k=3), {smem[4]} B (k=4)")

    def mixed(args):
        ok = gram_gate_plain(*args)[2]
        return 0 < int(ok.sum()) < ok.numel()

    back = next((j for j in range(len(calls) // 2)
                 if all(mixed(a) for a in calls[len(calls) - 2 * j - 2:len(calls) - 2 * j])), None)
    if back is None:
        raise AssertionError("live driver: no kept frame whose gate/Gram calls both accept "
                             "some features and reject others")
    pair = calls[len(calls) - 2 * back - 2:len(calls) - 2 * back]
    gram = [phase_gram(f"live driver frame (last - {back}), {what} " + "x".join(
        str(n) for n in args[0].shape), args) for what, args in zip(("points", "lines"), pair)]
    lk = phase_lk("live driver last frame", capture["lk"])
    return gram, lk


def images_in_stereo_inputs(dev):
    """The images-in phase's 18 frames with a right image per sequence
    (the same world; the right camera rendered after the left)."""
    import torch

    from plviwo_tpu_torch.examples import frame_inputs
    from plviwo_tpu_torch.sim.simulator import SimConfig, Simulator

    sim = Simulator(SimConfig(duration=6.0, n_landmarks=350, n_lines=40, seed=3,
                              width=W_IMG, height=H_IMG))
    gen = torch.Generator(device=dev).manual_seed(7)
    return sim, frame_inputs(sim, B_IMG, N_WARM + N_TIMED, gen, stereo=True)


def kernel_totals(metrics):
    """The timed frames' accepted totals and the final tracked count."""
    timed = metrics[N_WARM:]
    out = {k: int(sum(int(m[k].sum()) for m in timed)) for k in TIMED + ("line_tracked",)}
    out["tracked_final"] = int(metrics[-1]["tracked"].sum())
    return out


def same_counts(tot, tot0):
    """Tracked count equal and accepted totals within 1% (the images-in
    phase's bound between its kernel and plain paths)."""
    return tot0["tracked_final"] == tot["tracked_final"] and all(
        abs(tot0[k] - tot[k]) <= 0.01 * tot[k] for k in TIMED)


def phase_images_in_stereo(dev):
    """Stereo images-in at the bench's width: the bench's whole unit with a
    right image per sequence and two cameras (D = 147; point rows M = 4 O
    = 32): exactly two LK launches (temporal, L->R) and two gate/Gram
    launches per frame; right observations associated for >= 50% of the
    valid slots (tests/test_stereo_fused.py's bound; also printed: the
    share of the slots tracked into the last frame, which the L->R pass
    runs on), accepted point, line, wheel and GPS rows, every sequence
    within 0.45 m; the same frames through the plain LK give the same
    tracked count and accepted totals within 1%."""
    from plviwo_tpu_torch.ops import klt, lk_kernel
    from plviwo_tpu_torch.ops.msckf_kernel import gram_gate

    sim, frames = images_in_stereo_inputs(dev)
    n = len(frames)
    captured = {}
    lk_kernel.lk_pyramid.launches = 0
    gram_gate.launches = 0
    state, metrics, tracked_warm, fps, ts = run_images_in(sim, frames, dev, captured, mode="stereo")
    launches = {"lk_pyramid": lk_kernel.lk_pyramid.launches,
                "msckf_gram_gate": gram_gate.launches}
    if launches != {"lk_pyramid": 2 * n, "msckf_gram_gate": 2 * n}:
        raise AssertionError(f"stereo images-in: {launches} kernel launches in {n} frames, want "
                             "two LK and two gate/Gram per frame")
    tot = kernel_totals(metrics)
    # tests/test_stereo_fused.py counts the valid slots, fresh detections
    # (no right observation yet) included; the slots tracked into the last
    # frame are the L->R pass's own input mask
    valid, tracked = int(ts.valid.sum()), int(captured["lk"][3].sum())
    assoc = int(ts.rvalid.sum())
    if not (tracked_warm > 0 and min(tot.values()) > 0 and assoc >= 0.5 * valid
            and state.layout.dim == 147):
        raise AssertionError(f"stereo images-in: tracked after warm-up {tracked_warm}, {tot}, "
                             f"right associated {assoc} of {valid} valid slots, D = "
                             f"{state.layout.dim}")
    err = check_near_truth(sim, frames, state, dev, "stereo images-in")
    lk = lk_kernel.pyramidal_lk
    lk_kernel.pyramidal_lk = klt.pyramidal_lk_conv
    try:
        _, metrics0, _, fps0, _ = run_images_in(sim, frames, dev, mode="stereo")
    finally:
        lk_kernel.pyramidal_lk = lk
    tot0 = kernel_totals(metrics0)
    if not same_counts(tot, tot0):
        raise AssertionError(f"stereo images-in: kernel LK {tot} vs plain LK {tot0}")
    print(f"stereo images-in path: B={B_IMG} {W_IMG}x{H_IMG} D={state.layout.dim}: tracked after "
          f"warm-up {tracked_warm}, timed {tot} (plain LK {tot0}); right associated {assoc} of "
          f"{valid} valid slots ({assoc / valid:.3f}; of the {tracked} slots tracked into the "
          f"last frame {assoc / tracked:.3f}); final |p - p_gt| max {float(err.max()):.4f} "
          f"m; launches {launches}; {fps:.1f} frames/s (plain LK {fps0:.1f})")
    return launches, fps, captured


def phase_images_in_dynamic(sim, frames, dev):
    """Dynamic cloning at the images-in width: the bench's whole unit (D =
    132) with sequence b cloning on frames where (frame + b) is even and
    clone-to-clone wheel windows: one LK and two gate/Gram launches per
    frame (the point call on interpolated-pose rows); the kernel path
    equals the plain path (both plain versions: tracked count equal,
    accepted totals within 1%) and every sequence's position RMSE over the
    18 frames is under tests/test_dynamic_fused.py's 0.5 m."""
    import torch

    from plviwo_tpu_torch.core import step
    from plviwo_tpu_torch.examples import wheel_window
    from plviwo_tpu_torch.ops import klt, lk_kernel
    from plviwo_tpu_torch.ops.msckf_kernel import gram_gate, gram_gate_plain

    n = len(frames)
    t_clone = [1.0, 1.0]  # last clone of the even and odd sequences
    for i, f in enumerate(frames):
        win = [wheel_window(sim, t_clone[j], f["t"]) for j in (0, 1)]
        f["wheel_dyn"] = [torch.as_tensor(np.stack([win[b % 2][k] for b in range(B_IMG)]),
                                          device=dev) for k in range(3)]
        for j in (0, 1):
            if do_clone(j, i):
                t_clone[j] = f["t"]
    captured = {}
    lk_kernel.lk_pyramid.launches = 0
    gram_gate.launches = 0
    state, metrics, tracked_warm, fps, _ = run_images_in(sim, frames, dev, captured,
                                                         mode="dynamic")
    launches = {"lk_pyramid": lk_kernel.lk_pyramid.launches,
                "msckf_gram_gate": gram_gate.launches}
    if launches != {"lk_pyramid": n, "msckf_gram_gate": 2 * n}:
        raise AssertionError(f"dynamic images-in: {launches} kernel launches in {n} frames, want "
                             "one LK and two gate/Gram per frame")
    tot = kernel_totals(metrics)
    rmse = torch.sqrt(torch.mean(torch.stack([m["err"] for m in metrics]) ** 2, dim=0))
    clones = int(state.clone_valid.sum())
    if not (tracked_warm > 0 and tot["accepted"] > 0 and tot["wheel_accepted"] > 0
            and float(rmse.max()) < 0.5 and bool(torch.isfinite(state.cov).all())):
        raise AssertionError(f"dynamic images-in: tracked after warm-up {tracked_warm}, {tot}, "
                             f"RMSE up to {float(rmse.max()):.3f} m")
    lk, gram = lk_kernel.pyramidal_lk, step.gram_gate
    lk_kernel.pyramidal_lk, step.gram_gate = klt.pyramidal_lk_conv, gram_gate_plain
    try:
        state0, metrics0, _, fps0, _ = run_images_in(sim, frames, dev, mode="dynamic")
    finally:
        lk_kernel.pyramidal_lk, step.gram_gate = lk, gram
    tot0 = kernel_totals(metrics0)
    if not same_counts(tot, tot0):
        raise AssertionError(f"dynamic images-in: kernel path {tot} vs plain path {tot0}")
    print(f"dynamic images-in path: B={B_IMG} D={state.layout.dim}, sequence b clones where "
          f"(frame + b) is even: tracked after warm-up {tracked_warm}, timed {tot} (plain path "
          f"{tot0}); clones in the ring {clones}; RMSE per sequence max {float(rmse.max()):.4f} m, "
          f"mean {float(rmse.mean()):.4f} m; |p - p_plain| max "
          f"{float((state.p - state0.p).abs().max()):.3e} m; launches {launches}; {fps:.1f} "
          f"frames/s (plain path {fps0:.1f})")
    return launches, fps, captured


def drive_live(system, events, keep=LIVE_KEEP, n_gram=2, per_frame=None):
    """Feed an event stream to a VioSystem on the card, counting launches
    from zero and keeping the last `keep` frames' gate/Gram arguments
    (n_gram calls a frame) and the last LK call; per_frame(system) runs
    after each frame.  Returns (launches, frame timings, wall s, capture)."""
    import torch

    from plviwo_tpu_torch import examples
    from plviwo_tpu_torch.ops import lk_kernel
    from plviwo_tpu_torch.ops.msckf_kernel import gram_gate

    timing, capture = [], {}
    with recording(capture, n_gram=n_gram * keep):
        torch.cuda.synchronize()
        lk_kernel.lk_pyramid.launches = 0
        gram_gate.launches = 0
        t0 = time.perf_counter()
        for kind, args in events:
            n = system.stats["updates"]
            examples.feed(system, kind, args)
            if system.stats["updates"] > n:
                timing.append(system.frame_timing)
                if per_frame is not None:
                    per_frame(system)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"lk_pyramid": lk_kernel.lk_pyramid.launches,
                    "msckf_gram_gate": gram_gate.launches}
    return launches, timing, wall, capture


def latency(timing):
    lat = np.array([f["frame"] for f in timing])
    return float(np.percentile(lat, 50)), float(np.percentile(lat, 90))


def phase_live_dynamic(dev):
    """The live driver with dynamic cloning: tests/test_dynamic_fused.py's
    90-frame scenario (12 s, seed 6, lines, wheel, clone rate capped at
    10 Hz) through the port's VioSystem at B = 1, held to that test's gates
    (frames >= 80, clones < frames, cam_accept > 20, wheel_accept > clones
    // 3, RMSE < 0.5 m, p/o/v NEES means after frame 10 in (0.15, 6.0)) and
    to one LK and two gate/Gram launches per frame."""
    import torch

    from plviwo_tpu_torch import examples
    from plviwo_tpu_torch.config.options import EstimatorOptions
    from plviwo_tpu_torch.core.system import VioSystem
    from plviwo_tpu_torch.ops import lie
    from plviwo_tpu_torch.sim.simulator import SimConfig, Simulator

    sim = Simulator(SimConfig(duration=12.0, n_landmarks=350, n_lines=40, width=W_IMG,
                              height=H_IMG, seed=6))
    events = examples.live_events(sim, LIVE_T0, DYN_FRAMES)
    system = VioSystem(examples.dynamic_options(EstimatorOptions()), device=dev)
    examples.live_calibrate(system, sim, LIVE_T0)
    nees = []

    def record_nees(s):
        st, kin = s.state, sim.gt_kin(s._time)
        d = np.sqrt(np.maximum(st.cov[0].diagonal()[:15].cpu().numpy(), 1e-18))
        dR = lie.quat_2_rot(st.q[0]).cpu().numpy() @ np.asarray(kin["R_GtoI"]).T
        o = lie.log_so3(torch.as_tensor(dR)).numpy()
        nees.append([np.sum(((st.p[0].cpu().numpy() - kin["p_IinG"]) / d[3:6]) ** 2),
                     np.sum((o / d[0:3]) ** 2),
                     np.sum(((st.v[0].cpu().numpy() - kin["v_IinG"]) / d[6:9]) ** 2)])

    launches, timing, wall, capture = drive_live(system, events, per_frame=record_nees)
    n, clones = system.stats["updates"], system.stats["clones"]
    errs = [np.linalg.norm(p - sim.gt_pose(t)[1]) for t, _, p in system.traj]
    rmse = float(np.sqrt(np.mean(np.square(errs))))
    means = np.mean(np.array(nees[10:]), axis=0)
    d = system.state.cov[0].diagonal()
    p50, p90 = latency(timing)
    print(f"live driver, dynamic cloning (B=1, D={system.layout.dim}): stats {system.stats}; "
          f"clones/frames {clones}/{n}; RMSE {rmse:.4f} m; NEES means p/o/v "
          f"{means[0]:.3f}/{means[1]:.3f}/{means[2]:.3f}; launches {launches}; frame latency p50 "
          f"{p50:.3f} ms, p90 {p90:.3f} ms; {n / wall:.2f} frames/s")
    ok = (n >= 80 and clones < n and system.stats["cam_accept"] > 20
          and system.stats["wheel_accept"] > clones // 3 and rmse < 0.5 and len(nees[10:]) > 40
          and bool(((means > 0.15) & (means < 6.0)).all()) and bool(torch.isfinite(d).all())
          and bool((d > -1e-9).all()))
    if launches != {"lk_pyramid": n, "msckf_gram_gate": 2 * n} or not ok:
        raise AssertionError("live driver, dynamic cloning: missed the gates of "
                             "tests/test_dynamic_fused.py or one LK and two gate/Gram launches "
                             "a frame")
    return launches, dict(p50_ms=p50, p90_ms=p90, fps=n / wall), capture


def phase_live_stereo(dev):
    """The live driver with stereo: tests/test_stereo_fused.py's scenario
    (9 s, seed 4, no lines, wheel, 60 frames) through the port's VioSystem
    at B = 1, once with a right image a frame and two cameras, once mono,
    held to that test's gates (stereo RMSE < 0.30 m, stereo acceptance
    above mono's, stereo RMSE < 1.25 x mono's) and the stereo run to two LK
    launches and one gate/Gram launch per frame."""
    from plviwo_tpu_torch import examples
    from plviwo_tpu_torch.config.options import EstimatorOptions
    from plviwo_tpu_torch.core.system import VioSystem
    from plviwo_tpu_torch.sim.simulator import SimConfig, Simulator

    out = {}
    for stereo in (True, False):
        sim = Simulator(SimConfig(duration=9.0, n_landmarks=350, n_lines=0, width=W_IMG,
                                  height=H_IMG, seed=4))
        events = examples.live_events(sim, LIVE_T0, STEREO_FRAMES, stereo=stereo)
        system = VioSystem(examples.stereo_options(EstimatorOptions(), stereo), device=dev)
        examples.live_calibrate(system, sim, LIVE_T0)
        launches, timing, wall, capture = drive_live(system, events, n_gram=1)
        st = system.stats
        errs = [np.linalg.norm(p - sim.gt_pose(t)[1]) for t, _, p in system.traj]
        rmse = float(np.sqrt(np.mean(np.square(errs))))
        acc = st["cam_accept"] / max(st["cam_accept"] + st["cam_reject"], 1)
        p50, p90 = latency(timing)
        out[stereo] = dict(rmse=rmse, acc=acc, launches=launches, capture=capture, n=st["updates"],
                           p50_ms=p50, p90_ms=p90, fps=st["updates"] / wall, D=system.layout.dim)
        print(f"live driver, {'stereo' if stereo else 'mono'} (B=1, D={system.layout.dim}): "
              f"stats {st}; RMSE {rmse:.4f} m; acceptance {acc:.4f}; launches {launches}; frame "
              f"latency p50 {p50:.3f} ms, p90 {p90:.3f} ms; {out[stereo]['fps']:.2f} frames/s")
    s, m = out[True], out[False]
    n = s["n"]
    if s["launches"] != {"lk_pyramid": 2 * n, "msckf_gram_gate": n}:
        raise AssertionError(f"live driver, stereo: {s['launches']} in {n} frames, want two LK "
                             "and one gate/Gram per frame")
    if not (n == STEREO_FRAMES and s["rmse"] < 0.30 and s["acc"] > m["acc"]
            and s["rmse"] < 1.25 * m["rmse"]):
        raise AssertionError("live driver, stereo: missed the gates of "
                             "tests/test_stereo_fused.py (RMSE < 0.30 m, acceptance above "
                             "mono's, RMSE < 1.25 x mono's)")
    return s["launches"], s, s["capture"]


def newest_mixed(calls):
    """The newest of the kept gate/Gram calls whose plain result accepts
    some features and rejects others, and how many calls back it is."""
    from plviwo_tpu_torch.ops.msckf_kernel import gram_gate_plain

    for back, args in enumerate(reversed(calls)):
        ok = gram_gate_plain(*args)[2]
        if 0 < int(ok.sum()) < ok.numel():
            return back, args
    raise AssertionError("no kept gate/Gram call accepts some features and rejects others")


def phase_new_path_kernels(stereo_args, dyn_args, dyn_live_args, stereo_live_args):
    """Both kernels against their plain versions on the new paths' own
    arguments: the stereo images-in frame's last point call (M = 32,
    D = 147) and its L->R LK call; the dynamic images-in frame's last
    (interpolated) point call; the dynamic live driver's interpolated point
    rows (the newest kept mixed call); the stereo live driver's point call
    (M = 48, D = 127)."""
    from plviwo_tpu_torch.ops import cuda_lib

    lib = cuda_lib.library()
    out = {}

    def shape(args):
        return "x".join(str(n) for n in args[0].shape)

    args = stereo_args["gram_gate"][0]
    out["stereo_frame_points"] = phase_gram(f"stereo images-in last frame, points {shape(args)}",
                                            args)
    out["stereo_frame_lk_lr"] = phase_lk("stereo images-in last frame, L->R", stereo_args["lk"])
    args = dyn_args["gram_gate"][0]
    out["dynamic_frame_points"] = phase_gram(
        f"dynamic images-in last frame, interpolated points {shape(args)}", args)
    back, args = newest_mixed(dyn_live_args["gram_gate"][0::2])
    out["dynamic_driver_points"] = phase_gram(
        f"dynamic live driver frame (last - {back}), interpolated points {shape(args)}", args)
    back, args = newest_mixed(stereo_live_args["gram_gate"])
    out["stereo_driver_points"] = phase_gram(
        f"stereo live driver frame (last - {back}), points {shape(args)}", args)
    for key in ("stereo_frame_points", "stereo_driver_points"):
        a = (stereo_args if key == "stereo_frame_points" else stereo_live_args)["gram_gate"][0]
        M, D = a[0].shape[2], a[0].shape[3]
        print(f"gate/Gram pass-1 shared memory at M={M}, D={D}, k=3: "
              f"{lib.msckf_gram_gate_smem_bytes(M, D, 3)} B")
    return out


def e2e_vio_options(o):
    """tests/test_e2e_vio.py's estimator options (the per-track phases 16
    and 19 start from them).  Returns o."""
    o.window_size, o.clone_freq = 1.0, 10
    o.cam.n_pts, o.cam.max_msckf, o.cam.sigma_pix = 60, 30, 0.5
    o.cam.min_track_length, o.cam.chi2_mult = 4, 5.0
    return o


def kaist_options(o, lines=False):
    """configs/kaist's per-track settings: config_estimator.yaml (clone_freq
    20, window 1.0, intr_order 3, dynamic cloning) and config_camera.yaml's
    points (150, max_msckf 40, sigma_pix 1.5, chi2 x 8, min track 4) and,
    with lines, its lines (use_lines, max_lines 40, sigma_pix_line 2.5), with
    a W3D_ANG wheel at run_sim's noise.  Returns o."""
    o.clone_freq, o.window_size, o.intr_order, o.dynamic_cloning = 20, 1.0, 3, True
    o.cam.n_pts, o.cam.max_msckf, o.cam.sigma_pix = 150, 40, 1.5
    o.cam.chi2_mult, o.cam.min_track_length = 8.0, 4
    o.cam.use_lines, o.cam.max_lines, o.cam.sigma_pix_line = lines, 40, 2.5
    w = o.wheel
    w.enabled, w.type, w.chi2_mult = True, "Wheel3DAng", 10.0
    w.noise_w, w.noise_v, w.noise_p = 0.05, 0.05, 0.02
    return o


def drive_track(system, events, per_frame=None, feed=None):
    """Feed a per-track event stream (`examples.track_events`) to a
    VioSystem on the card with both kernels' launch counts set to 0, the
    frame timings kept and every synchronizing CUDA call counted (sync debug
    mode); per_frame(system) runs after each processed frame (host reads
    only); feed(system, kind, args) hands on each event (`examples.feed`,
    or a host tracker's `examples.feed_tracked`).  Returns readings:
    launches, frames, frames/s, latency p50/p90
    of the frame (`frame_timing["frame"]`: one `_process_pending` frame, its
    last device read included), median stage ms and the line stage's mean,
    syncs and the driver's own device reads per frame, and the most reads
    between two frames."""
    import warnings

    import torch

    from plviwo_tpu_torch import examples
    from plviwo_tpu_torch.ops import lk_kernel
    from plviwo_tpu_torch.ops.msckf_kernel import gram_gate

    feed = feed or examples.feed
    timing, reads = [], []
    torch.cuda.synchronize()
    lk_kernel.lk_pyramid.launches = 0
    gram_gate.launches = 0
    reads0 = system.host_reads
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            t0 = time.perf_counter()
            for kind, args in events:
                n = len(system.traj)
                feed(system, kind, args)
                if len(system.traj) > n:
                    timing.append(system.frame_timing)
                    reads.append(system.host_reads)
                    if per_frame is not None:
                        per_frame(system)
            wall = time.perf_counter() - t0
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    syncs = sum(1 for w in caught if "synchroniz" in str(w.message))
    n = len(timing)
    lat = np.array([f["frame"] for f in timing])
    return dict(launches={"lk_pyramid": lk_kernel.lk_pyramid.launches,
                          "msckf_gram_gate": gram_gate.launches},
                frames=n, fps=n / wall, p50_ms=float(np.percentile(lat, 50)),
                p90_ms=float(np.percentile(lat, 90)),
                stages={k: float(np.median([f[k] for f in timing])) for k in timing[0]},
                line_mean_ms=float(np.mean([f["line"] for f in timing])),
                syncs_per_frame=syncs / n, reads_per_frame=(system.host_reads - reads0) / n,
                reads_max=int(np.max(np.diff([reads0] + reads))), D=system.layout.dim)


def track_report(tag, system, r, extra="", launches=None):
    st = ", ".join(f"{k} {v:.3f}" for k, v in r["stages"].items())
    print(f"{tag} (B=1, D={r['D']}): stats {system.stats}{extra}; launches {r['launches']}; "
          f"{r['frames']} frames, {r['fps']:.2f} frames/s; frame latency p50 {r['p50_ms']:.3f} ms, "
          f"p90 {r['p90_ms']:.3f} ms; median stage ms: {st}; line stage mean "
          f"{r['line_mean_ms']:.3f} ms; syncs per frame {r['syncs_per_frame']:.2f} (the driver's "
          f"device reads {r['reads_per_frame']:.2f}, at most {r['reads_max']} in one frame)")
    want = launches or {"lk_pyramid": 0, "msckf_gram_gate": 0}
    if r["launches"] != want:
        raise AssertionError(f"{tag}: launches {r['launches']}, want {want}")


def track_rmse(sim, system):
    errs = np.array([np.linalg.norm(p - sim.gt_kin(t)["p_IinG"]) for t, _, p in system.traj])
    return float(np.sqrt(np.mean(errs**2))), errs


def phase_track_mono(dev):
    """Phase 16, the per-track path, mono: tests/test_e2e_vio.py's scenario
    (15 s, seed 1, the simulator's data association, 45 points a frame)
    through `VioSystem.feed_camera` on the card, held to that file's five
    gates; no kernel launch (no TPU kernel lies on JAX's per-track path)."""
    import torch

    from plviwo_tpu_torch import examples
    from plviwo_tpu_torch.config.options import EstimatorOptions
    from plviwo_tpu_torch.core.system import VioSystem
    from plviwo_tpu_torch.ops import lie
    from plviwo_tpu_torch.sim.simulator import SimConfig, Simulator

    sim = Simulator(SimConfig(duration=15.0, seed=1, sigma_pix=0.5, n_pts=45, sigma_w=1.7e-4,
                              sigma_a=2.0e-3, sigma_wb=1.9e-5, sigma_ab=3.0e-3))
    system = VioSystem(e2e_vio_options(EstimatorOptions()), device=dev)
    examples.live_calibrate(system, sim, float(sim.imu_t[0]))
    r = drive_track(system, examples.track_events(sim))
    rmse, errs = track_rmse(sim, system)
    st = system.stats
    cov = system.state.cov[0].cpu().numpy()
    active = np.flatnonzero(np.abs(np.diag(cov)) > 0)
    sub = cov[np.ix_(active, active)]
    eig = np.linalg.eigvalsh(sub)
    t, q, _ = system.traj[-1]
    dR = lie.quat_2_rot(torch.as_tensor(q)).numpy() @ sim.gt_kin(t)["R_GtoI"].T
    ang = float(np.linalg.norm(lie.log_so3(torch.as_tensor(dR)).numpy()))
    track_report("per-track mono", system, r, f"; RMSE {rmse:.4f} m, final {errs[-1]:.4f} m, "
                 f"final orientation error {np.degrees(ang):.3f} deg")
    ok = (len(system.traj) > 100 and rmse < 1.0 and errs[-1] < 2.0 and st["updates"] > 20
          and st["cam_accept"] > 50
          and st["cam_accept"] / max(st["cam_accept"] + st["cam_reject"], 1) > 0.5
          and st["lost_marg_obs"] == 0 and bool(np.all(np.isfinite(cov)))
          and bool(np.all(np.diag(sub) > 0)) and eig.min() > -1e-7 * eig.max()
          and np.trace(cov[3:6, 3:6]) < 5.0 and ang < 0.05)
    if not ok:
        raise AssertionError("per-track mono: missed the gates of tests/test_e2e_vio.py")
    return dict(r, rmse=rmse)


def phase_track_kaist(dev):
    """Phase 17, the per-track path at the KAIST width, mono:
    `kaist_options` on `SimConfig(duration=15, seed=1, n_pts=150)` with a
    W3D_ANG wheel (D = 172); ATE finite and < 1.0 m, lost_marg_obs as JAX's
    driver's at these settings, and the ATE within 1.5x of that driver's
    on the CPU (KAIST_JAX_ATE)."""
    from plviwo_tpu_torch import examples
    from plviwo_tpu_torch.config.options import EstimatorOptions
    from plviwo_tpu_torch.core.system import VioSystem
    from plviwo_tpu_torch.sim.simulator import SimConfig, Simulator

    sim = Simulator(SimConfig(duration=15.0, seed=1, n_pts=150))
    system = VioSystem(kaist_options(EstimatorOptions()), device=dev)
    examples.live_calibrate(system, sim, float(sim.imu_t[0]))
    r = drive_track(system, examples.track_events(sim, wheel=True))
    rmse, _ = track_rmse(sim, system)
    track_report("per-track KAIST width", system, r,
                 f"; ATE {rmse:.4f} m (JAX's driver on the CPU: {KAIST_JAX_ATE} m)")
    lost = system.stats["lost_marg_obs"]
    if not (np.isfinite(rmse) and rmse < 1.0 and lost == KAIST_JAX_LOST
            and rmse < 1.5 * KAIST_JAX_ATE):
        raise AssertionError("per-track KAIST width: ATE not finite and < 1.0 m, or not within "
                             f"1.5x of JAX's {KAIST_JAX_ATE} m, or lost_marg_obs {lost} != "
                             f"JAX's {KAIST_JAX_LOST}")
    return dict(r, rmse=rmse)


def phase_track_stereo():
    """Phase 18, per-track stereo against mono: tests/test_e2e_vio.py's
    test_stereo_beats_mono (run_sim, 8 s, seed 2) through the port's run_sim
    on the card; stereo ATE < mono ATE."""
    import io

    from plviwo_tpu_torch import run_sim

    out = {}
    for stereo in (False, True):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = run_sim.main(["--duration", "8", "--seed", "2"] + (["--stereo"] if stereo else []))
        out[stereo] = json.loads(buf.getvalue().strip().splitlines()[-1])
        if rc != 0:
            raise AssertionError(f"run_sim {'--stereo ' if stereo else ''}exited {rc}")
    print(f"per-track run_sim (8 s, seed 2) on {out[True]['device']}: mono {out[False]}; "
          f"stereo {out[True]}")
    if not out[True]["ate_rmse_m"] < out[False]["ate_rmse_m"]:
        raise AssertionError("per-track stereo: ATE not below mono's (tests/test_e2e_vio.py::"
                             "test_stereo_beats_mono)")
    return out


def phase_track_orders(dev):
    """Phase 19, the interpolation order at a 4 Hz clone cap:
    tests/test_poly_interp_e2e.py's scenario (12 s, seed 3, dynamic cloning,
    30 MSCKF features) at orders 1 and 3 through the port on the card; both
    RMSE < 1.0 m, order 3 within 1.15x of order 1, updates > 10,
    lost_marg_obs 0."""
    from plviwo_tpu_torch import examples
    from plviwo_tpu_torch.config.options import EstimatorOptions
    from plviwo_tpu_torch.core.system import VioSystem
    from plviwo_tpu_torch.sim.simulator import SimConfig, Simulator

    out = {}
    for order in (1, 3):
        sim = Simulator(SimConfig(duration=12.0, seed=3, sigma_pix=0.5, n_pts=45))
        o = EstimatorOptions()
        o.dynamic_cloning, o.clone_freq, o.intr_order = True, 4, order
        o.cam.max_msckf, o.cam.sigma_pix, o.cam.min_track_length, o.cam.chi2_mult = 30, 0.5, 4, 5.0
        system = VioSystem(o, device=dev)
        examples.live_calibrate(system, sim, float(sim.imu_t[0]))
        r = drive_track(system, examples.track_events(sim))
        rmse, _ = track_rmse(sim, system)
        track_report(f"per-track order {order} at a 4 Hz clone cap", system, r,
                     f"; RMSE {rmse:.4f} m")
        out[order] = dict(r, rmse=rmse, stats=dict(system.stats))
    r1, r3 = out[1]["rmse"], out[3]["rmse"]
    if not (r1 < 1.0 and r3 < 1.0 and r3 <= 1.15 * r1
            and all(out[k]["stats"]["updates"] > 10 and out[k]["stats"]["lost_marg_obs"] == 0
                    for k in (1, 3))):
        raise AssertionError("per-track orders: missed tests/test_poly_interp_e2e.py's gates "
                             f"(RMSE {r1:.4f} / {r3:.4f} m)")
    return out


def lines_options(o):
    """tests/test_lines.py::test_e2e_points_and_lines's estimator options
    (25 MSCKF features, sigma_pix 0.5, chi2 x 5, 20 lines a frame at
    sigma_pix_line 2.0).  Returns o."""
    o.cam.max_msckf, o.cam.sigma_pix, o.cam.min_track_length, o.cam.chi2_mult = 25, 0.5, 4, 5.0
    o.cam.use_lines, o.cam.max_lines, o.cam.sigma_pix_line = True, 20, 2.0
    return o


def phase_track_lines(dev):
    """Phase 20, per-track points + lines, mono: tests/test_lines.py::
    test_e2e_points_and_lines's scenario (10 s, seed 7, 35 points and up to
    50 lines a frame) through `VioSystem.feed_camera` with lines on the
    card; line_accept > 10, RMSE < 1.0 m and within 1.5x of JAX's driver on
    the CPU (LINES_JAX_RMSE); no kernel launch.  A missed gate is returned
    as `failed` (the later phases still run, and main exits 1)."""
    from plviwo_tpu_torch import examples
    from plviwo_tpu_torch.config.options import EstimatorOptions
    from plviwo_tpu_torch.core.system import VioSystem
    from plviwo_tpu_torch.sim.simulator import SimConfig, Simulator

    sim = Simulator(SimConfig(duration=10.0, seed=7, sigma_pix=0.5, n_pts=35, sigma_pix_line=1.0,
                              n_lines=50))
    system = VioSystem(lines_options(EstimatorOptions()), device=dev)
    examples.live_calibrate(system, sim, float(sim.imu_t[0]))
    r = drive_track(system, examples.track_events(sim, lines=True))
    rmse, _ = track_rmse(sim, system)
    track_report("per-track points + lines", system, r,
                 f"; RMSE {rmse:.4f} m ({rmse / LINES_JAX_RMSE:.3f}x JAX's driver on the CPU)")
    failed = None
    if not (system.stats["line_accept"] > 10 and rmse < 1.0 and rmse < 1.5 * LINES_JAX_RMSE):
        failed = ("per-track points + lines: missed tests/test_lines.py's gates (line_accept > "
                  f"10, RMSE < 1.0 m) or 1.5x JAX's {LINES_JAX_RMSE} m: line_accept "
                  f"{system.stats['line_accept']}, RMSE {rmse} m")
        print(f"FAILED {failed}")
    return dict(r, rmse=rmse, failed=failed)


def phase_track_kaist_lines(dev):
    """Phase 21, the per-track path at the KAIST width with lines:
    `kaist_options(lines=True)` (config_camera.yaml's 40 lines at
    sigma_pix_line 2.5) on phase 17's `SimConfig(duration=15, seed=1,
    n_pts=150)` and its 60 lines; ATE finite, < 1.0 m and within 1.5x of
    JAX's driver on the CPU (KAIST_LINES_JAX_ATE), lost_marg_obs as JAX's,
    line_accept > 0."""
    from plviwo_tpu_torch import examples
    from plviwo_tpu_torch.config.options import EstimatorOptions
    from plviwo_tpu_torch.core.system import VioSystem
    from plviwo_tpu_torch.sim.simulator import SimConfig, Simulator

    sim = Simulator(SimConfig(duration=15.0, seed=1, n_pts=150))
    system = VioSystem(kaist_options(EstimatorOptions(), lines=True), device=dev)
    examples.live_calibrate(system, sim, float(sim.imu_t[0]))
    r = drive_track(system, examples.track_events(sim, wheel=True, lines=True))
    rmse, _ = track_rmse(sim, system)
    track_report("per-track KAIST width with lines", system, r,
                 f"; ATE {rmse:.4f} m (JAX's driver on the CPU: {KAIST_LINES_JAX_ATE} m)")
    st = system.stats
    if not (np.isfinite(rmse) and rmse < 1.0 and rmse < 1.5 * KAIST_LINES_JAX_ATE
            and st["lost_marg_obs"] == KAIST_LINES_JAX_LOST and st["line_accept"] > 0):
        raise AssertionError("per-track KAIST width with lines: ATE not finite and < 1.0 m or "
                             f"not within 1.5x of JAX's {KAIST_LINES_JAX_ATE} m, lost_marg_obs "
                             f"{st['lost_marg_obs']} != JAX's {KAIST_LINES_JAX_LOST}, or no line "
                             "accepted")
    return dict(r, rmse=rmse)


def phase_track_slam(dev):
    """Phase 22, SLAM landmarks: tests/test_slam.py's scenario (10 s, seed 1,
    8 slots) in both representations through the port on the card (>= 3
    active slots at some time, RMSE < 1.0 m, every checked landmark within
    2 m of the truth), then tests/test_joint_update.py's live replay with 6
    slots and GPS, joint (inverse-depth landmarks: the GPS init marginalizes
    them on the card) and sequential (xyz): both initialize landmarks and
    the GPS, RMSE < 1.0 m each and within 0.2 max + 0.02 m of each other.
    No kernel launch."""
    import torch

    from plviwo_tpu_torch import examples
    from plviwo_tpu_torch.config.options import EstimatorOptions
    from plviwo_tpu_torch.core.system import VioSystem
    from plviwo_tpu_torch.sim.simulator import SimConfig, Simulator
    from plviwo_tpu_torch.update import cam_helper

    out = {}
    for rep in ("GLOBAL_3D", "GLOBAL_FULL_INVERSE_DEPTH"):
        sim = Simulator(SimConfig(duration=10.0, seed=1, sigma_pix=0.5, n_pts=45))
        o = EstimatorOptions()
        o.cam.feat_rep, o.cam.max_slam = rep, 8
        o.cam.max_msckf, o.cam.sigma_pix, o.cam.min_track_length, o.cam.chi2_mult = 25, 0.5, 4, 5.0
        system = VioSystem(o, device=dev)
        examples.live_calibrate(system, sim, float(sim.imu_t[0]))
        active = []
        r = drive_track(system, examples.track_events(sim),
                        per_frame=lambda s: active.append(int(s._slam_valid.sum())))
        rmse, _ = track_rmse(sim, system)
        st = system.state
        xyz = cam_helper.rep_to_xyz(st.slam_p[0], system.feat_rep).cpu().numpy()
        ids, valid = st.slam_id[0].cpu().numpy(), st.slam_valid[0].cpu().numpy()
        errs = [float(np.linalg.norm(xyz[k] - sim.landmarks[ids[k]]))
                for k in np.flatnonzero(valid) if ids[k] < len(sim.landmarks)]
        track_report(f"per-track SLAM, {rep}", system, r,
                     f"; RMSE {rmse:.4f} m, at most {max(active)} landmarks active, "
                     f"landmark errors {np.round(errs, 3).tolist()} m")
        if not (max(active) >= 3 and rmse < 1.0 and errs and max(errs) < 2.0):
            raise AssertionError(f"per-track SLAM ({rep}): missed tests/test_slam.py's gates")
        out[rep] = dict(r, rmse=rmse)
    rmse = {}
    for joint, rep in ((True, "GLOBAL_FULL_INVERSE_DEPTH"), (False, "GLOBAL_3D")):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rmse[joint], stats, system = examples.joint_update_replay(joint, slam=6, gps=True,
                                                                  feat_rep=rep, device=dev)
        torch.cuda.synchronize()
        print(f"SLAM + GPS live replay ({'joint' if joint else 'sequential'}, {rep}): RMSE "
              f"{rmse[joint]:.4f} m, stats {stats}, GPS {system.gps.stats}, landmarks active "
              f"{int(system._slam_valid.sum())}, {time.perf_counter() - t0:.2f} s")
        if not (bool(system.state.slam_valid.any()) and system.gps.initialized):
            raise AssertionError("SLAM + GPS live replay: no landmark or no GPS init")
    rj, rs = rmse[True], rmse[False]
    if not (rj < 1.0 and rs < 1.0 and abs(rj - rs) < 0.2 * max(rj, rs) + 0.02):
        raise AssertionError("SLAM + GPS live replay: missed tests/test_joint_update.py's "
                             f"parity gate (joint {rj:.4f} m, sequential {rs:.4f} m)")
    return out


def count_ops(fn):
    """(fn's result, the host operators it dispatched): a torch dispatch-mode
    count of every ATen operator the call runs."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        out = fn()
    return out, Count.n


def run_sim_options(o, wheel=False, imu_res=False):
    """run_sim's per-track settings without images (30 MSCKF features,
    sigma_pix 0.5, chi2 x 5, tracks of >= 4; with the wheel W3D_ANG at
    0.05 / 0.05 / 0.02 and chi2 x 10), with use_imu_res.  Works on the
    port's options and the JAX package's.  Returns o."""
    o.use_imu_res = imu_res
    o.cam.max_msckf, o.cam.sigma_pix, o.cam.min_track_length, o.cam.chi2_mult = 30, 0.5, 4, 5.0
    if wheel:
        w = o.wheel
        w.enabled, w.type, w.chi2_mult = True, "Wheel3DAng", 10.0
        w.noise_w, w.noise_v, w.noise_p = 0.05, 0.05, 0.02
    return o


def auto_init_run(system, sim, feed):
    """run_sim --wheel --auto-init's stream through a VioSystem (the port's
    or JAX's): the camera and wheel calibration installed, no seed, the
    per-track events of `examples.track_events(wheel=True)` handed to
    feed(kind, args).  Returns (ATE after position-and-yaw alignment, the
    init time)."""
    from plviwo_tpu_torch import examples
    from plviwo_tpu_torch.eval.metrics import ate

    c = sim.cfg
    system.set_calibration(np.asarray(c.intrinsics), np.asarray(c.cam_ext_q),
                           np.asarray(c.cam_ext_p))
    system.set_wheel_calibration(np.asarray(c.wheel_ext_q), np.asarray(c.wheel_ext_p),
                                 [c.wheel_rl, c.wheel_rr, c.wheel_base])
    for kind, args in examples.track_events(sim, wheel=True):
        feed(kind, args)
    t = np.array([t for t, _, _ in system.traj])
    kins = [sim.gt_kin(x) for x in t]
    res = ate(t, np.array([p for _, _, p in system.traj]), np.array([q for _, q, _ in system.traj]),
              t, np.array([k["p_IinG"] for k in kins]), np.array([sim.gt_pose(x)[0] for x in t]),
              method="posyaw")
    return res["pos"]["rmse"], system.startup_time


def phase_cpi(dev):
    """Phase 23, CPI-interpolated poses: run_sim --imu-res --duration 8
    --seed 3's scenario through `VioSystem.feed_camera` with use_imu_res on
    the card: ATE < 0.2 m, cam_accept_rate > 0.5, within 1.5x of JAX's
    driver on the CPU (CPI_JAX_ATE).  There a clone lands on every frame,
    so every measurement time is a clone's and each CPI window is one
    sample; the same scenario with dynamic cloning under a 4 Hz cap puts
    most measurements between clones: RMSE < 1.0 m and within 1.5x of JAX's
    (CPI_DYN_JAX_ATE).  No kernel launch.  The widest `build_cpi_table` call
    of the second run (the most IMU steps) against the same call on the CPU
    within 1e-9, its host operators (a dispatch-mode count) and time.
    Returns the first run's readings with the second's and the table's."""
    import torch

    from plviwo_tpu_torch import examples
    from plviwo_tpu_torch.config.options import EstimatorOptions
    from plviwo_tpu_torch.core import system as system_mod
    from plviwo_tpu_torch.core.system import VioSystem
    from plviwo_tpu_torch.sim.simulator import SimConfig, Simulator

    build, calls = system_mod.build_cpi_table, []

    def recording_build(*args, **kw):  # keeps the widest table (most IMU steps) of the run
        if not calls or args[6].shape[-1] >= calls[0][0][6].shape[-1]:
            calls[:] = [(args, kw)]
        return build(*args, **kw)

    out = {}
    for dynamic in (False, True):
        sim = Simulator(SimConfig(duration=8.0, seed=3, sigma_pix=0.5, n_pts=45))
        o = run_sim_options(EstimatorOptions(), imu_res=True)
        if dynamic:
            o.dynamic_cloning, o.clone_freq = True, 4
        system = VioSystem(o, device=dev)
        examples.live_calibrate(system, sim, float(sim.imu_t[0]))
        calls.clear()
        system_mod.build_cpi_table = recording_build
        try:
            r = drive_track(system, examples.track_events(sim))
        finally:
            system_mod.build_cpi_table = build
        rmse, _ = track_rmse(sim, system)
        st = system.stats
        acc = st["cam_accept"] / max(st["cam_accept"] + st["cam_reject"], 1)
        jax = CPI_DYN_JAX_ATE if dynamic else CPI_JAX_ATE
        tag = "per-track CPI poses (use_imu_res" + (", dynamic cloning at 4 Hz)" if dynamic
                                                    else ")")
        track_report(tag, system, r, f"; ATE {rmse:.4f} m ({rmse / jax:.3f}x JAX's driver on "
                     f"the CPU), cam_accept_rate {acc:.3f}; widest table N = "
                     f"{calls[0][0][6].shape[-1]}")
        out[dynamic] = dict(r, rmse=rmse, acc=acc)
    # the widest table against the same call on the CPU, and its host operators
    args, kw = calls[0]
    got = build(*args, **kw)
    cpu = build(*(a.cpu() if torch.is_tensor(a) else a for a in args), **kw)
    err = max(float((g.cpu() - c).abs().max()) for g, c in zip(got, cpu))
    n_ops = count_ops(lambda: build(*args, **kw))[1]
    torch.cuda.synchronize()
    ms = cuda_ms(lambda: build(*args, **kw), n_iter=10)
    T, N = args[6].shape[1:]
    print(f"build_cpi_table (T={T}, N={N}): {n_ops} host operators, {ms:.3f} ms a call, card "
          f"vs CPU max |d| {err:.3e}")
    a, b = out[False], out[True]
    if not (a["rmse"] < 0.2 and a["acc"] > 0.5 and a["rmse"] < 1.5 * CPI_JAX_ATE
            and b["rmse"] < 1.0 and b["rmse"] < 1.5 * CPI_DYN_JAX_ATE and err < 1e-9):
        raise AssertionError("per-track CPI poses: missed tests/test_poly_interp_e2e.py::"
                             "test_cpi_interpolation_e2e's gates (ATE < 0.2 m, accept > 0.5), "
                             "1.5x JAX's, or the table's 1e-9 against the CPU")
    return dict(a, dynamic=b, table_ops=n_ops, table_ms=ms, table_err=err, table_TN=(T, N))


def phase_auto_init(dev):
    """Phase 24, the IMU+wheel auto-initialization: run_sim --wheel
    --auto-init --duration 8 --seed 3's scenario on the card, no ground-truth
    seed; the init time equal to JAX's driver's (AUTO_INIT_JAX_T), ATE
    (position and yaw aligned) < 0.1 m and within 1.5x of JAX's
    (AUTO_INIT_JAX_ATE), and no device read and no synchronizing call on an
    IMU sample before the initialization."""
    import warnings

    import torch

    from plviwo_tpu_torch import examples
    from plviwo_tpu_torch.config.options import EstimatorOptions
    from plviwo_tpu_torch.core.system import VioSystem
    from plviwo_tpu_torch.sim.simulator import SimConfig, Simulator

    sim = Simulator(SimConfig(duration=8.0, seed=3, sigma_pix=0.5, n_pts=45))
    system = VioSystem(run_sim_options(EstimatorOptions(), wheel=True), device=dev)
    pre = {"samples": 0, "syncs": 0, "reads": 0}

    def feed(kind, args):
        if system.initialized:
            return examples.feed(system, kind, args)
        reads = system.host_reads
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                examples.feed(system, kind, args)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        if kind == "imu" and not system.initialized:
            pre["samples"] += 1
            pre["syncs"] += sum(1 for w in caught if "synchroniz" in str(w.message))
            pre["reads"] += system.host_reads - reads

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ate_m, t_init = auto_init_run(system, sim, feed)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(f"per-track IMU+wheel auto-init (B=1, D={system.layout.dim}): init at {t_init} s (JAX "
          f"{AUTO_INIT_JAX_T} s) after {pre['samples']} IMU samples with {pre['reads']} device "
          f"reads and {pre['syncs']} synchronizing calls; stats {system.stats}; ATE (posyaw) "
          f"{ate_m:.4f} m ({ate_m / AUTO_INIT_JAX_ATE:.3f}x JAX's driver on the CPU); "
          f"{len(system.traj)} frames in {wall:.2f} s")
    if not (t_init == AUTO_INIT_JAX_T and ate_m < 0.1 and ate_m < 1.5 * AUTO_INIT_JAX_ATE
            and pre["reads"] == 0 and pre["syncs"] == 0):
        raise AssertionError("per-track auto-init: the init time differs from JAX's, or ATE not "
                             f"< 0.1 m and within 1.5x of JAX's {AUTO_INIT_JAX_ATE} m, or a "
                             "device read before the initialization")
    return dict(ate=ate_m, t_init=t_init, pre=pre)


def phase_zupt(dev):
    """Phase 25, zero-velocity updates: tests/test_zupt.py's two streams
    through the port on the card: stationary from a wrong start velocity,
    applied > 0 and |v| < 0.05 m/s; turning and accelerating, applied == 0.
    Syncs per IMU sample, the target 0 outside a ZUPT update."""
    import warnings

    import torch

    from plviwo_tpu_torch.config.options import EstimatorOptions
    from plviwo_tpu_torch.core.system import VioSystem

    out = {}
    for moving in (False, True):
        o = EstimatorOptions()
        o.zupt.enabled = True
        if not moving:
            o.imu.init_cov_vel = 0.3
        system = VioSystem(o, device=dev)
        system.initialize_from(0.0, [0, 0, 0, 1.0], np.zeros(3),
                               np.zeros(3) if moving else [0.2, 0.0, 0.0], np.zeros(3),
                               np.zeros(3))
        rng = np.random.default_rng(0)
        n, syncs, outside, tries = 0, 0, 0, 0
        for i in range(1, 150) if moving else range(200):
            if moving:
                w, a = np.array([0.0, 0.0, 0.5]), np.array([0.5, 0, 9.81])
            else:
                w = rng.normal(0, 1e-4, 3)
                a = np.array([0, 0, 9.81]) + rng.normal(0, 5e-3, 3)
            attempts = sum(system.zupt.stats.values())
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    system.feed_imu(i / 200.0, w, a)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            k = sum(1 for x in caught if "synchroniz" in str(x.message))
            tried = sum(system.zupt.stats.values()) > attempts
            n, syncs, tries = n + 1, syncs + k, tries + tried
            outside += 0 if tried else k
        v = float(np.linalg.norm(system.state.v[0].cpu().numpy()))
        tag = "moving" if moving else "stationary"
        print(f"ZUPT, {tag} stream: {system.zupt.stats}, |v| {v:.4f} m/s; {syncs / n:.3f} syncs "
              f"per IMU sample over {n} ({tries} ZUPT attempts, {outside} syncs outside them)")
        ok = (system.zupt.stats["applied"] == 0 if moving
              else system.zupt.stats["applied"] > 0 and v < 0.05)
        if not ok:
            raise AssertionError(f"ZUPT ({tag}): missed tests/test_zupt.py's gates")
        out[tag] = dict(stats=dict(system.zupt.stats), v=v, syncs_per_sample=syncs / n,
                        syncs_outside=outside)
    return out


def phase_host_tracker(dev):
    """Phase 26, the host KLT trackers into the per-track path: (a)
    tests/test_tracker.py::test_image_driven_vio_e2e's scenario (8 s, seed
    2, 350 landmarks, 80 slots) through `KltTracker` and `feed_camera` on
    the card: updates > 30, RMSE < 0.6 m and within 1.5x of JAX's tracker as
    it ships on the CPU (TRACKER_JAX_RMSE); (b) run_sim --images
    --host-tracker --stereo --duration 8 --seed 2's scenario through
    `StereoKltTracker` and `feed_stereo`: within 1.5x of JAX's
    (STEREO_TRACKER_JAX_ATE), the right observations kept; (c) the KAIST
    width: phase 17's configuration (D = 172) fed by a `KltTracker` at
    config_camera.yaml's 150 points (a 15 x 10 grid: one cell per slot, as
    the images-in driver sizes it) on rendered frames: ATE < 1.0 m and
    within 1.5x of JAX's driver with JAX's tracker on the CPU
    (KAIST_TRACKER_JAX_ATE).  The trackers run JAX's gather LK
    (`klt.pyramidal_lk`, plain torch: JAX runs it outside any kernel), so
    no kernel launches on these paths.  Readings as phase 16, plus the
    tracker's own ms a frame and its host operators in one frame."""
    from plviwo_tpu_torch import examples
    from plviwo_tpu_torch.config.options import EstimatorOptions
    from plviwo_tpu_torch.core.system import VioSystem
    from plviwo_tpu_torch.sim.simulator import SimConfig, Simulator
    from plviwo_tpu_torch.update.tracker import KltTracker

    def run(tag, sim, system, tracker, stereo=False, wheel=False):
        trk_ms, right, ops = [], [], []

        def feed(s, kind, args):
            if kind != "frame":
                return examples.feed(s, kind, args)
            track = tracker.feed_stereo if stereo else tracker.feed
            if len(trk_ms) == 10:  # one frame's host operators
                out, n_ops = count_ops(lambda: track(*args[1:]))
                ops.append(n_ops)
            else:
                out = track(*args[1:])
            trk_ms.append(tracker.last_ms)
            if stereo:
                right.append(len(out[2]))
                s.feed_stereo(args[0], *out)
            else:
                s.feed_camera(args[0], *out)

        events = examples.track_events(sim, stereo=stereo, wheel=wheel, images=True)
        r = drive_track(system, events, feed=feed)
        rmse, _ = track_rmse(sim, system)
        n = len(trk_ms)
        p50, p90 = float(np.percentile(trk_ms, 50)), float(np.percentile(trk_ms, 90))
        kept = (f"; right observations kept {sum(right)} ({sum(right) / n:.2f} a frame)"
                if stereo else "")
        track_report(tag, system, r, f"; RMSE {rmse:.4f} m; {n} frames tracked, tracker "
                     f"{p50:.3f} / {p90:.3f} ms a frame (p50 / p90; the 11th frame's ms is "
                     f"that of a count of its {ops[0]} host operators){kept}")
        return dict(r, rmse=rmse, tracked=n, tracker_p50_ms=p50, tracker_p90_ms=p90,
                    tracker_ops=ops[0], right=sum(right), stats=dict(system.stats))

    out = {}
    sim = Simulator(SimConfig(duration=8.0, seed=2, n_landmarks=350))
    out["mono"] = run("host tracker, mono (N=80)", sim, *examples.host_tracker_system(sim, dev))
    sim = Simulator(SimConfig(duration=8.0, seed=2, sigma_pix=0.5, n_pts=45))
    out["stereo"] = run("host tracker, stereo (N=80)", sim,
                        *examples.host_tracker_system(sim, dev, stereo=True), stereo=True)
    sim = Simulator(SimConfig(duration=15.0, seed=1, n_pts=150))
    system = VioSystem(kaist_options(EstimatorOptions()), device=dev)
    examples.live_calibrate(system, sim, float(sim.imu_t[0]))
    tracker = KltTracker(n_pts=150, cam_k=np.asarray(sim.cfg.intrinsics), grid_x=15, grid_y=10,
                         device=dev)
    out["kaist"] = run("host tracker, KAIST width (N=150)", sim, system, tracker, wheel=True)
    m, st, k = out["mono"], out["stereo"], out["kaist"]
    print(f"host trackers: mono RMSE {m['rmse']:.4f} m ({m['rmse'] / TRACKER_JAX_RMSE:.3f}x "
          f"JAX's), stereo {st['rmse']:.4f} m ({st['rmse'] / STEREO_TRACKER_JAX_ATE:.3f}x), KAIST "
          f"width {k['rmse']:.4f} m ({k['rmse'] / KAIST_TRACKER_JAX_ATE:.3f}x); right observations "
          f"kept {st['right']} (JAX's tracker on the same frames: {STEREO_JAX_RIGHT}); tracker "
          f"operators a frame: mono {m['tracker_ops']}, stereo {st['tracker_ops']}, KAIST "
          f"width {k['tracker_ops']}")
    if not (m["stats"]["updates"] > 30 and m["rmse"] < 0.6 and m["rmse"] < 1.5 * TRACKER_JAX_RMSE
            and st["rmse"] < 1.5 * STEREO_TRACKER_JAX_ATE
            and k["rmse"] < 1.0 and k["rmse"] < 1.5 * KAIST_TRACKER_JAX_ATE):
        raise AssertionError("host trackers: missed tests/test_tracker.py's gates (updates > "
                             "30, RMSE < 0.6 m), 1.5x JAX's, or the KAIST width's ATE < 1.0 m")
    return out


def phase_host_line_tracker(dev):
    """Phase 27, the host line tracker: phase 26's mono scenario (8 s, seed
    2, 350 landmarks, 80 point slots) rendered with its lines, through
    `KltTracker` and `LineTracker` (the anchor walk, 20 lines of >= 30 px)
    into `feed_camera` with the wheel, then again with the point-line-coupled
    rows: RMSE within 1.5x of JAX's driver with JAX's trackers as they ship
    on the CPU, line_accept > 0, no kernel launch (the point tracker's LK is
    the gather form in plain torch); the first run's line tracker held to a
    CPU line tracker fed the same frames and point tracks.  Readings as
    phase 16, plus the trackers' ms a frame and the line tracker's host
    operators a frame."""
    from plviwo_tpu_torch import examples
    from plviwo_tpu_torch.sim.simulator import SimConfig, Simulator
    from plviwo_tpu_torch.update.line_tracker import LineTracker

    out = {}
    for plc, jax_rmse in ((False, LINE_TRACKER_JAX_RMSE), (True, LINE_TRACKER_PLC_JAX_RMSE)):
        tag = "host line tracker" + (" with PLC rows" if plc else "")
        sim = Simulator(SimConfig(duration=8.0, seed=2, n_landmarks=350))
        system, tracker = examples.host_tracker_system(sim, dev, lines=True, wheel=True, plc=plc)
        lines = LineTracker(max_lines=system.opts.cam.max_lines, min_length=30.0, device=dev)
        pt_ms, line_ms, ops, kept = [], [], [], []

        def feed(s, kind, args):
            if kind != "frame":
                return examples.feed(s, kind, args)
            t, img = args
            ids, uvs = tracker.feed(img)
            if len(line_ms) == 10:  # one frame's host operators
                got, n_ops = count_ops(lambda: lines.feed(img, ids, uvs))
                ops.append(n_ops)
            else:
                got = lines.feed(img, ids, uvs)
            pt_ms.append(tracker.last_ms)
            line_ms.append(lines.last_ms)
            if not plc:
                kept.append((img, ids, uvs, got))
            s.feed_camera(t, ids, uvs, *got)

        events = examples.track_events(sim, wheel=True, images=True, lines=True)
        reads0 = lines.host_reads
        r = drive_track(system, events, feed=feed)
        rmse, _ = track_rmse(sim, system)
        n = len(line_ms)
        ms = {k: (float(np.percentile(v, 50)), float(np.percentile(v, 90)))
              for k, v in (("point", pt_ms), ("line", line_ms))}
        track_report(tag, system, r, f"; RMSE {rmse:.4f} m ({rmse / jax_rmse:.3f}x JAX's "
                     f"{jax_rmse:.4f}); {n} frames tracked: point tracker {ms['point'][0]:.3f} / "
                     f"{ms['point'][1]:.3f} ms, line tracker {ms['line'][0]:.3f} / "
                     f"{ms['line'][1]:.3f} ms a frame (p50 / p90), the line tracker's "
                     f"{ops[0]} host operators in the 11th frame and "
                     f"{(lines.host_reads - reads0) / n:.2f} reads a frame")
        if not (system.stats["line_accept"] > 0 and rmse < 1.5 * jax_rmse):
            raise AssertionError(f"{tag}: line_accept {system.stats['line_accept']} or RMSE "
                                 f"{rmse:.4f} m not within 1.5x JAX's {jax_rmse:.4f} m")
        out["plc" if plc else "lines"] = dict(r, rmse=rmse, tracked=n, point_ms=ms["point"],
                                              line_ms=ms["line"], line_ops=ops[0])
        if plc:
            continue
        # the card's line tracker against the CPU's on the same frames and tracks
        cpu = LineTracker(max_lines=system.opts.cam.max_lines, min_length=30.0, device="cpu")
        err, n_lines = 0.0, 0
        for i, (img, ids, uvs, (lids, segs, pids)) in enumerate(kept):
            c_lids, c_segs, c_pids = cpu.feed(img, ids, uvs)
            if not (np.array_equal(lids, c_lids) and len(pids) == len(c_pids)
                    and all(np.array_equal(a, b) for a, b in zip(pids, c_pids))):
                raise AssertionError(f"{tag}: frame {i}: the card's line ids or attached ids "
                                     "differ from the CPU's")
            if len(lids):
                err = max(err, float(np.abs(segs - c_segs).max()))
            n_lines += len(lids)
        print(f"{tag}: card against the CPU on {len(kept)} frames: {n_lines} lines, ids and "
              f"attached ids equal, segments within {err:.3g} px")
        if err > 1e-3:
            raise AssertionError(f"{tag}: segments {err:.3g} px from the CPU's (limit 1e-3)")
    return out


def write_filtered_png(path, img):
    """Write an (H, W) uint8 image as an 8-bit grayscale PNG whose row y is
    filtered with type y % 5 (none, sub, up, average, Paeth), as adaptive
    encoders mix them: the decoder's general path, which the fixture's
    filter-0 files never take."""
    import struct
    import zlib

    H, W = img.shape
    x = img.astype(np.int64)
    a = np.pad(x, ((0, 0), (1, 0)))[:, :-1]  # left
    b = np.pad(x, ((1, 0), (0, 0)))[:-1]  # up
    c = np.pad(x, ((1, 0), (1, 0)))[:-1, :-1]  # up-left
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    ftype = np.arange(H) % 5
    pred = np.stack([np.zeros_like(x), a, b, (a + b) >> 1, paeth])[ftype[:, None],
                                                                    np.arange(H)[:, None],
                                                                    np.arange(W)]
    raw = np.concatenate([ftype[:, None], (x - pred) & 0xFF], 1).astype(np.uint8).tobytes()

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 0, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def png_decode_ms(root):
    """The port's PNG reader on a KAIST-sized frame (1280 x 560 gray) written
    with all five row filters: the median ms of 5 reads, held equal to the
    image written."""
    from plviwo_tpu_torch.data import png

    rng = np.random.default_rng(0)
    y, x = np.mgrid[:560, :1280]
    img = ((np.sin(x / 7.0) + np.cos(y / 5.0)) * 60 + 128 + rng.normal(0, 8, y.shape)).clip(
        0, 255).astype(np.uint8)
    path = Path(root) / "filtered_1280x560.png"
    write_filtered_png(path, img)
    ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        got = png.read_gray(path)
        ms.append(1e3 * (time.perf_counter() - t0))
        if not np.array_equal(got, img):
            raise AssertionError("PNG decode: the filtered 1280 x 560 frame read back differs")
    return float(np.median(ms))


def phase_kaist_replay(dev):
    """Phase 28, `run_kaist` on a fixture written here: the port's
    `generate_kaist_fixture` at tests/test_kaist_e2e.py::test_run_kaist_e2e's
    settings (SimConfig(duration=16, n_landmarks=350, n_lines=40, 640 x 480,
    seed=5), t_start 1 s, 12 s at 8 Hz) with that test's layered config
    (`write_fixture_config`), replayed with --wheel --lines on the card with
    both launch counts set to 0 and every synchronizing call counted: that
    test's gates, ATE within 1.5x of JAX's run_kaist on the CPU, no kernel
    launch (the tracker's LK is the gather form in plain torch), the native
    feature store taken.  Returns readings."""
    import importlib.util
    import tempfile
    import warnings

    import torch

    from plviwo_tpu_torch import run_kaist
    from plviwo_tpu_torch.ops import lk_kernel
    from plviwo_tpu_torch.ops.msckf_kernel import gram_gate
    from plviwo_tpu_torch.sim.kaist_fixture import generate_kaist_fixture, write_fixture_config
    from plviwo_tpu_torch.sim.simulator import SimConfig, Simulator

    have = {name: importlib.util.find_spec(mod) is not None
            for name, mod in (("PyYAML", "yaml"), ("Pillow", "PIL"))}
    print("KAIST replay: " + ", ".join(f"{k} {'installed' if v else 'not installed'}"
                                       for k, v in have.items())
          + " (the port reads its YAML and PNG files without them)")
    with tempfile.TemporaryDirectory() as root:
        sim = Simulator(SimConfig(duration=16.0, n_landmarks=350, n_lines=40, width=640,
                                  height=480, seed=5))
        t0 = time.perf_counter()
        man = generate_kaist_fixture(root, sim, t_start=1.0, duration=12.0, cam_hz=8.0)
        gen_s = time.perf_counter() - t0
        master = write_fixture_config(root, sim.cfg)
        args = run_kaist._parser().parse_args(["--root", root, "--config", master, "--wheel",
                                               "--lines", "--device", str(dev)])
        torch.cuda.synchronize()
        lk_kernel.lk_pyramid.launches = 0
        gram_gate.launches = 0
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                summary, system, ms = run_kaist.replay(args)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        decode_ms = png_decode_ms(root)
    launches = {"lk_pyramid": lk_kernel.lk_pyramid.launches,
                "msckf_gram_gate": gram_gate.launches}
    syncs = sum(1 for w in caught if "synchroniz" in str(w.message))
    n, ate = summary["frames"], summary.get("ate_rmse_m")
    split = "; ".join(f"{k} {v['p50']:.3f} / {v['p90']:.3f} ms"
                      for k, v in summary["frame_ms"].items())
    print(f"KAIST replay ({man['images']} images written in {gen_s:.1f} s): {summary}; "
          f"launches {launches}; per frame (p50 / p90): {split}; syncs per frame "
          f"{syncs / n:.2f}; stats {system.stats}")
    want = {"lk_pyramid": 0, "msckf_gram_gate": 0}
    if launches != want or summary["feature_store"] != "native":
        raise AssertionError(f"KAIST replay: launches {launches} (want {want}) or feature "
                             f"store {summary['feature_store']} (want native)")
    if not (n >= 90 and summary["clones"] > 50 and summary["updates"] > 30 and ate is not None
            and np.isfinite(ate) and ate < 1.0 and ate < 1.5 * KAIST_REPLAY_JAX_ATE):
        raise AssertionError("KAIST replay: missed tests/test_kaist_e2e.py's gates (frames >= "
                             "90, clones > 50, updates > 30, ATE < 1.0 m) or 1.5x JAX's ATE "
                             f"{KAIST_REPLAY_JAX_ATE:.4f} m")
    print(f"KAIST replay: ATE {ate:.4f} m ({ate / KAIST_REPLAY_JAX_ATE:.3f}x JAX's)")
    print(f"PNG decode: a 1280 x 560 gray frame with all five row filters (real KAIST frames' "
          f"size and encoding) {decode_ms:.3f} ms a read (median of 5), equal to the image "
          f"written; the fixture's 640 x 480 filter-0 frames "
          f"{summary['frame_ms']['decode']['p50']:.3f} ms p50")
    return dict(summary, launches=launches, syncs_per_frame=syncs / n,
                decode_1280x560_ms=decode_ms)


def paint_tag(img, bitmap, cx, cy, s, theta=0.0, ss=4):
    """Paint a tag bitmap (8 px a cell) into img centered at (cx, cy) at s px
    a cell, rotated by theta, with ss x ss supersampled edges (the painter
    of tests/test_aruco.py)."""
    cell = 8
    n = bitmap.shape[0] / cell
    H, W = img.shape
    off = (np.arange(ss) + 0.5) / ss - 0.5
    acc = np.zeros((H, W))
    cov = np.zeros((H, W))
    ct, st = np.cos(theta), np.sin(theta)
    ys, xs = np.meshgrid(np.arange(H, dtype=float), np.arange(W, dtype=float), indexing="ij")
    for oy in off:
        for ox in off:
            X, Y = xs + ox - cx, ys + oy - cy
            u, v = (ct * X + st * Y) / s, (-st * X + ct * Y) / s
            inside = (np.abs(u) < n / 2) & (np.abs(v) < n / 2)
            bi = np.clip(((v + n / 2) * cell).astype(int), 0, bitmap.shape[0] - 1)
            bj = np.clip(((u + n / 2) * cell).astype(int), 0, bitmap.shape[1] - 1)
            acc += np.where(inside, bitmap[bi, bj], 0.0)
            cov += inside
    w = cov / (ss * ss)
    img[:] = (1 - w) * img + w * np.where(cov > 0, acc / np.maximum(cov, 1), 0)
    return img


def tag_frames():
    """Three painted 640 x 480 frames: one tag axis-aligned, one rotated,
    two at different scales; [(image, [(tag, cx, cy, s, theta)])]."""
    from plviwo_tpu_torch.ops import aruco

    codes = aruco.tag_family()
    scenes = [[(3, 320.3, 240.7, 5.0, 0.0)], [(7, 200.0, 260.0, 6.0, 0.9)],
              [(0, 160.0, 120.0, 4.6, 0.0), (12, 460.0, 340.0, 6.8, 0.3)]]
    out = []
    for seed, tags in enumerate(scenes):
        rng = np.random.default_rng(seed)
        img = np.clip(0.55 + 0.06 * rng.normal(size=(480, 640)), 0, 1)
        for tag, cx, cy, s, theta in tags:
            paint_tag(img, aruco.tag_bitmap(codes[tag]), cx, cy, s, theta)
        out.append((img.astype(np.float32), tags))
    return out


def tag_run(dev):
    """run_sim --tags --duration 8 --seed 2 on the card with both launch
    counts set to 0, the ArUco tracker's ms a frame recorded.  Returns
    (summary, launches, [ms a frame])."""
    import contextlib
    import io

    import torch

    from plviwo_tpu_torch import run_sim
    from plviwo_tpu_torch.ops import lk_kernel
    from plviwo_tpu_torch.ops.msckf_kernel import gram_gate
    from plviwo_tpu_torch.update import aruco_tracker

    feed, ms = aruco_tracker.ArucoTracker.feed, []

    def timed_feed(self, img):
        out = feed(self, img)
        ms.append(self.last_ms)
        return out

    torch.cuda.synchronize()
    lk_kernel.lk_pyramid.launches = 0
    gram_gate.launches = 0
    aruco_tracker.ArucoTracker.feed = timed_feed
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rc = run_sim.main(["--tags", "--duration", "8", "--seed", "2", "--device", str(dev)])
    finally:
        aruco_tracker.ArucoTracker.feed = feed
    summary = json.loads(buf.getvalue().strip().splitlines()[-1])
    if rc != 0:
        raise AssertionError(f"run_sim --tags: exit {rc}: {summary}")
    return summary, {"lk_pyramid": lk_kernel.lk_pyramid.launches,
                     "msckf_gram_gate": gram_gate.launches}, ms


def phase_tags(dev):
    """Phase 29, fiducial tags: (a) the detector (`ops/aruco.TagDetector`)
    on three painted 640 x 480 frames, the card against the CPU (valid
    masks, ids and bit counts equal, corners within 1e-3 px) and both
    against the painted corners (< 1.8 px); the NCC volume on the card with
    cuDNN's TF32 switched on globally, held to a float64 CPU correlation
    within 1e-4 (TF32 would be ~1e-3 off: the bank pins FP32); (b)
    tests/test_aruco.py::test_sim_ground_tags_detected_and_world_consistent
    on the card: >= 8 corner hits, median reprojection < 1.5 px, max < 4 px;
    (c) run_sim --tags --duration 8 --seed 2: ATE < 1.0 m (JAX's gate), set
    beside JAX's TAGS_JAX_ATE, no kernel launch.  Readings: the NCC bank's
    and the whole detector's ms a frame (CUDA events, 640 x 480), the
    ArUco tracker's host ms a frame in the replay."""
    import torch
    import torch.nn.functional as F

    from plviwo_tpu_torch.ops import aruco, lie
    from plviwo_tpu_torch.ops import cam as cam_ops
    from plviwo_tpu_torch.sim.simulator import SimConfig, Simulator
    from plviwo_tpu_torch.update.aruco_tracker import ArucoTracker

    card, cpu = aruco.TagDetector(device=dev), aruco.TagDetector(device="cpu")
    err = 0.0
    frames = tag_frames()
    for i, (img, tags) in enumerate(frames):
        got = {k: v.cpu().numpy() for k, v in card.detect(img).items()}
        want = {k: v.numpy() for k, v in cpu.detect(img).items()}
        ok = want["valid"]
        if not (np.array_equal(got["valid"], ok) and np.array_equal(got["tag_id"][ok],
                                                                     want["tag_id"][ok])
                and np.array_equal(got["n_match"][ok], want["n_match"][ok])):
            raise AssertionError(f"tags: frame {i}: the card's detections differ from the CPU's")
        if sorted(int(t) for t in got["tag_id"][ok]) != sorted(t[0] for t in tags):
            raise AssertionError(f"tags: frame {i}: ids {got['tag_id'][ok]}, painted {tags}")
        err = max(err, float(np.abs(got["corners"][ok] - want["corners"][ok]).max()))
        for tag, cx, cy, s, theta in tags:
            j = int(np.nonzero(ok & (got["tag_id"] == tag))[0][0])
            c = np.array([[-3.0, -3.0], [3.0, -3.0], [3.0, 3.0], [-3.0, 3.0]]) * s
            R = np.array([[np.cos(theta), -np.sin(theta)], [np.sin(theta), np.cos(theta)]])
            gt_err = np.linalg.norm(got["corners"][j] - (np.array([cx, cy]) + c @ R.T), axis=-1)
            if gt_err.max() > 1.8:
                raise AssertionError(f"tags: frame {i} tag {tag}: corners {gt_err.max():.3f} px "
                                     "from the painted ones (limit 1.8)")
    if err > 1e-3:
        raise AssertionError(f"tags: corners {err:.3g} px from the CPU's (limit 1e-3)")
    x = torch.as_tensor(frames[2][0], device=dev)[None]
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        ncc = aruco.ncc_stack(x, card.bank_T)
        ncc_ms = cuda_ms(lambda: aruco.ncc_stack(x, card.bank_T), n_iter=10)
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    det_ms = cuda_ms(lambda: card.detect_batch(x), n_iter=10)
    ref = []  # the same correlations in float64 (no TF32 there), one call per scale
    xd = x.double()[:, None]
    for T in card.bank_T:
        K = T.shape[-1]
        num = F.conv2d(xd, T.double()[:, None], padding=K // 2)
        w = torch.full((1, 1, K, K), 1.0 / (K * K), dtype=torch.float64, device=dev)
        mean = F.conv2d(xd, w, padding=K // 2)
        mean2 = F.conv2d(xd * xd, w, padding=K // 2)
        ref.append(num / (torch.sqrt(torch.clamp(mean2 - mean * mean, min=1e-8)) * K))
    ncc_err = float((ncc[0].double() - torch.stack(ref, 1)[0]).abs().max())
    print(f"tags: the detector on 3 painted 640 x 480 frames, card against CPU: detections "
          f"equal, corners within {err:.3g} px; NCC bank (3 scales x 12 angles, K = "
          f"{[int(T.shape[-1]) for T in card.bank_T]}) with TF32 on globally: {ncc_err:.3g} from "
          f"a float64 correlation; NCC {ncc_ms:.3f} ms, whole detector {det_ms:.3f} ms a "
          f"640 x 480 frame (CUDA events)")
    if not ncc_err < 1e-4:
        raise AssertionError(f"tags: NCC {ncc_err:.3g} from float64 (limit 1e-4): not FP32")

    # (b) the ground tags seen from above, world-consistent
    cfg = SimConfig(duration=8.0, seed=3, n_tags=5, tag_size=0.5, width=320, height=240,
                    intrinsics=(300.0, 300.0, 160.0, 120.0, 0.0, 0.0, 0.0, 0.0),
                    cam_ext_q=(1.0, 0.0, 0.0, 0.0), cam_ext_p=(0.0, 0.0, 0.0))
    sim = Simulator(cfg)
    tracker = ArucoTracker(max_tag_id=16, device=dev)
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
            uv_gt = cam_ops.project(torch.as_tensor(p_C[None]), k, cam_ops.RADTAN).numpy()[0]
            errs.append(float(np.linalg.norm(uv - uv_gt)))
    errs = np.asarray(errs)
    print(f"tags: ground tags (nadir, 320 x 240): {len(errs)} corner hits, reprojection median "
          f"{np.median(errs) if len(errs) else float('nan'):.3f} px, max "
          f"{errs.max() if len(errs) else float('nan'):.3f} px")
    if not (len(errs) >= 8 and np.median(errs) < 1.5 and errs.max() < 4.0):
        raise AssertionError("tags: missed tests/test_aruco.py's ground-tag gates (>= 8 hits, "
                             "median < 1.5 px, max < 4 px)")

    # (c) the replay
    summary, launches, ms = tag_run(dev)
    ate = summary["ate_rmse_m"]
    print(f"tags: run_sim --tags --duration 8 --seed 2 on the card: {summary}; launches "
          f"{launches}; ATE {ate} m ({ate / TAGS_JAX_ATE:.3f}x JAX's {TAGS_JAX_ATE:.4f}); ArUco "
          f"tracker {np.percentile(ms, 50):.3f} / {np.percentile(ms, 90):.3f} ms a frame "
          f"(p50 / p90, host clock, its read included)")
    if launches != {"lk_pyramid": 0, "msckf_gram_gate": 0}:
        raise AssertionError(f"tags: launches {launches}, want none")
    if not (ate is not None and ate < 1.0):
        raise AssertionError(f"tags: ATE {ate} m (JAX's gate: < 1.0 m)")
    return dict(ate=ate, ncc_ms=ncc_ms, detect_ms=det_ms, ncc_err=ncc_err,
                aruco_p50_ms=float(np.percentile(ms, 50)), hits=len(errs))


def phase_desc_tracker(dev):
    """Phase 30, the descriptor tracker: tests/test_descriptor.py::
    test_desc_tracker_e2e's scenario (8 s, seed 2, 45 landmarks a frame;
    `DescTracker` with 80 slots) into `feed_camera` on the card, with both
    launch counts set to 0: JAX's gates (cam_accept > 10, RMSE < 1.0 m),
    the RMSE beside JAX's DESC_JAX_RMSE, no kernel launch.  Readings: the
    tracker's host ms a frame (p50 / p90, its read included) and its device
    reads a frame."""
    import torch

    from plviwo_tpu_torch import examples
    from plviwo_tpu_torch.ops import lk_kernel
    from plviwo_tpu_torch.ops.msckf_kernel import gram_gate

    ms = []
    torch.cuda.synchronize()
    lk_kernel.lk_pyramid.launches = 0
    gram_gate.launches = 0
    rmse, stats, system, tracker = examples.desc_tracker_vio(
        device=dev, frame_hook=lambda tr: ms.append(tr.last_ms))
    launches = {"lk_pyramid": lk_kernel.lk_pyramid.launches, "msckf_gram_gate": gram_gate.launches}
    n = len(ms)
    print(f"descriptor tracker (N=80) on the card: stats {stats}; RMSE {rmse:.4f} m "
          f"({rmse / DESC_JAX_RMSE:.3f}x JAX's {DESC_JAX_RMSE:.4f}); {n} frames, tracker "
          f"{np.percentile(ms, 50):.3f} / {np.percentile(ms, 90):.3f} ms a frame (p50 / p90), "
          f"{tracker.host_reads / n:.2f} reads a frame; launches {launches}")
    if launches != {"lk_pyramid": 0, "msckf_gram_gate": 0}:
        raise AssertionError(f"descriptor tracker: launches {launches}, want none")
    if not (stats["cam_accept"] > 10 and rmse < 1.0):
        raise AssertionError("descriptor tracker: missed tests/test_descriptor.py's gates "
                             "(cam_accept > 10, RMSE < 1.0 m)")
    return dict(rmse=rmse, tracker_p50_ms=float(np.percentile(ms, 50)),
                reads_per_frame=tracker.host_reads / n)


def phase_record_viz_eval(dev):
    """Phase 31, the recorder, viz, the eval CLI and checkpoints on the card:
    (a) run_sim --wheel --lines --duration 4 --record --viz-dir and run_sim
    --images --duration 2 --record --viz-dir, then `eval ate`, `rpe` and
    `nees` over the first's files (its recorded ground truth as the
    reference): est/std/gt rows one a frame, finite NEES, MSCKF points and
    lines in the PLY dumps, one overlay a frame of the images-in run; (b) a
    checkpoint halfway through run_sim --wheel's stream, resumed on the card:
    the trajectory and stats equal to the unbroken run's, bit for bit; (c)
    the syncs a frame of that stream with the recorder and viz off and on
    (sync debug mode)."""
    import contextlib
    import io
    import os
    import tempfile

    from plviwo_tpu_torch import examples, run_sim
    from plviwo_tpu_torch.config.options import EstimatorOptions
    from plviwo_tpu_torch.core.system import VioSystem
    from plviwo_tpu_torch.eval.__main__ import main as eval_main
    from plviwo_tpu_torch.eval.loader import save_tum
    from plviwo_tpu_torch.sim.simulator import SimConfig, Simulator
    from plviwo_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
    from plviwo_tpu_torch.utils.recorder import StateRecorder
    from plviwo_tpu_torch.utils.viz import VizRecorder

    def run(main, argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = main(argv)
        if rc != 0:
            raise AssertionError(f"{argv[:2]}: exit {rc}")
        return json.loads(buf.getvalue().strip().splitlines()[-1])

    out = {}
    with tempfile.TemporaryDirectory() as d:
        for tag, argv in (("tracks", ["--wheel", "--lines", "--duration", "4"]),
                          ("images", ["--images", "--duration", "2"])):
            rec, vd = os.path.join(d, tag), os.path.join(d, tag + "_viz")
            summary = run(run_sim.main, argv + ["--record", rec, "--viz-dir", vd, "--device",
                                                str(dev)])
            n = summary["frames"]
            rows = {k: np.loadtxt(os.path.join(rec, f"state_{k}.txt")) for k in ("est", "std",
                                                                                   "gt")}
            viz = json.load(open(os.path.join(vd, "viz_summary.json")))
            if any(len(v) != n for v in rows.values()):
                raise AssertionError(f"record/viz ({tag}): {n} frames, rows "
                                     f"{ {k: len(v) for k, v in rows.items()} }")
            out[tag] = dict(frames=n, viz=viz)
            if tag == "images":
                if viz["overlays"] != n:
                    raise AssertionError(f"record/viz: {viz['overlays']} overlays for {n} frames")
                continue
            gt = rows["gt"]
            gt_path = os.path.join(d, "gt.txt")
            save_tum(gt_path, gt[:, 0], gt[:, 5:8], gt[:, 1:5])
            traj = os.path.join(rec, "trajectory.txt")
            ate = run(eval_main, ["ate", traj, gt_path, "--align", "none"])
            rpe = run(eval_main, ["rpe", traj, gt_path, "--segments", "2,4"])
            nees = run(eval_main, ["nees", rec])
            out[tag].update(ate=ate["pos"]["rmse"], rpe_4m=rpe["4.0"]["pos"]["mean"],
                            pos_nees=nees["pos_nees"]["mean"], ori_nees=nees["ori_nees"]["mean"])
            print(f"record/viz: run_sim --wheel --lines --duration 4 on the card: {n} frames, "
                  f"viz {viz}; eval ate {ate['pos']['rmse']:.4f} m (run_sim's "
                  f"{summary['ate_rmse_m']}), rpe over 4 m {rpe['4.0']['pos']['mean']:.4f} m "
                  f"(n {rpe['4.0']['pos']['n']}), NEES position {nees['pos_nees']['mean']:.3f}, "
                  f"orientation {nees['ori_nees']['mean']:.3f}")
            if not (viz.get("msckf_points", 0) > 0 and viz.get("lines", 0) > 0
                    and abs(ate["pos"]["rmse"] - summary["ate_rmse_m"]) < 1e-3
                    and np.isfinite(nees["pos_nees"]["mean"])):
                raise AssertionError(f"record/viz: viz {viz}, ATE {ate['pos']['rmse']} against "
                                     f"run_sim's {summary['ate_rmse_m']}, NEES {nees}")
        print(f"record/viz: run_sim --images --duration 2 on the card: {out['images']}")

        # (b) checkpoint halfway, resumed on the card
        sim = Simulator(SimConfig(duration=8.0, seed=3, sigma_pix=0.5, n_pts=45))
        o = run_sim_options(EstimatorOptions(), wheel=True)
        events = examples.track_events(sim, wheel=True)

        def make():
            s = VioSystem(o, device=dev)
            examples.live_calibrate(s, sim, float(sim.imu_t[0]))
            return s

        a = make()
        half = len(events) // 2
        for kind, args in events[:half]:
            examples.feed(a, kind, args)
        path = os.path.join(d, "ck.pkl")
        t0 = time.perf_counter()
        save_checkpoint(path, a)
        b = load_checkpoint(path, device=dev)
        ck_ms = 1e3 * (time.perf_counter() - t0)
        for kind, args in events[half:]:
            examples.feed(a, kind, args)
            examples.feed(b, kind, args)
        same = (len(a.traj) == len(b.traj) and a.stats == b.stats
                and all(ta == tb and np.array_equal(pa, pb) and np.array_equal(qa, qb)
                        for (ta, qa, pa), (tb, qb, pb) in zip(a.traj, b.traj)))
        print(f"checkpoint: saved and loaded at {half} of {len(events)} events in {ck_ms:.1f} ms "
              f"({os.path.getsize(path) / 1e6:.2f} MB); the resumed run's {len(b.traj)} poses "
              f"and stats {'equal' if same else 'DIFFER from'} the unbroken run's")
        if not same:
            raise AssertionError("checkpoint: the resumed run differs from the unbroken run")

        # (c) syncs a frame, recorder and viz off and on
        syncs = {}
        for mode in ("off", "on"):
            s = make()
            rec = StateRecorder(os.path.join(d, "sync_" + mode)) if mode == "on" else None
            if mode == "on":
                s.viz = VizRecorder(os.path.join(d, "sync_viz"))
            r = drive_track(s, events, per_frame=(lambda s_: rec.record(s_)) if rec else None)
            syncs[mode] = r["syncs_per_frame"]
        print(f"syncs a frame on run_sim --wheel's 8 s stream: recorder and viz off "
              f"{syncs['off']:.2f}, on {syncs['on']:.2f}")
        out.update(checkpoint_ms=ck_ms, syncs=syncs)
    return out


def recorded(fn, n_gram, keep_rank, *, group, **kwargs):
    """fn(group=group, **kwargs) in a rank of phase 32 under `recording`:
    (fn's result, on rank keep_rank the arguments of its last n_gram
    gate/Gram calls and of its last LK call, else None)."""
    capture = {}
    with recording(capture, n_gram=n_gram):
        out = fn(group=group, **kwargs)
    return out, (capture if group.rank == keep_rank else None)


def dryrun_next_frame(*, group):
    """The dry run's sharded images-in frame (`dryrun._frame_batch`) and the
    frame after it, each rank its shard: (tracked, on rank 0 the arguments
    of the second frame's calls, whose LK tracks the corners the first
    detected, else None)."""
    from plviwo_tpu_torch.core.frame import fused_frame
    from plviwo_tpu_torch.parallel import dryrun, replay

    sl = replay.shard_slice(group, group.world)
    frames = [dryrun._frame_batch(group.world, group.device, t) for t in (1.0, 1.1)]
    state, ts = (replay.take_shard(group, x, sl) for x in frames[0][:2])
    capture = {}
    for i, (_, _, args, rest, kw) in enumerate(frames):
        shard = [replay.take_shard(group, a, sl) for a in args]
        with recording(capture) if i else contextlib.nullcontext():
            state, ts, m = replay.step_no_lone(fused_frame, 2 + len(shard), state, ts, *shard,
                                               *rest, **kw)
    return int(m["tracked"].sum()), (capture if group.rank == 0 else None)


def replay_unpaired(*, group, **kwargs):
    """`batch_replay.replay_rank` with a lone sequence stepped alone: the
    lone path that `replay.step_no_lone` replaces on the card by a pair."""
    from plviwo_tpu_torch.parallel import batch_replay, replay

    paired = replay.step_no_lone
    replay.step_no_lone = lambda fn, n_batched, *args, **kw: fn(*args, **kw)
    try:
        return batch_replay.replay_rank(group=group, **kwargs)
    finally:
        replay.step_no_lone = paired


def on_card(x, dev):
    """x with every numpy array (as a rank returns its tensors) a tensor on dev."""
    import torch

    if isinstance(x, np.ndarray):
        return torch.as_tensor(x).to(dev)
    if isinstance(x, (list, tuple)):
        return type(x)(on_card(v, dev) for v in x)
    if isinstance(x, dict):
        return {k: on_card(v, dev) for k, v in x.items()}
    return x


# phase 32's paths in the kernels' launches_by_path: launches summed over every rank of
# the dry runs at world 2 and 4 (the sharded step, the sharded frame) and of config 5 at
# 4 ranks and at 1
DISTRIBUTED_PATHS = ("sharded_step", "dryrun_fused_frame", "batch_replay")
# config 5's first sequence alone at 1 rank: stepped alone (`replay_unpaired`) and as a
# pair (`replay.step_no_lone`), lone, pair, pair, lone: what the pairing costs the card
C5_ONE = dict(C5, n_seq=1)


def phase_distributed(dev):
    """Phase 32, the distributed layer (`plviwo_tpu_torch/parallel`) on the one
    card, its ranks child processes of this script sharing the card over Gloo
    (world 1 runs here, over NCCL: one rank, one card); one process start per
    world for all of its jobs:
    (a) the dry run (`parallel.dryrun`) at world 2 and 4: the sharded full
    step and images-in frame within 1e-9 of one process (bit for bit
    printed), 2 gate/Gram launches per rank in the step, 1 LK and 2
    gate/Gram in the frame; at world 4 both kernels against their plain
    versions on a rank's own arguments: the step's two gate/Gram calls and
    the frame's two (rank 1: rank 0 also runs the one-process references),
    and the LK call of the frame after it (`dryrun_next_frame`: the dry
    run's one frame has nothing to track yet);
    (b) `python -m plviwo_tpu_torch.parallel.multiproc_worker` at world 2:
    each shard within 1e-9 of its B = 1 run (bit for bit printed);
    (c) config 5 (`parallel.batch_replay`, C5) at 4 ranks and at 1: the
    trajectories within 1e-9 m of each other and the ATEs equal to the digits
    printed; accepted > 200, lines_accepted > 40; each ate_before_m < 1.0 and
    within 1.5x of JAX's; each ate_after_m <= 1.15 ate_before_kf_m; the last
    BA gain < 1e-2 the first; on every rank 2 gate/Gram launches a frame and
    no LK; gate/Gram against its plain version on the newest point and line
    calls that accept some features and reject others, at 4 ranks (rank 0,
    its sequence as a pair) and at 1 (B = 4); the replay's wall time, the
    BA's ms a sequence; C5_ONE stepped alone and as a pair: the pairing's
    replay time against the lone path's, the paired trajectory equal to the
    4-rank run's sequence 0 within 1e-9 m, how far the lone one ends from it;
    (d) `parallel.scaling` at 1, 2 and 4 ranks with the unsharded control:
    readings, finite and positive.
    Returns the launches of each path, the kernel checks and the readings."""
    import math
    import tempfile

    from plviwo_tpu_torch.parallel import batch_replay, dryrun, scaling
    from plviwo_tpu_torch.parallel.replay import run_rank_jobs

    n_frames = int((C5["duration"] - 1.0) * 10.0) - 1
    n_keep = 2 * LIVE_KEEP  # the replay's last 10 frames' gate/Gram calls
    table = {"dryrun": (dryrun.dryrun_rank, (), None),
             "dryrun_recorded": (recorded, (dryrun.dryrun_rank, 4, 1), None),
             "next_frame": (dryrun_next_frame, (), None),
             "replay": (recorded, (batch_replay.replay_rank, n_keep, 0), C5),
             "lone": (replay_unpaired, (), C5_ONE), "pair": (batch_replay.replay_rank, (), C5_ONE),
             "scaling": (scaling.measure_rank, (), None)}
    worlds = {}
    t0 = time.perf_counter()
    for world, jobs in ((4, ("dryrun_recorded", "next_frame", "replay", "scaling")),
                        (2, ("dryrun", "scaling")),
                        (1, ("replay", "lone", "pair", "pair", "lone", "scaling"))):
        t1 = time.perf_counter()
        res = run_rank_jobs([table[j] for j in jobs], world, device="cuda", timeout=600.0)
        worlds[world] = {}
        for i, j in enumerate(jobs):
            worlds[world].setdefault(j, []).append([r[i] for r in res])
        print(f"distributed: world {world} ({', '.join(jobs)}) in "
              f"{time.perf_counter() - t1:.1f} s, process start included")

    out = {"launches": {}, "kernels": {}}
    # (a) the dry run
    dry = {2: worlds[2]["dryrun"][0], 4: [r[0] for r in worlds[4]["dryrun_recorded"][0]]}
    for world in (2, 4):
        ranks = dry[world]
        s, f = ranks[0]["step"], ranks[0]["frame"]
        for r in ranks:
            want = ({"lk_pyramid": 0, "msckf_gram_gate": 2}, {"lk_pyramid": 1, "msckf_gram_gate": 2})
            got = (r["step"]["launches"], r["frame"]["launches"])
            if got != want:
                raise AssertionError(f"dry run, world {world}, rank {r['step']['rank']}: "
                                     f"launches {got}, want {want}")
            if r["step"]["device"] != str(dev) or r["step"]["backend"] != "gloo":
                raise AssertionError(f"dry run rank on {r['step']['device']} over "
                                     f"{r['step']['backend']}")
        print(f"dryrun_multichip({world}) on the card: agg {s['agg']}, |dp| {s['dp']:.3e}, "
              f"|dcov| {s['dcov']:.3e}, bit for bit {s['bitwise']}; fused frame tracked "
              f"{f['tracked']}, |dp| {f['dp']:.3e}, bit for bit {f['bitwise']}; backend "
              f"{s['backend']}, launches per rank: step {s['launches']}, frame {f['launches']}")
        out[f"dryrun_{world}"] = {"step_bitwise": s["bitwise"], "frame_bitwise": f["bitwise"],
                                  "dp": s["dp"], "dcov": s["dcov"], "frame_dp": f["dp"]}
    for k in ("msckf_gram_gate", "lk_pyramid"):
        out["launches"][("sharded_step", k)] = sum(
            r["step"]["launches"][k] for w in (2, 4) for r in dry[w])
        out["launches"][("dryrun_fused_frame", k)] = sum(
            r["frame"]["launches"][k] for w in (2, 4) for r in dry[w])

    def shape(args):
        return "x".join(str(n) for n in args[0].shape)

    # the kernels on the dry run's own arguments (world 4): the calls of the step and
    # frame accept all or none of their few features, so no mix is asked of them
    calls = on_card(worlds[4]["dryrun_recorded"][0][1][1], dev)["gram_gate"]
    if len(calls) != 4:
        raise AssertionError(f"dry run rank 1 recorded {len(calls)} gate/Gram calls, want 4")
    for name, args in zip(("sharded_step_points", "sharded_step_lines", "sharded_frame_points",
                           "sharded_frame_lines"), calls):
        out["kernels"][name] = phase_gram(f"dry run (world 4, rank 1), {name.replace('_', ' ')} "
                                          f"{shape(args)}", args, mixed=False)
    tracked, cap = worlds[4]["next_frame"][0][0]
    out["kernels"]["next_frame_lk"] = phase_lk(
        f"dry run's next frame (world 4, rank 0, tracked {tracked})", on_card(cap["lk"], dev))

    # (b) the worker, one process per rank, as a user starts it
    with tempfile.TemporaryDirectory() as tmp:
        init = (Path(tmp) / "rendezvous").as_uri()
        cmd = [sys.executable, "-m", "plviwo_tpu_torch.parallel.multiproc_worker"]
        procs = [subprocess.Popen(cmd + [str(r), "2", init], cwd=Path(__file__).resolve().parent,
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for r in range(2)]
        try:
            outs = [(p.communicate(timeout=300)[0], p.returncode) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    for text, rc in outs:
        lines = [ln for ln in text.splitlines() if ln.startswith("{")]
        if rc != 0 or not lines:
            raise AssertionError(f"multiproc_worker exited {rc}: {text[-2000:]}")
        w = json.loads(lines[-1])
        if not (w["max_abs_dp"] < 1e-9 and w["accepted"] > 0 and w["device"] == str(dev)):
            raise AssertionError(f"multiproc_worker: {w}")
        print(f"multiproc_worker rank {w['pid']} of {w['global_devices']}: accepted "
              f"{w['accepted']}, rows {w['rows']}, |dp| {w['max_abs_dp']:.3e}, bit for bit "
              f"{w['shard_equal']}, backend {w['backend']} on {w['device']}")

    # (c) config 5 at 4 ranks against 1
    ((rep4, traj4), cap4), ((rep1, traj1), cap1) = (worlds[n]["replay"][0][0] for n in (4, 1))
    dtraj = float(np.max(np.abs(traj4 - traj1)))
    if not dtraj < 1e-9:
        raise AssertionError(f"config 5: 4 ranks and 1 rank differ by {dtraj:.3e} m")
    want = {"lk_pyramid": 0, "msckf_gram_gate": 2 * n_frames}
    for rep in (rep4, rep1):
        seqs = rep["sequences"]
        if not (rep["accepted"] > 200 and rep["lines_accepted"] > 40 and len(seqs) == 4):
            raise AssertionError(f"config 5 at {rep['devices']} ranks: {rep}")
        for s, jax_ate in zip(seqs, C5_JAX_ATE_BEFORE):
            g = s["ba_gain"]
            ok = (s["ate_before_m"] < 1.0 and s["ate_before_m"] < 1.5 * jax_ate
                  and s["ate_after_m"] is not None
                  and s["ate_after_m"] <= 1.15 * s["ate_before_kf_m"] and g[-1] < 1e-2 * g[0])
            if not ok:
                raise AssertionError(f"config 5 at {rep['devices']} ranks: {s} (JAX's "
                                     f"ate_before_m {jax_ate})")
        if any(n != want for n in rep["launches_per_rank"]):
            raise AssertionError(f"config 5: launches per rank {rep['launches_per_rank']}, "
                                 f"want {want}")

    def ates(rep):
        return [f"{s[k]:.6f}" for s in rep["sequences"]
                for k in ("ate_before_m", "ate_before_kf_m", "ate_after_m")]

    if ates(rep4) != ates(rep1):
        raise AssertionError(f"config 5 ATEs differ: {ates(rep4)} vs {ates(rep1)}")
    for rep in (rep4, rep1):
        print(f"config 5 at {rep['devices']} rank(s), backend {rep['backend']} on "
              f"{rep['device']}: accepted {rep['accepted']}, lines {rep['lines_accepted']}; "
              f"ATE before / before (keyframes) / after BA: " + "; ".join(
                  f"{s['ate_before_m']:.6f} / {s['ate_before_kf_m']:.6f} / "
                  f"{s['ate_after_m']:.6f} m" for s in rep["sequences"])
              + f" (JAX before: {', '.join(f'{a:.6f}' for a in C5_JAX_ATE_BEFORE)}); replay "
              f"{rep['replay_s']:.3f} s for {n_frames} frames; BA ms a sequence "
              + ", ".join(f"{s['ba_ms']:.3f}" for s in rep["sequences"])
              + f"; launches per rank {rep['launches_per_rank']}")
    print(f"config 5: 4 ranks vs 1 rank, max |dp| over the trajectories {dtraj:.3e} m")
    for k in ("msckf_gram_gate", "lk_pyramid"):
        out["launches"][("batch_replay", k)] = sum(
            r[k] for rep in (rep4, rep1) for r in rep["launches_per_rank"])
    # gate/Gram on the replay's own arguments: a rank's pair (4 ranks) and B = 4 (1 rank)
    for tag, cap in (("4_ranks", cap4), ("1_rank", cap1)):
        calls = on_card(cap["gram_gate"], dev)
        for what, kept in (("points", calls[0::2]), ("lines", calls[1::2])):
            back, args = newest_mixed(kept)
            out["kernels"][f"config5_{tag}_{what}"] = phase_gram(
                f"config 5 at {tag.replace('_', ' ')}, frame (last - {back}), {what} "
                f"{shape(args)}", args)
    out["c5"] = {"replay_s": {n: rep["replay_s"] for n, rep in ((4, rep4), (1, rep1))},
                 "ba_ms": [s["ba_ms"] for s in rep4["sequences"]], "dtraj": dtraj}

    # what the pairing costs: one sequence at 1 rank, alone and as a pair
    lone, pair = ([r[0] for r in worlds[1][j]] for j in ("lone", "pair"))
    d_pair = max(float(np.max(np.abs(tp[0] - traj4[0]))) for _, tp in pair)
    if not d_pair < 1e-9:
        raise AssertionError(f"config 5's sequence 0 as a pair at 1 rank and at 4 ranks differ "
                             f"by {d_pair:.3e} m")
    d_lone = max(float(np.max(np.abs(tp[0] - traj4[0]))) for _, tp in lone)
    t_lone, t_pair = ([rep["replay_s"] for rep, _ in runs] for runs in (lone, pair))
    ratio = sum(t_pair) / sum(t_lone)
    print(f"config 5's sequence 0 at 1 rank ({n_frames} frames), lone, pair, pair, lone: "
          f"replay {t_lone[0]:.3f}, {t_pair[0]:.3f}, {t_pair[1]:.3f}, {t_lone[1]:.3f} s; pair "
          f"/ lone {ratio:.3f}; the pair's trajectory {d_pair:.3e} m from the 4-rank run's, "
          f"the lone one's {d_lone:.3e} m; launches lone {lone[0][0]['launches_per_rank']}, "
          f"pair {pair[0][0]['launches_per_rank']}")
    out["pairing"] = {"lone_s": t_lone, "pair_s": t_pair, "ratio": ratio, "d_lone": d_lone}

    # (d) scaling, with the same total batch unsharded in this process
    # (the slowest rank's rate is the batch's, as `scaling.measure` takes it)
    fps = {n: min(r[0] for r in worlds[n]["scaling"][0]) for n in (1, 2, 4)}
    rows = [scaling.weak_row(n, 4, fps[n], scaling.measure(n, solo=True, device=dev)[0], fps[1],
                             worlds[n]["scaling"][0][0][1]) for n in (1, 2, 4)]
    for r in rows:
        if not all(math.isfinite(r[k]) and r[k] > 0 for k in r if k != "backend"):
            raise AssertionError(f"scaling: {r}")
    print("scaling (" + scaling.shared_note(dev, 4) + "): " + json.dumps(rows))
    out["scaling"] = rows
    print(f"phase 32: {time.perf_counter() - t0:.1f} s")
    return out


def main() -> int:
    import torch

    t_start = time.perf_counter()
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
    for line in gram_ptxas(log):
        print(f"  ptxas, gate/Gram {line}")

    gram_filter = [phase_gram(f"k={k} B={B} F={F} M={M_ROWS} D=162",
                              gram_args(k, B, F, M_ROWS, 162, dev))
                   for k, F in ((3, F_PTS), (4, L_LINES))]
    gram_img = [phase_gram(f"k={k} B={B_IMG} F={F} M={2 * MAX_OBS} D={D_IMG}",
                           gram_args(k, B_IMG, F, 2 * MAX_OBS, D_IMG, dev))
                for k, F in ((3, N_PTS), (4, MAX_LINES))]
    # the live driver's shapes without GPS (run_sim --images --lines --wheel: D = 116)
    gram_drv = [phase_gram(f"k={k} B=1 F={F} M={2 * LIVE_OBS} D=116",
                           gram_args(k, 1, F, 2 * LIVE_OBS, 116, dev))
                for k, F in ((3, LIVE_PTS), (4, LIVE_LINES))]
    # stereo point rows (M = 4 obs): the images-in frame with two cameras
    # (D = 147) and the live driver (D = 127)
    gram_stereo = [phase_gram(f"stereo k=3 B={Bn} F={F} M={M} D={D}",
                              gram_args(3, Bn, F, M, D, dev))
                   for Bn, F, M, D in ((B_IMG, N_PTS, 4 * MAX_OBS, 147),
                                       (1, LIVE_PTS, 4 * LIVE_OBS, 127))]
    lk = phase_lk("synthetic", lk_args(dev))

    filter_launches, filter_fps = phase_filter_only(dev)
    sim, frames = images_in_inputs(dev)
    img_launches, img_fps, frame_args = phase_images_in(sim, frames, dev)
    pts_launches, pts_fps = phase_images_in_points(sim, frames, dev)
    # the kernels on the inputs the images-in path gave them in its last frame
    gram_frame = [phase_gram(f"captured images-in frame, {what} " + "x".join(
        str(n) for n in args[0].shape), args)
        for what, args in zip(("points", "lines"), frame_args["gram_gate"])]
    lk_frame = phase_lk("captured images-in frame", frame_args["lk"])
    print(f"frames/s: filter-only {filter_fps:.1f} at B={B}, images-in {img_fps:.1f} at "
          f"B={B_IMG} (points + wheel only {pts_fps:.1f}) on {card}")
    phase_closed_loop(dev)
    live_launches, live, live_args = phase_live_driver(dev)
    gram_live, lk_live = phase_live_kernels(live_args)
    print(f"live driver at B=1 on {card}: {live['fps']:.2f} frames/s, frame latency p50 "
          f"{live['p50_ms']:.3f} ms / p90 {live['p90_ms']:.3f} ms")
    st_launches, st_fps, st_args = phase_images_in_stereo(dev)
    dyn_launches, dyn_fps, dyn_args = phase_images_in_dynamic(sim, frames, dev)
    ldyn_launches, ldyn, ldyn_args = phase_live_dynamic(dev)
    lst_launches, lst, lst_args = phase_live_stereo(dev)
    new_paths = phase_new_path_kernels(st_args, dyn_args, ldyn_args, lst_args)
    print(f"frames/s on {card}: stereo images-in {st_fps:.1f}, dynamic images-in {dyn_fps:.1f} "
          f"at B={B_IMG}; live driver at B=1, dynamic cloning p50 {ldyn['p50_ms']:.3f} ms / p90 "
          f"{ldyn['p90_ms']:.3f} ms, stereo p50 {lst['p50_ms']:.3f} ms / p90 "
          f"{lst['p90_ms']:.3f} ms")
    track = {"mono": phase_track_mono(dev), "kaist": phase_track_kaist(dev)}
    phase_track_stereo()
    orders = phase_track_orders(dev)
    track["order1"], track["order3"] = orders[1], orders[3]
    track["lines"] = phase_track_lines(dev)
    track["kaist_lines"] = phase_track_kaist_lines(dev)
    slam = phase_track_slam(dev)
    track["slam_3d"], track["slam_inverse_depth"] = slam["GLOBAL_3D"], slam[
        "GLOBAL_FULL_INVERSE_DEPTH"]
    track["cpi"] = phase_cpi(dev)
    auto_init = phase_auto_init(dev)
    zupt = phase_zupt(dev)
    trackers = phase_host_tracker(dev)
    line_trackers = phase_host_line_tracker(dev)
    kaist_replay = phase_kaist_replay(dev)
    tags = phase_tags(dev)
    desc = phase_desc_tracker(dev)
    record = phase_record_viz_eval(dev)
    distributed = phase_distributed(dev)
    dist_checks = distributed["kernels"]
    print(f"tags, descriptors, record/viz/eval/checkpoint on {card}: tags ATE {tags['ate']} m, "
          f"NCC {tags['ncc_ms']:.3f} ms and detector {tags['detect_ms']:.3f} ms a 640 x 480 "
          f"frame; descriptor tracker {desc['tracker_p50_ms']:.3f} ms a frame (p50), RMSE "
          f"{desc['rmse']:.4f} m; syncs a frame with the recorder and viz off / on "
          f"{record['syncs']['off']:.2f} / {record['syncs']['on']:.2f}")
    track_launches = {k: sum(r["launches"][k] for r in track.values())
                      for k in ("lk_pyramid", "msckf_gram_gate")}
    tracker_launches = sum(r["launches"]["lk_pyramid"] for r in trackers.values())
    print("per-track path at B=1 on " + card + ": " + "; ".join(
        f"{name} p50 {r['p50_ms']:.3f} ms / p90 {r['p90_ms']:.3f} ms, {r['fps']:.2f} frames/s, "
        f"line stage median {r['stages']['line']:.3f} / mean {r['line_mean_ms']:.3f} ms, "
        f"{r['syncs_per_frame']:.2f} syncs a frame (at most {r['reads_max']} reads)"
        for name, r in list(track.items()) + list(trackers.items())
        + list(line_trackers.items())))
    print(f"CPI table (T, N = {track['cpi']['table_TN']}) on {card}: "
          f"{track['cpi']['table_ops']} host operators, {track['cpi']['table_ms']:.3f} ms; CPI "
          f"with dynamic cloning p50 {track['cpi']['dynamic']['p50_ms']:.3f} ms; auto-init at "
          f"{auto_init['t_init']} s, ATE {auto_init['ate']:.4f} m; ZUPT syncs per IMU sample "
          + ", ".join(f"{k} {v['syncs_per_sample']:.3f} ({v['syncs_outside']} outside updates)"
                      for k, v in zupt.items()))

    # one frame's two calls (points k = 3, lines k = 4): times summed, the
    # bound of their bytes and operations together
    def per_frame(calls):
        out = {k: sum(g[k] for g in calls) for k in ("ms", "plain_ms")}
        out["bound_ms"], out["bound_by"] = bound_ms(*(sum(g["work"][i] for g in calls)
                                                      for i in (0, 1)))
        return out

    gram_img_sum = per_frame(gram_img)

    def times(g):
        return {k: g[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}

    print(json.dumps({"kernels": [
        {"name": "msckf_gram_gate", "route": "cuda",
         "source": "plviwo_tpu_torch/csrc/msckf_gram_gate.cu",
         "replaces": "plviwo_tpu/ops/msckf_kernel.py:205",
         "launches": img_launches["msckf_gram_gate"],
         "max_abs_err": max(g["max_abs_err"] for g in
                            gram_filter + gram_img + gram_frame + gram_live + gram_drv
                            + gram_stereo + [v for k, v in new_paths.items() if "lk" not in k]
                            + [v for k, v in dist_checks.items() if "lk" not in k]),
         "ms": gram_img_sum["ms"], "plain_ms": gram_img_sum["plain_ms"],
         "bound_ms": gram_img_sum["bound_ms"], "bound_by": gram_img_sum["bound_by"],
         "library_ms": None, "per": "images-in frame: points (k=3) + lines (k=4) calls",
         "images_in_shapes": {name: {k: g[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}
                              for name, g in zip(("points", "lines"), gram_img)},
         "launches_by_path": {"images_in": img_launches["msckf_gram_gate"],
                              "images_in_points_only": pts_launches["msckf_gram_gate"],
                              "filter_only": filter_launches,
                              "live_driver_b1": live_launches["msckf_gram_gate"],
                              "images_in_stereo": st_launches["msckf_gram_gate"],
                              "images_in_dynamic": dyn_launches["msckf_gram_gate"],
                              "live_driver_dynamic": ldyn_launches["msckf_gram_gate"],
                              "live_driver_stereo": lst_launches["msckf_gram_gate"],
                              "per_track": track_launches["msckf_gram_gate"],
                              **{path: distributed["launches"][(path, "msckf_gram_gate")]
                                 for path in DISTRIBUTED_PATHS}},
         "stereo_shapes": {name: times(g) for name, g in zip(("images_in_d147_m32",
                                                               "live_driver_d127_m48"),
                                                              gram_stereo)},
         "new_paths": {k: times(v) for k, v in new_paths.items() if "lk" not in k},
         "distributed_paths": {k: times(v) for k, v in dist_checks.items() if "lk" not in k},
         "live_driver_b1": {name: times(g) for name, g in zip(("points", "lines"), gram_live)},
         "driver_shapes_d116": {name: times(g) for name, g in zip(("points", "lines"), gram_drv)},
         "filter_only_shapes": per_frame(gram_filter),
         "captured_frame": {name: times(g) for name, g in zip(("points", "lines"), gram_frame)}},
        {"name": "lk_pyramid", "route": "cuda",
         "source": "plviwo_tpu_torch/csrc/lk_pyramid.cu",
         "replaces": "plviwo_tpu/ops/lk_kernel.py:141",
         "launches": img_launches["lk_pyramid"],
         "max_abs_err": max(lk["max_abs_err"], lk_frame["max_abs_err"], lk_live["max_abs_err"],
                            new_paths["stereo_frame_lk_lr"]["max_abs_err"],
                            dist_checks["next_frame_lk"]["max_abs_err"]),
         "ms": lk["ms"], "plain_ms": lk["plain_ms"], "bound_ms": lk["bound_ms"],
         "bound_by": lk["bound_by"], "library_ms": None,
         "launches_by_path": {"images_in": img_launches["lk_pyramid"],
                              "images_in_points_only": pts_launches["lk_pyramid"],
                              "live_driver_b1": live_launches["lk_pyramid"],
                              "images_in_stereo": st_launches["lk_pyramid"],
                              "images_in_dynamic": dyn_launches["lk_pyramid"],
                              "live_driver_dynamic": ldyn_launches["lk_pyramid"],
                              "live_driver_stereo": lst_launches["lk_pyramid"],
                              "per_track": track_launches["lk_pyramid"],
                              "host_tracker": tracker_launches,
                              "host_line_tracker": sum(r["launches"]["lk_pyramid"]
                                                       for r in line_trackers.values()),
                              "kaist_replay": kaist_replay["launches"]["lk_pyramid"],
                              **{path: distributed["launches"][(path, "lk_pyramid")]
                                 for path in DISTRIBUTED_PATHS}},
         "live_driver_b1": times(lk_live),
         "stereo_frame_lr": times(new_paths["stereo_frame_lk_lr"]),
         "dryrun_next_frame": times(dist_checks["next_frame_lk"]),
         "captured_frame": times(lk_frame)}
    ]}))
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s from start to end")
    failed = [r["failed"] for r in track.values() if r.get("failed")]
    if failed:
        print("chip_smoke: failed: " + "; ".join(failed), file=sys.stderr)
        return 1
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
