"""Drive the PyTorch port on one CUDA card and check it.

Run from the repository root:  python3 chip_smoke.py

Phases (any failure raises, so the exit code is non-zero):
  1. device: requires torch.cuda; prints the card's name and power limit;
  2. build: compiles the MSCKF gate/Gram kernel with nvcc (sm_90a);
  3. kernel vs plain: `gram_gate` on the card against its plain PyTorch
     version at the filter bench's shapes (B = 128, M = 40, D = 162;
     points k = 3, F = 40 and lines k = 4, F = 16), with times;
  4. main path: `fused_step_full` at the bench width (B = 128 sequences,
     22 clones, 40 point tracks x 20 obs, 16 line tracks, 32 IMU and 32
     wheel samples) — one step with real point, line and wheel rows and
     exactly two kernel launches, the same step through the plain gate on
     the card for comparison, then 20 chained steps timed as frames/s.
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
N_CHAINED = 20
M_ROWS = 2 * N_OBS
SIGMA_PIX, CHI2_MULT = 1.0, 1.0


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


def phase_kernel(k, F, D, dev):
    """Kernel vs plain version at one of the main path's shapes."""
    import torch

    from plviwo_tpu_torch.core.step import _chi2_table32
    from plviwo_tpu_torch.ops.msckf_kernel import gram_gate, gram_gate_plain

    rng = np.random.default_rng(10 + k)
    Hx, Hf, r, rowmask, cov = (torch.as_tensor(a, device=dev)
                               for a in random_systems(rng, B, F, M_ROWS, D, k))
    sigma, chi2_mult = 1.3, 5.0
    gate_vec = _chi2_table32(dev)[:M_ROWS + 1] * chi2_mult
    w = torch.full(r.shape, 1.0 / sigma, dtype=torch.float32, device=dev)
    args = (Hx, Hf, r, rowmask, w, cov, gate_vec, 15.0)
    G1, c1, ok1, chi1 = gram_gate(*args)
    G0, c0, ok0, chi0 = gram_gate_plain(*args)
    torch.cuda.synchronize()
    if not torch.equal(ok0, ok1):
        raise AssertionError(f"k={k}: ok differs in {int((ok0 != ok1).sum())} features")
    n_ok = int(ok1.sum())
    if not 0 < n_ok < ok1.numel():
        raise AssertionError(f"k={k}: gate accepted {n_ok} of {ok1.numel()}")
    # bounds of tests/test_msckf_kernel.py: atol 2e-5 max|G|, rtol 2e-4
    for name, a, b in (("G", G1, G0), ("c", c1, c0)):
        sc = float(b.abs().max()) + 1e-9
        torch.testing.assert_close(a, b, atol=2e-5 * sc, rtol=2e-4, msg=f"k={k} {name}")
    err = max(float((G1 - G0).abs().max()), float((c1 - c0).abs().max()))
    ms = cuda_ms(lambda: gram_gate(*args))
    plain_ms = cuda_ms(lambda: gram_gate_plain(*args))
    print(f"kernel k={k} F={F}: ok {n_ok}/{ok1.numel()}, max|dG|={err:.3e} "
          f"(max|G| {float(G0.abs().max()):.3e}), kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms")
    return err, ms, plain_ms


def step_args(dev):
    from plviwo_tpu_torch.examples import batch_args, example_inputs_full

    args = example_inputs_full(n_clones=N_CLONES, F=F_PTS, O=N_OBS, imu_n=IMU_N,
                               L=L_LINES, n_wheel=N_WHEEL)
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


def phase_main_path(dev):
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
    print(f"main path: B={B} D={D} counts {counts} (plain path equal), "
          f"|dp|={dp:.3e} |dcov|={dcov:.3e} max|cov|={sc:.3e}; first step {first_s:.3f} s; "
          f"{N_CHAINED} chained steps {wall:.4f} s = {fps:.1f} frames/s")
    return launches, fps


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available; this script needs a CUDA card",
              file=sys.stderr)
        return 2
    repo = Path(__file__).resolve().parent
    if not (repo / "plviwo_tpu_torch" / "csrc" / "msckf_gram_gate.cu").exists():
        print(f"chip_smoke: no plviwo_tpu_torch package beside {__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(repo))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    from plviwo_tpu_torch.ops.msckf_kernel import build_library

    lib, build_s, log = build_library()
    print(f"build: {lib.name} in {build_s:.2f} s")
    for line in log.splitlines():
        if "registers" in line or "smem" in line or "spill" in line:
            print("  ptxas:", line.strip())

    D = 162
    errs, ms, plain_ms = [], 0.0, 0.0
    for k, F in ((3, F_PTS), (4, L_LINES)):
        e, t, tp = phase_kernel(k, F, D, dev)
        errs.append(e)
        ms += t
        plain_ms += tp

    launches, fps = phase_main_path(dev)
    print(f"frames/s: {fps:.1f} at B={B} on {card}")

    print(json.dumps({"kernels": [{
        "name": "msckf_gram_gate", "route": "cuda",
        "source": "plviwo_tpu_torch/csrc/msckf_gram_gate.cu",
        "replaces": "plviwo_tpu/ops/msckf_kernel.py:205",
        "launches": launches, "max_abs_err": max(errs),
        "ms": ms, "plain_ms": plain_ms}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
