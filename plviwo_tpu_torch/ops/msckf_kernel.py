"""Fused MSCKF gate/Gram: the CUDA kernel's wrapper and its plain version.

Port of plviwo_tpu/ops/msckf_kernel.py (the Pallas TPU kernel
`gram_gate_fused`).  Per feature: whiten and mask the rows, project them
onto the left nullspace of Hf with k Householder reflectors, chi2-gate the
projected system against S = Hv cov Hv^T + I, and sum the accepted rows
into the Gram system (G = sum Hv^T Hv, c = sum Hv^T rv).

`gram_gate` takes batch-first tensors.  On CUDA tensors it launches the
hand-written kernel `csrc/msckf_gram_gate.cu` (built with nvcc for sm_90a
at first use, into `build/` at the repository root) or raises; on CPU
tensors it runs `gram_gate_plain`.  There is no fallback between the two.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

F32 = torch.float32

_SRC = Path(__file__).resolve().parents[1] / "csrc" / "msckf_gram_gate.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "plviwo_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def gram_gate_plain(Hx, Hf, r, rowmask, w, cov, gate_vec, resid_cap):
    """Plain PyTorch version of the kernel (same arguments as `gram_gate`)."""
    B, F, M, D = Hx.shape
    k = Hf.shape[-1]
    m = rowmask[..., None]
    A = torch.cat([torch.where(m, Hf * w[..., None], 0.0),
                   torch.where(m, Hx * w[..., None], 0.0),
                   torch.where(rowmask, r * w, 0.0)[..., None]], dim=-1)
    raw_max = torch.amax(torch.abs(A[..., -1]), dim=-1)

    idx = torch.arange(M, device=Hx.device)
    for j in range(k):
        x = torch.where(idx >= j, A[..., :, j], 0.0)
        nx = torch.sqrt(torch.sum(x * x, dim=-1))
        sgn = torch.where(x[..., j] >= 0.0, 1.0, -1.0).to(F32)
        v = x - (-sgn * nx)[..., None] * (idx == j).to(F32)
        nv = torch.sqrt(torch.sum(v * v, dim=-1))
        small = nv < 1e-12
        v = v / torch.where(small, torch.ones_like(nv), nv)[..., None]
        scale = torch.where(small, 0.0, 2.0).to(F32)
        A = A - (scale[..., None] * v)[..., :, None] * (v[..., None, :] @ A)

    valid = (idx >= k)[:, None]
    Hv = torch.where(valid, A[..., k:k + D], 0.0)
    rv = torch.where(valid[:, 0], A[..., -1], 0.0)
    S = Hv @ cov[:, None] @ Hv.transpose(-1, -2)
    S = 0.5 * (S + S.transpose(-1, -2)) + torch.eye(M, dtype=F32, device=Hx.device)
    L, _ = torch.linalg.cholesky_ex(S)
    y = torch.linalg.solve_triangular(L, rv[..., None], upper=False)[..., 0]
    chi2 = torch.sum(y * y, dim=-1)

    n_rows = torch.sum(rowmask, dim=-1)
    gate_pad = torch.cat([gate_vec.to(F32), gate_vec.new_zeros(1, dtype=F32)])
    dof = torch.clamp(n_rows - k, min=1, max=gate_pad.shape[0] - 1)
    cap = torch.tensor(resid_cap, dtype=F32, device=Hx.device)
    ok = (chi2 < gate_pad[dof]) & (n_rows >= k + 2) & (raw_max < cap)

    Hok = torch.where(ok[..., None, None], Hv, 0.0)
    rok = torch.where(ok[..., None], rv, 0.0)
    G = torch.einsum("bfmd,bfme->bde", Hok, Hok)
    c = torch.einsum("bfmd,bfm->bd", Hok, rok)
    return G, c, ok, chi2


def build_library() -> tuple[Path, float, str]:
    """Compile the kernel's shared library with nvcc if it is not built yet.

    Returns (path, build seconds — 0.0 when it was already built, the
    compiler's output with the `-Xptxas -v` register/shared-memory report).
    The file name carries a hash of the source, so an edited source builds
    anew."""
    src = _SRC.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"libmsckf_gram_gate_{tag}.so"
    log = lib.with_suffix(".log")
    if lib.exists():
        return lib, 0.0, log.read_text() if log.exists() else ""
    nvcc = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError(f"nvcc not found (looked on PATH and at {nvcc})")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, str(_SRC)],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    output = proc.stdout + proc.stderr
    log.write_text(output)
    os.replace(tmp, lib)
    return lib, seconds, output


@functools.cache
def _library() -> ctypes.CDLL:
    path, _, _ = build_library()
    lib = ctypes.CDLL(str(path))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.msckf_gram_gate.argtypes = [vp] * 7 + [ctypes.c_float] + [ci] * 5 + [vp] * 6
    lib.msckf_gram_gate.restype = ci
    lib.msckf_gram_gate_smem_bytes.argtypes = [ci, ci, ci]
    lib.msckf_gram_gate_smem_bytes.restype = ctypes.c_size_t
    lib.msckf_gram_gate_error_string.argtypes = [ci]
    lib.msckf_gram_gate_error_string.restype = ctypes.c_char_p
    return lib


_SMEM_LIMIT = 232448  # bytes of shared memory one block may use on Hopper


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def gram_gate(Hx, Hf, r, rowmask, w, cov, gate_vec, resid_cap: float):
    """Gated Gram system of a batch of per-feature MSCKF systems.

    Args (batch-first):
      Hx: (B, F, M, D) f32 state Jacobian stacks.
      Hf: (B, F, M, k) f32 feature Jacobians, k in {3, 4}.
      r, w: (B, F, M) f32 residuals and row whitening weights (1/sigma).
      rowmask: (B, F, M) bool.
      cov: (B, D, D) f32 covariance.
      gate_vec: (M+1,) f32 chi2 thresholds by dof (table * chi2_mult).
      resid_cap: raw-residual pre-gate, in whitened units.
    Returns:
      G (B, D, D), c (B, D), ok (B, F) bool, chi2 (B, F) — all f32 but ok.

    CPU tensors take `gram_gate_plain`; CUDA tensors launch the kernel and
    count the launch in `gram_gate.launches`."""
    if Hx.device.type == "cpu":
        return gram_gate_plain(Hx, Hf, r, rowmask, w, cov, gate_vec, resid_cap)
    if Hx.device.type != "cuda":
        raise ValueError(f"gram_gate: unsupported device {Hx.device}")
    B, F, M, D = Hx.shape
    k = Hf.shape[-1]
    if not (1 <= k < M) or B < 1 or F < 1:
        raise ValueError(f"gram_gate: bad sizes B={B} F={F} M={M} k={k}")
    dev = Hx.device
    _check("Hx", Hx, F32, (B, F, M, D), dev)
    _check("Hf", Hf, F32, (B, F, M, k), dev)
    _check("r", r, F32, (B, F, M), dev)
    _check("rowmask", rowmask, torch.bool, (B, F, M), dev)
    _check("w", w, F32, (B, F, M), dev)
    _check("cov", cov, F32, (B, D, D), dev)
    _check("gate_vec", gate_vec, F32, (M + 1,), dev)
    lib = _library()
    smem = lib.msckf_gram_gate_smem_bytes(M, D, k)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"gram_gate: M={M}, D={D} need {smem} B of shared memory")

    P = torch.empty((B, F, M - k, D + 1), dtype=F32, device=dev)
    ok = torch.empty((B, F), dtype=torch.bool, device=dev)
    chi2 = torch.empty((B, F), dtype=F32, device=dev)
    G = torch.empty((B, D, D), dtype=F32, device=dev)
    c = torch.empty((B, D), dtype=F32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.msckf_gram_gate(
            Hx.data_ptr(), Hf.data_ptr(), r.data_ptr(), rowmask.data_ptr(),
            w.data_ptr(), cov.data_ptr(), gate_vec.data_ptr(), float(resid_cap),
            B, F, M, D, k, P.data_ptr(), ok.data_ptr(), chi2.data_ptr(),
            G.data_ptr(), c.data_ptr(), stream)
    if err != 0:
        msg = lib.msckf_gram_gate_error_string(err).decode()
        raise RuntimeError(f"msckf_gram_gate launch failed: {msg} ({err})")
    gram_gate.launches += 1
    return G, c, ok, chi2


gram_gate.launches = 0
