"""Build and load the port's CUDA kernels (`csrc/*.cu`) as one library.

Every source under `plviwo_tpu_torch/csrc/` has a plain C interface.  At
first use `build_library` compiles them for sm_90a, one nvcc process per
source, all started together, and links the objects into one shared
library under `build/` at the repository root (git-ignored).  The file name
carries a hash of all the sources and the flags, so an edited source builds
anew.  `library` loads it through ctypes with the argument types of every
function declared.
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

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "plviwo_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SMEM_LIMIT = 232448  # bytes of shared memory one block may use on Hopper


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError(f"nvcc not found (looked on PATH and at {nvcc})")
    return nvcc


def build_library() -> tuple[Path, float, str]:
    """Compile every `csrc/*.cu` into one shared library if it is not built.

    Returns (path, build seconds — 0.0 when it was already built, the
    compilers' output with the `-Xptxas -v` register/shared-memory report)."""
    sources = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in sources:
        h.update(s.name.encode() + b"\0" + s.read_bytes())
    lib = BUILD_DIR / f"libplviwo_kernels_{h.hexdigest()[:16]}.so"
    log = lib.with_suffix(".log")
    if lib.exists():
        return lib, 0.0, log.read_text() if log.exists() else ""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / f"{s.stem}.o" for s in sources]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for s, o in zip(sources, objs)]
        outs = [p.communicate()[0] for p in procs]
        output = "".join(f"== {s.name}\n{o}" for s, o in zip(sources, outs))
        failed = [s.name for s, p in zip(sources, procs) if p.returncode != 0]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{output}")
        so = Path(tmp) / lib.name
        link = subprocess.run([nvcc, "-shared", "-o", str(so), *map(str, objs)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
        log.write_text(output)
        os.replace(so, lib)
    return lib, time.perf_counter() - t0, output


@functools.cache
def library() -> ctypes.CDLL:
    path, _, _ = build_library()
    lib = ctypes.CDLL(str(path))
    vp, ci, cf, sz = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_size_t
    lib.msckf_gram_gate.argtypes = [vp] * 7 + [cf] + [ci] * 5 + [vp] * 6
    lib.msckf_gram_gate.restype = ci
    lib.msckf_gram_gate_smem_bytes.argtypes = [ci, ci, ci]
    lib.msckf_gram_gate_smem_bytes.restype = sz
    lib.lk_pyramid.argtypes = [vp] * 4 + [ci] + [vp] * 2 + [ci] * 6 + [cf] + [vp] * 5
    lib.lk_pyramid.restype = ci
    lib.lk_pyramid_smem_bytes.argtypes = [ci, ci, ci]
    lib.lk_pyramid_smem_bytes.restype = sz
    lib.line_runlen.argtypes = [vp] * 4 + [ci] * 4 + [vp] + [cf] * 2 + [ci] + [vp] * 5
    lib.line_runlen.restype = ci
    lib.line_runlen_scratch_bytes.argtypes = [ci] * 3
    lib.line_runlen_scratch_bytes.restype = sz
    for name in ("msckf_gram_gate_error_string", "lk_pyramid_error_string",
                 "line_runlen_error_string"):
        getattr(lib, name).argtypes = [ci]
        getattr(lib, name).restype = ctypes.c_char_p
    return lib


def check(name, t, dtype, shape, device):
    """Raise ValueError unless t is a contiguous `dtype` tensor of `shape` on
    `device`."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def current_stream(device: torch.device) -> int:
    """The raw cudaStream_t of PyTorch's current stream on `device`."""
    return torch.cuda.current_stream(device).cuda_stream
