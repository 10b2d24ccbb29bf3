"""ctypes bridge to the native C++ host components (port of
plviwo_tpu/native.py): the feature-track store with its padded MSCKF batch
export (`native/feature_db.cpp`, the reference's C++ `FeatureDatabase`)
and the dataset CSV parser (`native/csv_loader.cpp`).

At first use `library` compiles both sources with g++ and native/Makefile's
flags into `build/plviwo_tpu_torch/` at the repository root (git-ignored).
The file name carries a hash of the sources, the flags and the compiler's
version, and the build ends in an atomic rename, so processes that build at
once each load a whole library.  Where g++ or the sources are missing, or the build fails,
`available()` is False and callers take their Python paths (the per-track
driver names the store it ran in its final report).
"""

from __future__ import annotations

import ctypes as C
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
SOURCES = (ROOT / "native" / "feature_db.cpp", ROOT / "native" / "csv_loader.cpp")
BUILD_DIR = ROOT / "build" / "plviwo_tpu_torch"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-shared")  # native/Makefile's


def build() -> Path:
    """Compile the native sources into one shared library unless it is
    built; returns its path.  Raises RuntimeError when they cannot be built."""
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None or not all(s.exists() for s in SOURCES):
        raise RuntimeError(f"no C++ compiler ({cxx}) or no sources under {ROOT / 'native'}")
    # the compiler's version too: a library built on another machine's
    # toolchain is not loaded here
    version = subprocess.run([cxx, "--version"], capture_output=True, text=True).stdout
    h = hashlib.sha256((" ".join(CXX_FLAGS) + "\0" + version).encode())
    for s in SOURCES:
        h.update(s.name.encode() + b"\0" + s.read_bytes())
    lib = BUILD_DIR / f"libplviwo_native_{h.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        so = Path(tmp) / lib.name
        out = subprocess.run([cxx, *CXX_FLAGS, *map(str, SOURCES), "-o", str(so)],
                             capture_output=True, text=True)
        if out.returncode != 0:
            raise RuntimeError(f"g++ failed on native/*.cpp:\n{out.stdout}{out.stderr}")
        os.replace(so, lib)
    return lib


@functools.cache
def library() -> C.CDLL | None:
    """The loaded library with every function's argument types declared, or
    None where it cannot be built or loaded."""
    try:
        lib = C.CDLL(str(build()))
    except (RuntimeError, OSError):
        return None
    vp, i64, f64, pd, pi64 = C.c_void_p, C.c_int64, C.c_double, C.POINTER(C.c_double), \
        C.POINTER(C.c_int64)
    lib.fdb_create.restype = vp
    lib.fdb_destroy.argtypes = [vp]
    lib.fdb_update.argtypes = [vp, i64] + [f64] * 5
    lib.fdb_update_batch.argtypes = [vp, pi64, pd, pd, i64, f64]
    lib.fdb_cleanup.argtypes = [vp, f64]
    lib.fdb_remove.argtypes = [vp, pi64, i64]
    lib.fdb_size.argtypes = [vp]
    lib.fdb_size.restype = i64
    lib.fdb_export_msckf.restype = i64
    lib.fdb_export_msckf.argtypes = [
        vp, pd, C.POINTER(C.c_int32), i64, pd, i64, f64, i64, i64, i64,
        pd, pd, C.POINTER(C.c_int32), C.POINTER(C.c_int32), pd, pd,
        C.POINTER(C.c_uint8), pi64]
    lib.csv_open.restype = vp
    lib.csv_open.argtypes = [C.c_char_p, C.c_long]
    lib.csv_rows.argtypes = [vp]
    lib.csv_rows.restype = C.c_long
    lib.csv_cols.argtypes = [vp]
    lib.csv_cols.restype = C.c_long
    lib.csv_copy.argtypes = [vp, pd]
    lib.csv_free.argtypes = [vp]
    return lib


def available() -> bool:
    return library() is not None


def _ptr(arr, ctype):
    return arr.ctypes.data_as(C.POINTER(ctype))


def load_csv(path: str, ncols: int = 0):
    """Native CSV parse -> (rows, cols) float64 array, or None without the
    library or when the file cannot be read (callers fall back to the Python
    parser).  Commas and blanks separate fields, a line with a non-numeric
    token is skipped, each row keeps its first ncols fields (0: the first
    kept row's width) and a shorter row is dropped."""
    lib = library()
    if lib is None:
        return None
    h = lib.csv_open(str(path).encode(), int(ncols))
    if not h:
        return None
    try:
        out = np.zeros((lib.csv_rows(h), lib.csv_cols(h)), dtype=np.float64)
        if out.size:
            lib.csv_copy(h, _ptr(out, C.c_double))
        return out
    finally:
        lib.csv_free(h)


class NativeFeatureDatabase:
    """The C++ feature store: `update/feature_db.FeatureDatabase`'s track
    bookkeeping (mono, no per-observation camera) plus a one-call padded
    MSCKF batch export."""

    def __init__(self):
        lib = library()
        if lib is None:
            raise RuntimeError("the native library cannot be built here (see native.build)")
        self._lib = lib
        self._h = lib.fdb_create()

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.fdb_destroy(self._h)
            self._h = None

    def __reduce__(self):
        # a copy would share (and then free twice) the C++ store
        raise TypeError("a NativeFeatureDatabase cannot be copied or pickled; build a new one "
                        "and feed it the tracks")

    def update_batch(self, fids, t, uvs, uvns):
        """n features (ids (n,), raw pixels (n, 2), normalized (n, 2)) at time t."""
        fids = np.ascontiguousarray(fids, dtype=np.int64)
        uvs = np.ascontiguousarray(uvs, dtype=np.float64).reshape(-1, 2)
        uvns = np.ascontiguousarray(uvns, dtype=np.float64).reshape(-1, 2)
        if not len(fids) == len(uvs) == len(uvns):
            raise ValueError(f"update_batch: {len(fids)} ids, {len(uvs)} uvs, {len(uvns)} uvns")
        self._lib.fdb_update_batch(self._h, _ptr(fids, C.c_int64), _ptr(uvs, C.c_double),
                                   _ptr(uvns, C.c_double), len(fids), float(t))

    def update(self, fid, t, uv, uvn):
        self._lib.fdb_update(self._h, int(fid), float(t), float(uv[0]), float(uv[1]),
                             float(uvn[0]), float(uvn[1]))

    def cleanup(self, t_min):
        """Drop every observation older than t_min, and the emptied tracks."""
        self._lib.fdb_cleanup(self._h, float(t_min))

    def remove(self, fids):
        fids = np.ascontiguousarray(list(fids), dtype=np.int64)
        if len(fids):
            self._lib.fdb_remove(self._h, _ptr(fids, C.c_int64), len(fids))

    def __len__(self):
        return int(self._lib.fdb_size(self._h))

    def export_msckf(self, clone_t, clone_slot, marg_t, t_frame, min_track, max_msckf, max_obs):
        """The MSCKF candidates (tracks lost by t_frame or observing a time in
        marg_t, with >= min_track observations the clones (times clone_t,
        sorted, in slots clone_slot) cover; the most such observations
        first, then the larger id; at most max_msckf) as padded arrays of
        max_obs observations.  Returns (n, fids, uv, uvn, s0, s1, lam, t,
        valid): s0 / s1 / lam the bounding clone slots and the interpolation
        weight of each observation."""
        clone_t = np.ascontiguousarray(clone_t, dtype=np.float64)
        clone_slot = np.ascontiguousarray(clone_slot, dtype=np.int32)
        marg_t = np.ascontiguousarray(marg_t, dtype=np.float64)
        if len(clone_slot) != len(clone_t):
            raise ValueError(f"export_msckf: {len(clone_t)} clone times, {len(clone_slot)} slots")
        F, O = int(max_msckf), int(max_obs)
        uv, uvn = np.zeros((F, O, 2)), np.zeros((F, O, 2))
        s0, s1 = np.zeros((F, O), dtype=np.int32), np.zeros((F, O), dtype=np.int32)
        lam, obs_t = np.zeros((F, O)), np.zeros((F, O))
        valid = np.zeros((F, O), dtype=np.uint8)
        fids = np.full(F, -1, dtype=np.int64)
        n = self._lib.fdb_export_msckf(
            self._h, _ptr(clone_t, C.c_double), _ptr(clone_slot, C.c_int32), len(clone_t),
            _ptr(marg_t, C.c_double), len(marg_t), float(t_frame), int(min_track), F, O,
            _ptr(uv, C.c_double), _ptr(uvn, C.c_double), _ptr(s0, C.c_int32),
            _ptr(s1, C.c_int32), _ptr(lam, C.c_double), _ptr(obs_t, C.c_double),
            _ptr(valid, C.c_uint8), _ptr(fids, C.c_int64))
        return int(n), fids, uv, uvn, s0, s1, lam, obs_t, valid.astype(bool)
