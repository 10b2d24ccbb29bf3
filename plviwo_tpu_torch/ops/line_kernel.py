"""The line detector's run-length reaches: the CUDA kernel's wrapper.

`line_runlen(dlx, dly, mag, at)` returns, at each anchor and for each of
the 8 lattice directions, the run length in steps of consecutive support
fore and aft along the direction, as `line_detect.runlen_reaches` computes
it: (reach_f, reach_b), each (B, A, 8) int16.  On CUDA tensors it launches
the hand-written kernel `csrc/line_runlen.cu` (built with nvcc for sm_90a
at first use by `ops/cuda_lib.py`): one support pass for all 8 directions,
one launch per full-field doubling round for all 16 fields of all images,
and the last round at the anchors only.  On CPU tensors it runs the plain
version, `line_detect.runlen_reaches`.  There is no fallback between the
two.  The kernel takes any (B, H, W) up to 4095 images, and reads nothing
back to the host.

The constants the kernel is given are those the plain version applies:
each direction's unit vector, `cos(ANG_TOL)` and `MAG_THRESH` rounded to
float32 as ATen rounds a Python scalar, and each round's lateral
half-width, what `line_detect._lat_dilate`'s doubling covers up to the
round's drift (`lateral_half`).

`reaches` launches the kernel and counts its launches; `line_runlen`, the
name callers look up (and taps rebind), hands it the call.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import cuda_lib, line_detect

F32 = torch.float32
FIELDS = 16  # 8 directions, fore and aft
MAX_BATCH = 65535 // FIELDS  # the rounds' grid holds every field of every image


def lateral_half(drift: int) -> int:
    """The lateral half-width `_lat_dilate(r, drift, ...)` covers: its
    offsets 1, 2, 4, ... up to drift add up to 2^j - 1."""
    off, half = 1, 0
    while off <= drift:
        half += off
        off *= 2
    return half


@functools.cache
def constants():
    """(rounds, each round's lateral half-width, the 8 unit vectors' x then
    y, cos_tol, mag_thresh), as the plain loop forms them."""
    rounds = line_detect.N_DOUBLING
    halves = tuple(lateral_half(line_detect._drift(2**m)) for m in range(rounds))
    units = line_detect._UNIT8
    return (rounds, halves, tuple(u[0] for u in units) + tuple(u[1] for u in units),
            float(np.float32(np.cos(line_detect.ANG_TOL))),
            float(np.float32(line_detect.MAG_THRESH)))


def reaches(dlx, dly, mag, at):
    """The reaches (reach_f, reach_b), each (B, A, 8) int16, of the support
    fields of dlx, dly, mag (B, H, W) float32 at the flat pixel indices at
    (B, A) int64 (each in [0, H W); the kernel gives 0 at one outside).
    CUDA tensors launch the kernel and count the launch in
    `reaches.launches`."""
    if at.device.type == "cpu":
        return line_detect.runlen_reaches(dlx, dly, mag, at)
    if at.device.type != "cuda":
        raise ValueError(f"line_runlen: unsupported device {at.device}")
    if mag.ndim != 3 or at.ndim != 2:
        raise ValueError(f"line_runlen: mag {tuple(mag.shape)}, at {tuple(at.shape)}: expected "
                         "(B, H, W) and (B, A)")
    B, H, W = mag.shape
    A = at.shape[1]
    dev = at.device
    for name, t in (("dlx", dlx), ("dly", dly), ("mag", mag)):
        cuda_lib.check(name, t, F32, (B, H, W), dev)
    cuda_lib.check("at", at, torch.int64, (B, A), dev)
    if not (1 <= B <= MAX_BATCH and min(H, W, A) >= 1):
        raise ValueError(f"line_runlen: B={B}, {H}x{W}, A={A}: sizes the kernel does not take")
    rounds, halves, units, cos_tol, mag_thresh = constants()
    lib = cuda_lib.library()
    # the support and two sets of the 16 fields, rows padded to whole words
    scratch = torch.empty(lib.line_runlen_scratch_bytes(B, H, W), dtype=torch.uint8, device=dev)
    reach_f = torch.empty((B, A, 8), dtype=torch.int16, device=dev)
    reach_b = torch.empty((B, A, 8), dtype=torch.int16, device=dev)
    with torch.cuda.device(dev):
        code = lib.line_runlen(
            dlx.data_ptr(), dly.data_ptr(), mag.data_ptr(), at.data_ptr(), B, H, W, A,
            (ctypes.c_float * 16)(*units), cos_tol, mag_thresh, rounds,
            (ctypes.c_int * rounds)(*halves), scratch.data_ptr(), reach_f.data_ptr(),
            reach_b.data_ptr(), cuda_lib.current_stream(dev))
    if code != 0:
        msg = lib.line_runlen_error_string(code).decode()
        raise RuntimeError(f"line_runlen launch failed: {msg} ({code})")
    reaches.launches += 1
    return reach_f, reach_b


reaches.launches = 0


def line_runlen(dlx, dly, mag, at):
    """The run-length reaches at the anchors; see `reaches`."""
    return reaches(dlx, dly, mag, at)
