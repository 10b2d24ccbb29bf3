"""Pyramidal LK: the CUDA kernel's wrapper (port of plviwo_tpu/ops/lk_kernel.py).

`pyramidal_lk` has the contract of the JAX `pyramidal_lk_pallas`: it tracks
features from the previous pyramid to the next, coarse to fine, and returns
(uv (B,N,2), ok (B,N)).  On CUDA tensors it launches the hand-written
kernel `csrc/lk_pyramid.cu` (built with nvcc for sm_90a at first use by
`ops/cuda_lib.py`): ONE launch walks every level for every feature of every
sequence, one warp per feature, reading its patches straight from the level
images.  On CPU
tensors it runs the kernel's plain version, `ops/klt.pyramidal_lk_conv`.
There is no fallback between the two.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_lib, klt

F32 = torch.float32


def lk_pyramid(prev_pyr, next_pyr, uv_prev, valid, levels: int, half: int = 7,
               iters: int = 10, max_err: float = 0.08, drift: int = 5,
               drift_fine: int = 2):
    """`pyramidal_lk` that also returns the finest level's mean |I-T| error
    and template determinant: (uv (B,N,2), ok (B,N), err (B,N), det (B,N)).

    prev_pyr/next_pyr: sequences of at least `levels` (B, H/2^l, W/2^l) f32
    images; uv_prev (B,N,2) f32; valid (B,N) bool.  CUDA tensors launch the
    kernel and count the launch in `lk_pyramid.launches`."""
    if uv_prev.device.type == "cpu":
        return klt.pyramidal_lk_conv_full(prev_pyr, next_pyr, uv_prev, valid, levels,
                                          half, iters, max_err, drift, drift_fine)
    if uv_prev.device.type != "cuda":
        raise ValueError(f"lk_pyramid: unsupported device {uv_prev.device}")
    B, N = valid.shape
    W = 2 * half + 1
    PS = W + 2 * max(drift, drift_fine) + 4
    # the kernel's window is at most 16 x 16 (a lane owns one column of 8
    # rows, a warp 16 columns by 16 rows): half <= 7
    if not 1 <= levels <= 4 or not 0 <= half <= 7 or min(drift, drift_fine, iters) < 0:
        raise ValueError(f"lk_pyramid: levels={levels}, half={half}, drift={drift}/"
                         f"{drift_fine}, iters={iters}: sizes the kernel does not take")
    dev = uv_prev.device
    cuda_lib.check("uv_prev", uv_prev, F32, (B, N, 2), dev)
    cuda_lib.check("valid", valid, torch.bool, (B, N), dev)
    dims = []
    for l in range(levels):
        H, Wd = prev_pyr[l].shape[-2:]
        if min(H, Wd) < PS:
            raise ValueError(f"lk_pyramid: level {l} is {H}x{Wd}, smaller than a {PS}-px patch")
        cuda_lib.check(f"prev_pyr[{l}]", prev_pyr[l], F32, (B, H, Wd), dev)
        cuda_lib.check(f"next_pyr[{l}]", next_pyr[l], F32, (B, H, Wd), dev)
        dims.append((H, Wd))
    lib = cuda_lib.library()
    smem = lib.lk_pyramid_smem_bytes(half, drift, drift_fine)
    if not 0 < smem <= cuda_lib.SMEM_LIMIT:
        raise ValueError(f"lk_pyramid: drift={drift}/{drift_fine}: sizes the kernel does not "
                         f"take ({smem} B of shared memory per block)")

    ptrs = ctypes.c_void_p * levels
    ints = ctypes.c_int * levels
    uv = torch.empty((B, N, 2), dtype=F32, device=dev)
    ok = torch.empty((B, N), dtype=torch.bool, device=dev)
    err = torch.empty((B, N), dtype=F32, device=dev)
    det = torch.empty((B, N), dtype=F32, device=dev)
    with torch.cuda.device(dev):
        code = lib.lk_pyramid(
            ptrs(*(p.data_ptr() for p in prev_pyr[:levels])),
            ptrs(*(p.data_ptr() for p in next_pyr[:levels])),
            ints(*(h for h, _ in dims)), ints(*(w for _, w in dims)), levels,
            uv_prev.data_ptr(), valid.data_ptr(), B, N, half, iters, drift, drift_fine,
            float(max_err), uv.data_ptr(), ok.data_ptr(), err.data_ptr(), det.data_ptr(),
            cuda_lib.current_stream(dev))
    if code != 0:
        msg = lib.lk_pyramid_error_string(code).decode()
        raise RuntimeError(f"lk_pyramid launch failed: {msg} ({code})")
    lk_pyramid.launches += 1
    return uv, ok, err, det


lk_pyramid.launches = 0


def pyramidal_lk(prev_pyr, next_pyr, uv_prev, valid, levels: int, half: int = 7,
                 iters: int = 10, max_err: float = 0.08, drift: int = 5,
                 drift_fine: int = 2):
    """Track features from prev to next through the pyramid (coarse to
    fine).  Returns (uv_next (B,N,2), ok (B,N)); see `lk_pyramid`."""
    return lk_pyramid(prev_pyr, next_pyr, uv_prev, valid, levels, half, iters, max_err,
                      drift, drift_fine)[:2]
