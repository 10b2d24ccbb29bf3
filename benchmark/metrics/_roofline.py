"""Frozen roofline arithmetic of the two CUDA kernels (from chip_smoke.py's `bound_ms`,
`gram_work`, `gram_bound` and `lk_bound`): the least time one H100 could take for a
call, counted from the work the algorithm needs on that call's own arguments (valid rows,
accepted features, tracked windows), whatever the kernel does.  The LK count follows the
plain LK (`reference/plv/ops/klt`) level by level to place the windows.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..reference.plv.ops import klt

# H100 SXM (NVIDIA datasheet, 700 W): HBM bytes/s, FP32 FLOP/s on the CUDA cores
PEAK_BYTES, PEAK_F32 = 3.35e12, 67e12


def bound_ms(n_bytes, n_ops):
    """Least time on the card: bytes over the memory rate or FP32 operations over the
    peak rate, whichever is longer.  Returns (ms, bound_by)."""
    tb, to = n_bytes / PEAK_BYTES, n_ops / PEAK_F32
    return 1e3 * max(tb, to), "bytes" if tb >= to else "operations"


def gram_work(rowmask, ok, D, k):
    """(bytes, FP32 operations) of one gate/Gram call from what its inputs need: the
    valid rows of Hx, Hf, r, w (and every mask byte), the covariances, the outputs; per
    feature with n >= k + 2 valid rows the Householder sweeps, Hv cov, the symmetric half
    of S, the Cholesky and solve, and for accepted features the symmetric half of the
    Gram [Hv | rv]^T [Hv | rv]."""
    Bn, Fn, M = rowmask.shape
    n = rowmask.sum(-1).double()
    rows = float(n.sum())
    n_bytes = (rows * (D + k + 2) * 4 + Bn * Fn * M + Bn * D * D * 4 + (M + 1) * 4
               + Bn * D * D * 4 + Bn * D * 4 + Bn * Fn * 5)
    live = n >= k + 2
    p = (n - k).clamp(min=0)
    ops = (2 * n * (k + D + 1) + k * 4 * n * (k + D + 1) + p * D * D * 2
           + p * (p + 1) * D + p**3 / 3 + p * p)
    ops = float((ops * live).sum() + (p * (D + 1) * (D + 2) * ok.to(p.dtype)).sum())
    return n_bytes, ops


def gram_bound(args, ok):
    """Bound (ms, bound_by) of one gate/Gram call from its arguments and accepted mask."""
    Hx, Hf, rowmask = args[0], args[1], args[3]
    return bound_ms(*gram_work(rowmask, ok, Hx.shape[-1], Hf.shape[-1]))


def lk_bound(prev_pyr, next_pyr, uv_prev, valid, levels, half, iters, max_err, drift,
             drift_fine):
    """Bound (ms, bound_by) of one LK launch (its ten positional arguments) from what its
    inputs need: for the valid features, the pixels under the union of their footprints
    in every level of both pyramids, read once (in `prev` the (W+3)^2 region at the extended template's taps,
    in `next` the target patch, PS^2, its origins following the plain version's level
    loop), the per-feature inputs and outputs, and the FP32 work per feature and level
    (template taps, gradients, normal matrix, `iters` steps of sampling and the 2x2
    solve, the final error)."""
    Bn, N, _ = uv_prev.shape
    live = valid.reshape(Bn, N).to(torch.float32)
    W = 2 * half + 1
    NR = W + 3
    covered = 0.0

    def footprint(img, oy, ox, size):
        H, Wd = img.shape[-2:]
        mark = torch.zeros((Bn, H * Wd), device=img.device)
        mark.scatter_add_(1, oy * Wd + ox, live)
        mark = F.pad((mark > 0).to(torch.float32).view(Bn, 1, H, Wd),
                     (size - 1, 0, size - 1, 0))
        return float(F.max_pool2d(mark, size, stride=1).sum())

    def tap_region(u, o, PS, KS):  # start of the template's tap region in the image
        kk = torch.floor(u - o.to(u.dtype) - (half + 1)).clamp(-1, KS - 1).to(torch.int64)
        return o + kk.clamp(0, PS - NR)

    uv = uv_prev / 2.0 ** (levels - 1)
    for lvl in range(levels - 1, -1, -1):
        D = drift if lvl == levels - 1 else drift_fine
        PS, KS = W + 2 * D + 4, 2 * D + 3
        H, Wd = prev_pyr[lvl].shape[-2:]
        up = uv_prev / 2.0**lvl
        oyp = klt._origin(up[..., 1], half + D + 2, H - PS)
        oxp = klt._origin(up[..., 0], half + D + 2, Wd - PS)
        covered += footprint(prev_pyr[lvl], tap_region(up[..., 1], oyp, PS, KS),
                             tap_region(up[..., 0], oxp, PS, KS), NR)
        covered += footprint(next_pyr[lvl], klt._origin(uv[..., 1], half + D + 1, H - PS),
                             klt._origin(uv[..., 0], half + D + 1, Wd - PS), PS)
        uv = klt._lk_level_conv(prev_pyr[lvl], next_pyr[lvl], up, uv, half, iters, D)[0]
        if lvl > 0:
            uv = uv * 2.0
    n_live = float(live.sum())
    n_bytes = 4 * covered + n_live * (9 + 17)
    per_level = (W + 2) ** 2 * 9 + W * W * (4 + 6) + iters * (W * W * 14 + 10) + W * W * 11
    return bound_ms(n_bytes, n_live * levels * per_level)


def kernel_ms(device_events, names) -> float:
    """Device milliseconds of the kernels whose name contains one of `names`."""
    return sum(t1 - t0 for name, t0, t1 in device_events
               if any(n in name for n in names)) / 1e3


def roofline_pct(bounds_ms, device_ms):
    """100 x the summed bounds over the summed kernel time, or None where either is 0."""
    total = sum(bounds_ms)
    if total <= 0 or device_ms <= 0:
        return None
    return 100.0 * total / device_ms
