"""Run-length line-segment detection (port of plviwo_tpu/ops/line_detect.py),
batch-first.

`detect_segments_runlen`, the frame's default detector: for each of 8
lattice directions (mod pi) a pixel supports the direction iff its
gradient magnitude passes and its level-line direction agrees; the support
is dilated 3x3, and the run length of consecutive support along the
direction is computed for every pixel at once by pointer doubling
(ceil(log2(LINE_STEPS)) rounds of shifted, masked adds, with a lateral
dilation for off-lattice lines).  Per grid cell the strongest gradient
pixel is an anchor; its line direction comes from the smoothed structure
tensor, snapped to the nearest lattice ray, and the anchor's reach fore and
aft along that ray gives the segment's endpoints.

Images are (B, H, W) float32.  Shifts are pad-and-slice with an explicit
fill, as the JAX package writes them (no `torch.roll`: the fill matters).
The support masks and run lengths, float32 0/1 sums in the JAX package,
are int16 here: the same integers (a run never exceeds 2^n_doubling
steps) in half the bytes of the ~2k full-image passes.
The anchor walk `detect_segments` (a TPU workaround, off by default) and
the host-side `merge_segments` are not ported.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .image import gauss_blur, gradients

F32 = torch.float32
I16 = torch.int16
# the settings the JAX frame detects with: anchor grid cells per side,
# anchors kept, the longest run in steps; and the detector's own defaults: a
# pixel supports a direction above MAG_THRESH gradient magnitude and within
# ANG_TOL radians of it
LINE_GRID, LINE_ANCHORS, LINE_STEPS = 16, 192, 96
MAG_THRESH, ANG_TOL = 0.02, 0.55

# direction k covers the angle bucket k pi / 8 (mod pi), as (dx, dy) steps
_DIRS8 = np.array([
    [1, 0], [2, 1], [1, 1], [1, 2], [0, 1], [-1, 2], [-1, 1], [-2, 1]
], dtype=np.int32)
_UNIT8 = [tuple(float(np.float32(v)) for v in d / np.hypot(*d)) for d in _DIRS8.astype(np.float64)]
# the step lengths |d| as float32: 1 (k = 0, 4), sqrt 2 (k = 2, 6), sqrt 5 (odd k)
_SQRT2, _SQRT5 = float(np.float32(np.sqrt(2.0))), float(np.float32(np.sqrt(5.0)))


def _shift2d(x, dy: int, dx: int, fill=0):
    """x (..., H, W) shifted so out[p] = x[p + (dy, dx)], `fill` outside."""
    H, W = x.shape[-2:]
    py0, py1 = max(dy, 0), max(-dy, 0)
    px0, px1 = max(dx, 0), max(-dx, 0)
    p = F.pad(x, (px1, px0, py1, py0), value=fill)
    return p[..., py1 + dy:py1 + dy + H, px1 + dx:px1 + dx + W]


def _lat_dilate(r, width: int, ly: int, lx: int):
    """max over lateral offsets in [-width, width] along (ly, lx) by doubling
    (offsets 1, 2, 4, ... cover +-(2^k - 1) >= width)."""
    acc = r
    off = 1
    while off <= width:
        acc = torch.maximum(acc, torch.maximum(_shift2d(acc, off * ly, off * lx),
                                               _shift2d(acc, -off * ly, -off * lx)))
        off *= 2
    return acc


def _flat_gather(x, idx):
    """x (B, H, W) at flat pixel indices idx (B, A)."""
    return torch.gather(x.reshape(x.shape[0], -1), 1, idx)


def detect_segments_runlen(img):
    """Candidate segments of B images (B, H, W) from per-pixel run-length
    fields.  Returns (segs (B, A, 4) [x1 y1 x2 y2], length (B, A),
    valid (B, A)) with A = LINE_ANCHORS, anchors in decreasing cell
    magnitude (ties by cell index)."""
    B, H, W = img.shape
    grid = LINE_GRID
    img_s = gauss_blur(gauss_blur(img))
    gx, gy = gradients(img_s)
    mag = torch.sqrt(gx * gx + gy * gy)
    inv = 1.0 / torch.clamp(mag, min=1e-9)
    # unit level-line direction (perpendicular to the gradient)
    dlx, dly = -gy * inv, gx * inv

    # smoothed structure tensor: a sign-stable line orientation
    jxx = gauss_blur(gauss_blur(gx * gx))
    jxy = gauss_blur(gauss_blur(gx * gy))
    jyy = gauss_blur(gauss_blur(gy * gy))

    # --- anchors: the strongest gradient pixel per grid cell ---
    ch, cw = H // grid, W // grid
    m = mag[:, :ch * grid, :cw * grid].reshape(B, grid, ch, grid, cw)
    m = m.transpose(2, 3).reshape(B, grid * grid, ch * cw)
    cell_mag, cell_best = torch.max(m, dim=-1)  # first index among ties, as jnp.argmax
    cells = torch.arange(grid * grid, device=img.device)
    au = (cells % grid) * cw + cell_best % cw
    av = (cells // grid) * ch + cell_best // cw
    order = torch.argsort(-cell_mag, dim=-1, stable=True)[:, :LINE_ANCHORS]
    au, av = torch.gather(au, 1, order), torch.gather(av, 1, order)
    amag = torch.gather(cell_mag, 1, order)
    at = av * W + au  # (B, A) flat pixel of each anchor

    n_doubling = int(np.ceil(np.log2(LINE_STEPS)))
    cos_tol = float(np.cos(ANG_TOL))
    reach_f, reach_b = [], []  # per direction: run lengths in steps at the anchors
    for k in range(8):
        sx, sy = int(_DIRS8[k][0]), int(_DIRS8[k][1])
        norm = float(np.hypot(sx, sy))
        ux, uy = sx / norm, sy / norm
        sup = ((torch.abs(dlx * ux + dly * uy) > cos_tol) & (mag > MAG_THRESH)).to(I16)
        # 3x3 dilation: an off-lattice line staircases by <= 1 px per step
        sup = torch.maximum(torch.maximum(_shift2d(sup, -1, 0), sup), _shift2d(sup, 1, 0))
        sup = torch.maximum(torch.maximum(_shift2d(sup, 0, -1), sup), _shift2d(sup, 0, 1))
        # lateral drift axis: the ray's minor axis
        ly, lx = (0, 1) if abs(sx) <= abs(sy) else (1, 0)
        r_f = r_b = sup
        step = 1
        for _ in range(n_doubling):
            # r'(p) = r(p) + [r(p) >= step] * max_lat r(p + step d + lat)
            drift = int(math.ceil(0.22 * step))
            cont_f = _lat_dilate(r_f, drift, ly, lx)
            cont_b = _lat_dilate(r_b, drift, ly, lx)
            r_f = r_f + torch.where(r_f >= step, _shift2d(cont_f, step * sy, step * sx), 0)
            r_b = r_b + torch.where(r_b >= step, _shift2d(cont_b, -step * sy, -step * sx), 0)
            step *= 2
        reach_f.append(_flat_gather(r_f, at))
        reach_b.append(_flat_gather(r_b, at))

    # true local line direction: perpendicular to the structure tensor's
    # dominant eigenvector
    axx, axy, ayy = (_flat_gather(j, at) for j in (jxx, jxy, jyy))
    theta_g = 0.5 * torch.atan2(2.0 * axy, axx - ayy)
    dax, day = -torch.sin(theta_g), torch.cos(theta_g)

    # snap to the nearest lattice ray by |cos|
    dots = torch.stack([dax * ux + day * uy for ux, uy in _UNIT8], dim=-1)  # (B, A, 8)
    k = torch.argmax(torch.abs(dots), dim=-1, keepdim=True)
    step_len = torch.where(k[..., 0] % 2 == 1, _SQRT5,
                           torch.where(k[..., 0] % 4 == 2, _SQRT2, 1.0)).to(F32)
    sdot = torch.gather(dots, -1, k)[..., 0]
    # orient along the snapped +d; stretch the along-ray run back to the
    # line's own axis (the run covers the true extent * cos(snap error))
    sgn = torch.sign(sdot)
    dax, day = dax * sgn, day * sgn
    stretch = step_len / torch.clamp(torch.abs(sdot), min=0.8)

    # reach in steps; -1 drops the dilation halo at each end
    n_f = torch.clamp(torch.gather(torch.stack(reach_f, -1), -1, k)[..., 0].to(F32) - 1.0, min=0.0)
    n_b = torch.clamp(torch.gather(torch.stack(reach_b, -1), -1, k)[..., 0].to(F32) - 1.0, min=0.0)

    ax, ay = au.to(F32), av.to(F32)
    ef, eb = n_f * stretch, n_b * stretch
    segs = torch.stack([torch.clamp(ax - eb * dax, 2, W - 3), torch.clamp(ay - eb * day, 2, H - 3),
                        torch.clamp(ax + ef * dax, 2, W - 3), torch.clamp(ay + ef * day, 2, H - 3)],
                       dim=-1)
    length = (n_f + n_b) * stretch
    valid = (amag > MAG_THRESH) & (length >= 2.0)
    return segs, length, valid
