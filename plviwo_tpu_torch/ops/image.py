"""Image-processing substrate of the visual front-end (port of
plviwo_tpu/ops/image.py), batch-first.

Images are (B, H, W) float32.  Filters are separable, written as shifted
slices of a zero-padded image as the JAX package writes them (no
convolution call: cuDNN would run a float32 convolution in TF32), so both
packages take the same multiply-adds in the same order.  The frame
equalizes with `hist_equalize_quantile`; the host trackers with the LUT
variant `hist_equalize`.  `bilinear_sample` serves the host line
tracker's anchor walk (`line_detect.detect_segments`), the tag detector's
bit sampling and its corner refinement (`aruco`); `bilinear_sample_batch`,
its per-sequence form, the gather LK (`klt.pyramidal_lk`).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _taps(k):
    """Filter taps as the float32 values the JAX package multiplies by."""
    return [float(np.float32(v)) for v in k]


GAUSS5 = _taps(np.array([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0)
SCHARR_D = _taps(np.array([-1.0, 0.0, 1.0]) / 2.0)
SCHARR_S = _taps(np.array([3.0, 10.0, 3.0]) / 16.0)
BOX3 = _taps(np.ones(3) / 3)


def _sep_conv(img, kx, ky):
    """Separable 2-D 'same' (zero-pad) filter as shifted multiply-adds.
    img (B,H,W); kx, ky lists of taps."""
    H, W = img.shape[-2:]
    ry, rx = len(ky) // 2, len(kx) // 2
    p = F.pad(img, (0, 0, ry, ry))
    v = ky[0] * p[:, 0:H]
    for a in range(1, len(ky)):
        v = v + ky[a] * p[:, a:a + H]
    p = F.pad(v, (rx, rx))
    out = kx[0] * p[:, :, 0:W]
    for b in range(1, len(kx)):
        out = out + kx[b] * p[:, :, b:b + W]
    return out


def gauss_blur(img):
    return _sep_conv(img, GAUSS5, GAUSS5)


def pyr_down(img):
    """Blur + decimate by 2 (cv::pyrDown), the blur formed only at the even
    output positions."""
    H, W = img.shape[-2:]
    H2, W2 = H // 2, W // 2
    p = F.pad(img, (0, 0, 2, 2))
    v = GAUSS5[0] * p[:, 0:2 * H2:2]
    for a in range(1, 5):
        v = v + GAUSS5[a] * p[:, a:a + 2 * H2:2]
    p = F.pad(v, (2, 2))
    out = GAUSS5[0] * p[:, :, 0:2 * W2:2]
    for b in range(1, 5):
        out = out + GAUSS5[b] * p[:, :, b:b + 2 * W2:2]
    return out


def build_pyramid(img, levels: int):
    """List of `levels` images, level 0 = input."""
    pyr = [img]
    for _ in range(levels - 1):
        pyr.append(pyr_down(pyr[-1]))
    return pyr


def gradients(img):
    """(gx, gy) Scharr-style gradients."""
    return _sep_conv(img, SCHARR_D, SCHARR_S), _sep_conv(img, SCHARR_S, SCHARR_D)


def hist_equalize(img, bins: int = 256):
    """Global histogram equalization through a LUT (the reference uses
    cv::equalizeHist; a global equalize normalizes contrast for tracking).

    Pixels clipped to [0, 1] are binned as `jnp.histogram(range=(0, 1),
    bins=bins)` bins them: against the float32 edges k / bins, each pixel in
    the bin of the last edge at or below it (`searchsorted` on the right),
    the last edge inclusive.  The counts are exact integers, so the
    float32 CDF equals JAX's; the LUT index is floor(x (bins - 1)) in
    float32.  img (B,H,W) f32 -> (B,H,W) f32."""
    B = img.shape[0]
    flat = torch.clamp(img.reshape(B, -1), 0.0, 1.0)
    edges = torch.linspace(0.0, 1.0, bins + 1, dtype=torch.float64,
                           device=img.device).to(img.dtype)
    idx = torch.searchsorted(edges, flat, right=True)
    idx = torch.where(flat == edges[-1], bins, idx)  # the last edge is inclusive
    hist = torch.zeros((B, bins + 1), dtype=torch.int64, device=img.device)
    hist = hist.scatter_add_(1, idx, torch.ones_like(idx))[:, 1:]
    cdf = torch.cumsum(hist, dim=-1).to(img.dtype)
    cdf = cdf / cdf[:, -1:]
    lut = torch.clamp((flat * (bins - 1)).to(torch.int32), 0, bins - 1).long()
    return torch.gather(cdf, 1, lut).reshape(img.shape)


def hist_equalize_quantile(img, knots: int = 17):
    """Piecewise-linear CDF through `knots` quantiles of a 4x-strided
    subsample, applied as clamp-accumulates.

    The quantiles are numpy's (and JAX's) "linear" method: one sort of the
    subsample, then interpolation between the two order statistics around
    q (n - 1), in float64, cast to float32.  The positions are computed here
    on the device from the static subsample size, so nothing waits for the
    device (`torch.quantile` checks a tensor q on the host)."""
    B = img.shape[0]
    flat = img[:, ::4, ::4].reshape(B, -1)
    n = flat.shape[-1]
    srt = torch.sort(flat, dim=-1).values
    # q (n - 1) with q = k / (knots - 1): exact in float64, as JAX forms it
    pos = torch.arange(knots, dtype=torch.float64, device=img.device) * ((n - 1) / (knots - 1))
    lo, hi = torch.floor(pos), torch.ceil(pos)
    hw = pos - lo
    low = torch.index_select(srt, 1, lo.long().clamp(0, n - 1)).double()
    high = torch.index_select(srt, 1, hi.long().clamp(0, n - 1)).double()
    qs = (low * (1.0 - hw) + high * hw).to(img.dtype)
    # monotonicity guard for flat regions (equal quantiles)
    denom = torch.clamp(qs[:, 1:] - qs[:, :-1], min=1e-6)
    out = torch.zeros_like(img)
    for k in range(knots - 1):
        out = out + torch.clamp((img - qs[:, k, None, None]) / denom[:, k, None, None], 0.0, 1.0)
    return out * (1.0 / (knots - 1))


def shi_tomasi_score(img):
    """Min-eigenvalue corner response over a 3x3 window."""
    gx, gy = gradients(img)
    gxx = _sep_conv(gx * gx, BOX3, BOX3)
    gyy = _sep_conv(gy * gy, BOX3, BOX3)
    gxy = _sep_conv(gx * gy, BOX3, BOX3)
    tr = gxx + gyy
    det = gxx * gyy - gxy * gxy
    disc = torch.sqrt(torch.clamp(tr * tr / 4.0 - det, min=0.0))
    return tr / 2.0 - disc


def bilinear_sample(img, xy):
    """Bilinear samples of a (C, H, W) stack at subpixel points xy (..., 2)
    = (x, y): (C, ...).  Coordinates clamp to [0, W - 1.001] x [0, H -
    1.001] (callers mask out-of-bounds points separately); the four taps
    are gathered at once and weighted in the JAX package's order of
    products and sums."""
    C, H, W = img.shape
    x = torch.clamp(xy[..., 0], 0.0, W - 1.001)
    y = torch.clamp(xy[..., 1], 0.0, H - 1.001)
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    at = y0.long() * W + x0.long()
    taps = img.reshape(C, H * W)[:, torch.stack([at, at + 1, at + W, at + W + 1])]
    i00, i01, i10, i11 = taps.unbind(1)
    gx, gy = 1 - fx, 1 - fy
    return i00 * gx * gy + i01 * fx * gy + i10 * gx * fy + i11 * fx * fy


def bilinear_sample_batch(img, xy):
    """`bilinear_sample` per sequence: a (B, C, H, W) stack sampled at its
    own sequence's points xy (B, ..., 2) = (x, y): (B, C, ...), with the same
    clamping, taps and order of products and sums.  A NaN coordinate samples
    NaN (its taps' index is clamped into the image, as JAX's gather clamps)."""
    B, C, H, W = img.shape
    x = torch.clamp(xy[..., 0], 0.0, W - 1.001)
    y = torch.clamp(xy[..., 1], 0.0, H - 1.001)
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    at = (y0.long().clamp(0, H - 2) * W + x0.long().clamp(0, W - 2)).reshape(B, -1)
    idx = torch.cat([at, at + 1, at + W, at + W + 1], dim=1)
    taps = torch.gather(img.reshape(B, C, H * W), 2, idx[:, None].expand(B, C, -1))
    i00, i01, i10, i11 = taps.reshape((B, C, 4) + xy.shape[1:-1]).unbind(2)
    gx, gy = (1 - fx)[:, None], (1 - fy)[:, None]
    fx, fy = fx[:, None], fy[:, None]
    return i00 * gx * gy + i01 * fx * gy + i10 * gx * fy + i11 * fx * fy
