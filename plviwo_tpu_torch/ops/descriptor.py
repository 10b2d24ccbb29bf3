"""Binary descriptors and matching (port of plviwo_tpu/ops/descriptor.py),
batch-first.

The reference's descriptor front-end (`ov_core::TrackDescriptor`,
track/TrackDescriptor.cpp: ORB descriptors and ratio-test matching) as
tensor programs:

- BRIEF-style binary descriptors: a fixed random point-pair pattern sampled
  bilinearly from the 3 x 3 box-smoothed image around every corner, all
  corners' pairs in one gather; (B, N, bits) bool, no orientation;
- matching: the Hamming-distance matrix as one product of 0/1 floats
  (exact: the counts are small integers), then the ratio test, the
  mutual-best test and the distance gate, with `argmin` taking the first of
  equal distances as JAX's does.

The smoothing is shifted multiply-adds of the zero-padded image (as
`image._sep_conv`), no convolution call: cuDNN would run a float32
convolution in TF32 on the card.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

F32 = torch.float32
_NINTH = float(np.float32(1.0 / 9.0))


def brief_pattern(n_bits: int = 256, half: float = 12.0, seed: int = 3):
    """Fixed Gaussian point-pair pattern (n_bits, 4) = [x1 y1 x2 y2], float32
    numpy (the JAX package's draws: `default_rng(seed)`)."""
    rng = np.random.default_rng(seed)
    pat = np.clip(rng.normal(0.0, half / 2.5, size=(n_bits, 4)), -half, half)
    return pat.astype(np.float32)


def _smooth3(img):
    """3 x 3 box smoothing of (B,H,W) with zero padding ("same" size), as
    convolve2d(mode="same") with ones / 9 computes it."""
    H, W = img.shape[-2:]
    p = F.pad(img, (1, 1, 1, 1))
    out = None
    for a in range(3):
        for b in range(3):
            term = p[:, a:a + H, b:b + W] * _NINTH
            out = term if out is None else out + term
    return out


def _bilinear(img, x, y):
    """Bilinear samples of (B,H,W) at x, y (B,...): the cell corner clipped
    to [0, w-2] x [0, h-2] and the fraction to [0, 1] (not
    `image.bilinear_sample`'s clamping)."""
    B, h, w = img.shape
    x0 = torch.clamp(torch.floor(x).to(torch.int64), 0, w - 2)
    y0 = torch.clamp(torch.floor(y).to(torch.int64), 0, h - 2)
    fx = torch.clamp(x - x0, 0.0, 1.0)
    fy = torch.clamp(y - y0, 0.0, 1.0)
    at = (y0 * w + x0).reshape(B, -1)
    taps = torch.gather(img.reshape(B, h * w), 1, torch.cat([at, at + 1, at + w, at + w + 1], 1))
    v00, v01, v10, v11 = taps.reshape((B, 4) + x.shape[1:]).unbind(1)
    return (v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy)
            + v10 * (1 - fx) * fy + v11 * fx * fy)


def describe(img, uv, valid, pattern):
    """BRIEF descriptors at corners.

    img (B,H,W); uv (B,N,2); valid (B,N); pattern (bits,4) f32 tensor.
    Returns (B,N,bits) bool, False on invalid corners."""
    sm = _smooth3(img.to(F32))
    uv = uv.to(F32)
    x = uv[..., 0, None]
    y = uv[..., 1, None]
    xs = torch.stack([x + pattern[:, 0], x + pattern[:, 2]], dim=1)  # (B,2,N,bits)
    ys = torch.stack([y + pattern[:, 1], y + pattern[:, 3]], dim=1)
    v = _bilinear(sm, xs, ys)
    return (v[:, 0] < v[:, 1]) & valid[..., None]


def match(d1, valid1, d2, valid2, max_dist: float = 80.0, ratio: float = 0.8):
    """Mutual-best ratio-test matching over the Hamming distance matrix.

    d1 (B,N1,bits), d2 (B,N2,bits) bool with validity masks (B,N1), (B,N2).
    Returns idx2 (B,N1) int64: the match in d2, or -1 (reference:
    TrackDescriptor::robust_match's ratio test and symmetry check)."""
    bits = d1.shape[-1]
    a = d1.to(F32)
    b = d2.to(F32)
    # hamming = bits - agree; agree = a.b + (1-a).(1-b)
    agree = a @ b.transpose(1, 2) + (1 - a) @ (1 - b).transpose(1, 2)
    big = float(4 * bits)
    dist = torch.where(valid1[..., None] & valid2[:, None], bits - agree, big)
    dbest = torch.amin(dist, dim=2)
    best2 = torch.argmin(dist, dim=2)  # the first of equal distances
    dsecond = torch.min(dist.scatter(2, best2[..., None], big), dim=2).values
    ok = (dbest < max_dist) & (dbest < ratio * dsecond) & valid1
    # symmetry: row i must also be the best row of column best2[i]
    best1 = torch.argmin(dist, dim=1)  # (B,N2)
    rows = torch.arange(dist.shape[1], device=dist.device)
    ok = ok & (torch.gather(best1, 1, best2) == rows)
    return torch.where(ok, best2, -1)
