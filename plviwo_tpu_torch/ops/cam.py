"""Camera projection models (port of plviwo_tpu/ops/cam.py).

Pure functions over (...,2) point tensors and (...,8) intrinsics
k = [fx, fy, cx, cy, d0, d1, d2, d3] (radtan: d = [k1 k2 p1 p2]; equi:
d = [k1 k2 k3 k4]).  `undistort` is not ported yet: it belongs to the image
front-end.
"""

from __future__ import annotations

import torch

from .jac import jacfwd_batched

RADTAN = 0
EQUI = 1


def _split(k):
    return k[..., 0], k[..., 1], k[..., 2], k[..., 3], k[..., 4:8]


def distort_radtan(zn, k):
    """Normalized coords (...,2) -> pixel coords (...,2), radtan model."""
    fx, fy, cx, cy, d = _split(k)
    x, y = zn[..., 0], zn[..., 1]
    k1, k2, p1, p2 = d[..., 0], d[..., 1], d[..., 2], d[..., 3]
    r2 = x * x + y * y
    rad = 1.0 + k1 * r2 + k2 * r2 * r2
    xd = x * rad + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * rad + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([fx * xd + cx, fy * yd + cy], dim=-1)


def distort_equi(zn, k):
    """Normalized coords (...,2) -> pixel coords (...,2), equidistant model."""
    fx, fy, cx, cy, d = _split(k)
    x, y = zn[..., 0], zn[..., 1]
    k1, k2, k3, k4 = d[..., 0], d[..., 1], d[..., 2], d[..., 3]
    r = torch.sqrt(x * x + y * y)
    small = r < 1e-8
    r_safe = torch.where(small, torch.ones_like(r), r)
    th = torch.atan(r)
    th2 = th * th
    thd = th * (1.0 + k1 * th2 + k2 * th2**2 + k3 * th2**3 + k4 * th2**4)
    scale = torch.where(small, torch.ones_like(r), thd / r_safe)
    return torch.stack([fx * x * scale + cx, fy * y * scale + cy], dim=-1)


def distort(zn, k, model: int):
    return distort_radtan(zn, k) if model == RADTAN else distort_equi(zn, k)


def distort_jacobian(zn, k, model: int):
    """Jacobians of the distorted pixel coords wrt zn and wrt the intrinsics.

    zn (...,2), k (...,8) broadcastable to zn's batch.  Returns
    (dz_dzn (...,2,2), dz_dk (...,2,8)), by forward-mode autodiff as the JAX
    version uses `jax.jacfwd`."""
    fn = distort_radtan if model == RADTAN else distort_equi
    kb = k.expand(zn.shape[:-1] + (8,))
    return jacfwd_batched(fn, (zn, kb), (0, 1))


def project(p_C, k, model: int):
    """3-D points in camera frame (...,3) -> distorted pixel coords (...,2)."""
    return distort(p_C[..., :2] / p_C[..., 2:3], k, model)
