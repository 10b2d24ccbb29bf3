"""Camera projection models (port of plviwo_tpu/ops/cam.py).

Pure functions over (...,2) point tensors and (...,8) intrinsics
k = [fx, fy, cx, cy, d0, d1, d2, d3] (radtan: d = [k1 k2 p1 p2]; equi:
d = [k1 k2 k3 k4]).  `undistort` is the fixed-iteration Newton solve of the
JAX package, with the 2x2 Jacobian in closed form (a `jvp` per iteration
costs thousands of host operators a frame); the image front-end runs it
in float64.
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


def _jac_radtan(zn, k):
    """d(distorted normalized coords)/d(zn) (...,2,2) of the radtan model,
    in closed form (the JAX package takes it with jax.jacfwd)."""
    x, y = zn[..., 0], zn[..., 1]
    k1, k2, p1, p2 = k[..., 4], k[..., 5], k[..., 6], k[..., 7]
    r2 = x * x + y * y
    rad = 1.0 + k1 * r2 + k2 * r2 * r2
    drad = 2.0 * (k1 + 2.0 * k2 * r2)  # d rad / d r2, times 2
    cross = x * y * drad + 2.0 * p1 * x + 2.0 * p2 * y
    return torch.stack([
        torch.stack([rad + x * x * drad + 2.0 * p1 * y + 6.0 * p2 * x, cross], dim=-1),
        torch.stack([cross, rad + y * y * drad + 6.0 * p1 * y + 2.0 * p2 * x], dim=-1)], dim=-2)


def _jac_equi(zn, k):
    """d(distorted normalized coords)/d(zn) (...,2,2) of the equidistant
    model, in closed form; the identity below r = 1e-8, where the model's
    scale is the constant 1."""
    x, y = zn[..., 0], zn[..., 1]
    k1, k2, k3, k4 = k[..., 4], k[..., 5], k[..., 6], k[..., 7]
    r = torch.sqrt(x * x + y * y)
    small = r < 1e-8
    r = torch.where(small, torch.ones_like(r), r)
    th = torch.atan(r)
    t2 = th * th
    thd = th * (1.0 + k1 * t2 + k2 * t2**2 + k3 * t2**3 + k4 * t2**4)
    dthd = (1.0 + 3.0 * k1 * t2 + 5.0 * k2 * t2**2 + 7.0 * k3 * t2**3
            + 9.0 * k4 * t2**4) / (1.0 + r * r)
    s = torch.where(small, torch.ones_like(r), thd / r)
    ds = torch.where(small, torch.zeros_like(r), (dthd * r - thd) / (r * r * r))  # (ds/dr) / r
    cross = x * y * ds
    return torch.stack([torch.stack([s + x * x * ds, cross], dim=-1),
                        torch.stack([cross, s + y * y * ds], dim=-1)], dim=-2)


def _undistort_newton(uv, k, distort_fn, jac_fn, iters: int):
    """Fixed-iteration Newton solve for zn such that distort(zn) = uv."""
    fx, fy, cx, cy, _ = _split(k)
    zn = torch.stack([(uv[..., 0] - cx) / fx, (uv[..., 1] - cy) / fy], dim=-1)
    for _ in range(iters):
        # residual in normalized units (divide out focal) for conditioning
        uv_pred = distort_fn(zn, k)
        r0 = (uv_pred[..., 0] - uv[..., 0]) / fx
        r1 = (uv_pred[..., 1] - uv[..., 1]) / fy
        J = jac_fn(zn, k)
        det = J[..., 0, 0] * J[..., 1, 1] - J[..., 0, 1] * J[..., 1, 0]
        det = torch.where(torch.abs(det) < 1e-12, torch.ones_like(det), det)
        dx = (J[..., 1, 1] * r0 - J[..., 0, 1] * r1) / det
        dy = (-J[..., 1, 0] * r0 + J[..., 0, 0] * r1) / det
        zn = zn - torch.stack([dx, dy], dim=-1)
    return zn


def undistort_radtan(uv, k, iters: int = 8):
    """Pixel coords (...,2) -> normalized coords (...,2), radtan model."""
    return _undistort_newton(uv, k, distort_radtan, _jac_radtan, iters)


def undistort_equi(uv, k, iters: int = 8):
    """Pixel coords (...,2) -> normalized coords (...,2), equidistant model."""
    return _undistort_newton(uv, k, distort_equi, _jac_equi, iters)


def undistort(uv, k, model: int, iters: int = 8):
    """k (...,8) broadcastable to uv's batch (e.g. (B,1,8) for uv (B,N,2))."""
    return undistort_radtan(uv, k, iters) if model == RADTAN else undistort_equi(uv, k, iters)


def project(p_C, k, model: int):
    """3-D points in camera frame (...,3) -> distorted pixel coords (...,2)."""
    return distort(p_C[..., :2] / p_C[..., 2:3], k, model)
