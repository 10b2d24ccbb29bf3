"""Plücker line algebra (port of plviwo_tpu/ops/plucker.py).

Line L = (n, v): v = direction, n = p x v (moment) for any point p on the
line.  All ops are batched over leading dims.
"""

from __future__ import annotations

import torch

from . import lie


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def _norm(x):
    return torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def transform(n_G, v_G, R_GtoC, p_CinG):
    """n_C = R_GtoC (n_G - p_CinG x v_G);  v_C = R_GtoC v_G."""
    n_local = n_G - _cross(p_CinG, v_G)
    n_C = torch.einsum("...ij,...j->...i", R_GtoC, n_local)
    v_C = torch.einsum("...ij,...j->...i", R_GtoC, v_G)
    return n_C, v_C


def line_projection_matrix(k):
    """K_L (...,3,3): camera-frame moment -> homogeneous pixel line."""
    fx, fy, cx, cy = k[..., 0], k[..., 1], k[..., 2], k[..., 3]
    z = torch.zeros_like(fx)
    return torch.stack(
        [
            torch.stack([fy, z, z], -1),
            torch.stack([z, fx, z], -1),
            torch.stack([-fy * cx, -fx * cy, fx * fy], -1),
        ],
        -2,
    )


def project(n_C, k):
    """Project the camera-frame line to the pixel homogeneous line l (...,3)."""
    return torch.einsum("...ij,...j->...i", line_projection_matrix(k), n_C)


def point_line_distance(uv, l):
    """Signed distance of pixel point uv (...,2) from homogeneous line l (...,3)."""
    denom = torch.sqrt(l[..., 0] ** 2 + l[..., 1] ** 2)
    denom = torch.where(denom < 1e-12, torch.ones_like(denom), denom)
    return (l[..., 0] * uv[..., 0] + l[..., 1] * uv[..., 1] + l[..., 2]) / denom


def to_orthonormal(n, v):
    """Plücker (n, v) -> orthonormal (U (...,3,3), w (...,2))."""
    nn = _norm(n)
    nv = _norm(v)
    u1 = n / torch.clamp(nn, min=1e-12)
    u2 = v / torch.clamp(nv, min=1e-12)
    u3 = _cross(u1, u2)
    u3 = u3 / torch.clamp(_norm(u3), min=1e-12)
    U = torch.stack([u1, u2, u3], dim=-1)
    scale = torch.sqrt(nn**2 + nv**2)
    w = torch.cat([nn, nv], dim=-1) / torch.clamp(scale, min=1e-12)
    return U, w


def from_orthonormal(U, w, scale=1.0):
    """Inverse of to_orthonormal up to overall scale."""
    return scale * w[..., 0:1] * U[..., :, 0], scale * w[..., 1:2] * U[..., :, 1]


def apply_orthonormal_delta(n, v, d4):
    """Apply a 4-dof update d4 = [dtheta(3), dphi]: U' = U exp(dtheta),
    w' = rot(dphi) w; the overall scale |(n, v)| is preserved."""
    U, w = to_orthonormal(n, v)
    mag = torch.sqrt(torch.sum(n * n, dim=-1, keepdim=True)
                     + torch.sum(v * v, dim=-1, keepdim=True))
    U2 = U @ lie.exp_so3(d4[..., 0:3])
    c, s = torch.cos(d4[..., 3:4]), torch.sin(d4[..., 3:4])
    w1 = c * w[..., 0:1] - s * w[..., 1:2]
    w2 = s * w[..., 0:1] + c * w[..., 1:2]
    return mag * w1 * U2[..., :, 0], mag * w2 * U2[..., :, 1]


def closest_point_to_origin(n, v):
    """Point on the line closest to the origin: p = v x n / |v|^2."""
    v2 = torch.sum(v * v, dim=-1, keepdim=True)
    return _cross(v, n) / torch.clamp(v2, min=1e-12)
