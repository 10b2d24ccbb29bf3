"""On-manifold pose interpolation between clones (port of
plviwo_tpu/core/interp.py: `interpolate_pose_linear` only).

The polynomial interpolation and the interpolation tables of the JAX module
serve dynamic cloning and the per-track path (ROADMAP A8, A9) and are not
ported yet.
"""

from __future__ import annotations

from ..ops import lie


def interpolate_pose_linear(q0, p0, q1, p1, lam):
    """Geodesic interpolation between two JPL poses (...,4), (...,3) at
    fraction lam (...,) in [0, 1]:

        R(lam) = exp(lam log(R1 R0^T)) R0,   p(lam) = (1 - lam) p0 + lam p1.

    Returns (R (...,3,3), p (...,3))."""
    R0 = lie.quat_2_rot(q0)
    R1 = lie.quat_2_rot(q1)
    w = lie.log_so3(R1 @ R0.transpose(-1, -2))
    R_t = lie.exp_so3(lam[..., None] * w) @ R0
    p_t = (1.0 - lam[..., None]) * p0 + lam[..., None] * p1
    return R_t, p_t
