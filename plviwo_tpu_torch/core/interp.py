"""On-manifold pose interpolation between clones (port of
plviwo_tpu/core/interp.py: the linear interpolation and its Jacobian).

The linear interpolation serves the GPS rows and dynamic cloning's point
rows, which both spread a measurement at an arbitrary time over its two
bounding clones.  The JAX package takes the Jacobian with respect to those
clones by `jax.jacfwd`; here it is written in closed form
(`interpolate_rotation_jacobian`), since a forward-mode pass through
`log_so3` and `exp_so3` costs hundreds of host operators a call.  The
polynomial interpolation and the interpolation tables of the JAX module
serve the per-track path (ROADMAP A9) and are not ported yet.
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


def interpolate_rotation_jacobian(q0, q1, lam):
    """The interpolated rotation R(lam) and how it moves with the two
    clones' JPL attitude errors (R_i' = (I - [dtheta_i]x) R_i).

    With w = log(R1 R0^T) and E = exp(lam w), a left perturbation psi of
    R(lam) (R(lam)' = exp(psi) R(lam)) is

      psi = (lam Jl(lam w) Jr^-1(w) - E) dtheta0 - lam Jl(lam w) Jl^-1(w) dtheta1

    (Jr^-1(w) = Jl^-1(w)^T); the position p(lam) moves by (1 - lam) dp0 +
    lam dp1.  q0, q1 (...,4), lam (...,).  Returns (R (...,3,3),
    J0 (...,3,3), J1 (...,3,3)) with psi = J0 dtheta0 + J1 dtheta1."""
    R0 = lie.quat_2_rot(q0)
    w = lie.log_so3(lie.quat_2_rot(q1) @ R0.transpose(-1, -2))
    lw = lam[..., None] * w
    E = lie.exp_so3(lw)
    lJ = lam[..., None, None] * lie.jl_so3(lw)
    Jli = lie.jl_so3_inv(w)
    return E @ R0, lJ @ Jli.transpose(-1, -2) - E, -(lJ @ Jli)
