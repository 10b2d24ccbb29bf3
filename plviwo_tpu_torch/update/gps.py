"""GPS position rows (port of plviwo_tpu/update/gps.py:
`gps_linear_system` only), batch-first.

The host-side `GpsUpdater` (the datum, the keyframe buffer and the 4-DoF
world-to-ENU initialization) belongs to the host-side `VioSystem` (ROADMAP
A7b) and is not ported yet; the fused frame assumes the world frame is the ENU
frame, as the JAX engine does after that initialization.
"""

from __future__ import annotations

import torch

from ..core.interp import interpolate_pose_linear
from ..ops import lie


def _antenna_jacobian(q0, p0, q1, p1, lam, ext_p):
    """d(antenna)/d[dx0, dx1] (...,3,12) of the antenna p(lam) + R(lam)^T ext_p
    at the pose interpolated between two clones, each perturbed by a JPL
    error state dx = [dtheta, dp] (R' = (I - [dtheta]x) R, p' = p + dp).

    With w = log(R1 R0^T) and E = exp(lam w), a left perturbation psi of
    R(lam) moves the antenna by R(lam)^T [ext_p]x psi, and
      psi = (lam Jl(lam w) Jr^-1(w) - E) dtheta0 - lam Jl(lam w) Jl^-1(w) dtheta1
    (Jr^-1(w) = Jl^-1(w)^T); the position block is (1 - lam) I, lam I.  The
    JAX package takes the same Jacobian by `jax.jacfwd`; this closed form is
    a few dozen operators instead of a forward-mode pass through log and
    exp."""
    R0 = lie.quat_2_rot(q0)
    w = lie.log_so3(lie.quat_2_rot(q1) @ R0.transpose(-1, -2))
    lw = lam[..., None] * w
    E = lie.exp_so3(lw)
    A = (E @ R0).transpose(-1, -2) @ lie.skew(ext_p.expand(w.shape))
    Jl, Jli = lie.jl_so3(lw), lie.jl_so3_inv(w)
    lm = lam[..., None, None]
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(A.shape)
    return torch.cat([A @ (lm * Jl @ Jli.transpose(-1, -2) - E), (1.0 - lm) * eye,
                      -lm * (A @ Jl @ Jli), lm * eye], dim=-1)


def gps_linear_system(clone_q, clone_p, clone_q_fej, clone_p_fej, slot0, slot1, lam,
                      gps_ext_p, meas):
    """3-row position systems of fixes at interpolated poses.

    clone_* (B,C,4/3); slot0, slot1, lam (B,Ng); gps_ext_p (B,3) the antenna
    in the IMU frame; meas (B,Ng,3).  Returns (H6 (B,Ng,3,12) with respect
    to [clone slot0 (6), clone slot1 (6)] at the FEJ clones, and res
    (B,Ng,3))."""
    def at(x, slot):
        return torch.gather(x, 1, slot[..., None].expand(slot.shape + x.shape[-1:]))

    ext = gps_ext_p[:, None]
    R_t, p_t = interpolate_pose_linear(at(clone_q, slot0), at(clone_p, slot0),
                                       at(clone_q, slot1), at(clone_p, slot1), lam)
    pred = p_t + (R_t.transpose(-1, -2) @ ext[..., None])[..., 0]
    H6 = _antenna_jacobian(at(clone_q_fej, slot0), at(clone_p_fej, slot0),
                           at(clone_q_fej, slot1), at(clone_p_fej, slot1), lam, ext)
    return H6, meas - pred
