"""JPL-quaternion, SO(3) and SE(3) operations (port of plviwo_tpu/ops/lie.py).

JPL convention: q = [x y z w], scalar last, R(q1 (x) q2) = R(q1) R(q2), and
`quat_2_rot(q_GtoI) = R_GtoI`.  Every op takes arbitrary leading batch
dimensions and is branch-free (`torch.where` guards at the small-angle
limits), so it runs unchanged on batch-first tensors and under
`torch.func.jacfwd`.  Nothing here assumes a dtype.
"""

from __future__ import annotations

import torch

_EPS = 1e-12


def skew(v):
    """Skew-symmetric matrix of v (...,3) -> (...,3,3)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def quat_norm(q):
    """Normalize quaternion, enforcing w >= 0 (JPL sign convention)."""
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return torch.where(q[..., 3:4] < 0, -q, q)


def quat_multiply(q, p):
    """JPL quaternion product q (x) p with R(q (x) p) = R(q) R(p)."""
    qv, qw = q[..., :3], q[..., 3:4]
    pv, pw = p[..., :3], p[..., 3:4]
    qv, pv = torch.broadcast_tensors(qv, pv)
    v = qw * pv + pw * qv - torch.linalg.cross(qv, pv, dim=-1)
    w = qw * pw - torch.sum(qv * pv, dim=-1, keepdim=True)
    return quat_norm(torch.cat([v, w], dim=-1))


def _eye3(like):
    eye = torch.eye(3, dtype=like.dtype, device=like.device)
    return eye.expand(like.shape[:-1] + (3, 3))


def quat_2_rot(q):
    """JPL quaternion (...,4) -> rotation matrix (...,3,3) (Trawny eq. 78)."""
    qv = q[..., :3]
    w = q[..., 3]
    outer = qv[..., :, None] * qv[..., None, :]
    return (
        (2.0 * w**2 - 1.0)[..., None, None] * _eye3(qv)
        - 2.0 * w[..., None, None] * skew(qv)
        + 2.0 * outer
    )


def rot_2_quat(R):
    """Rotation matrix (...,3,3) -> JPL quaternion (...,4), branch-free Shepperd."""
    t = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    r00, r11, r22 = R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]

    sw = torch.sqrt(torch.clamp(1.0 + t, min=_EPS))
    inv = 0.5 / sw
    cw = torch.stack(
        [
            (R[..., 1, 2] - R[..., 2, 1]) * inv,
            (R[..., 2, 0] - R[..., 0, 2]) * inv,
            (R[..., 0, 1] - R[..., 1, 0]) * inv,
            0.5 * sw,
        ],
        dim=-1,
    )

    def axis_candidate(i, j, k):
        s = torch.sqrt(torch.clamp(1.0 + R[..., i, i] - R[..., j, j] - R[..., k, k], min=_EPS))
        invs = 0.5 / s
        comp = [None, None, None, None]
        comp[i] = 0.5 * s
        comp[j] = (R[..., i, j] + R[..., j, i]) * invs
        comp[k] = (R[..., i, k] + R[..., k, i]) * invs
        comp[3] = (R[..., j, k] - R[..., k, j]) * invs
        return torch.stack(comp, dim=-1)

    cands = torch.stack(
        [cw, axis_candidate(0, 1, 2), axis_candidate(1, 2, 0), axis_candidate(2, 0, 1)],
        dim=-2,
    )  # (...,4cand,4)
    # argmax returns the first of tied maxima, as jnp.argmax does
    best = torch.argmax(torch.stack([t, r00, r11, r22], dim=-1), dim=-1)
    idx = best[..., None, None].expand(best.shape + (1, 4))
    return quat_norm(torch.gather(cands, -2, idx)[..., 0, :])


def omega(w):
    """Omega(w) (...,3) -> (...,4,4) such that q_dot = 0.5 Omega(w) q (JPL)."""
    top = torch.cat([-skew(w), w[..., :, None]], dim=-1)
    bot = torch.cat([-w[..., None, :], torch.zeros_like(w[..., :1, None])], dim=-1)
    return torch.cat([top, bot], dim=-2)


def _theta2_safe(w):
    """(th2, th_safe): squared angle and a trig-safe angle clamped away from 0."""
    th2 = torch.sum(w * w, dim=-1)
    small = th2 < 1e-14
    return th2, torch.sqrt(torch.where(small, torch.ones_like(th2), th2))


def _cancel_cut(dtype):
    """Taylor-branch cutoff on th^2 (see plviwo_tpu.ops.lie._cancel_cut)."""
    return 0.09 if torch.finfo(dtype).eps > 1e-10 else 1e-6


def exp_so3(w):
    """so(3) exponential: (...,3) -> (...,3,3), small-angle safe."""
    th2, th = _theta2_safe(w)
    smallc = th2 < _cancel_cut(w.dtype)
    a = torch.where(smallc, 1.0 - th2 / 6.0 + th2 * th2 / 120.0, torch.sin(th) / th)
    s2 = torch.sin(th / 2.0)
    b = torch.where(smallc, 0.5 - th2 / 24.0 + th2 * th2 / 720.0, 2.0 * s2 * s2 / (th * th))
    sk = skew(w)
    return _eye3(w) + a[..., None, None] * sk + b[..., None, None] * (sk @ sk)


def log_so3(R):
    """SO(3) log (...,3,3) -> (...,3), active convention (log(exp(w)) == w)."""
    q = rot_2_quat(R)
    qv = q[..., :3]
    w = torch.clamp(q[..., 3], -1.0, 1.0)
    n2 = torch.sum(qv * qv, dim=-1)
    small = n2 < 1e-18
    n = torch.sqrt(torch.where(small, torch.ones_like(n2), n2))
    th = 2.0 * torch.atan2(n, w)
    scale = torch.where(small, 2.0 / torch.clamp(w, min=1e-12), th / n)
    return -qv * scale[..., None]


def jl_so3(w):
    """Left Jacobian of SO(3)."""
    th2, th = _theta2_safe(w)
    sk = skew(w)
    s2 = torch.sin(th / 2.0)
    small = th2 < _cancel_cut(w.dtype)
    a = torch.where(small, 0.5 - th2 / 24.0 + th2 * th2 / 720.0, 2.0 * s2 * s2 / (th * th))
    b = torch.where(
        small, 1.0 / 6.0 - th2 / 120.0 + th2 * th2 / 5040.0,
        (th - torch.sin(th)) / (th * th * th),
    )
    return _eye3(w) + a[..., None, None] * sk + b[..., None, None] * (sk @ sk)


def jr_so3(w):
    """Right Jacobian of SO(3): Jr(w) = Jl(-w)."""
    return jl_so3(-w)


def gamma2_so3(w):
    """Second-order SO(3) integral Gamma2(u) = int_0^1 int_0^s exp(u^ t) dt ds
    = 1/2 I + ((th - sin th)/th^3) u^ + ((th^2/2 + cos th - 1)/th^4) u^^2,
    with the Taylor branch of `jl_so3` below the cancellation cutoff.  With
    u = omega dt, dt^2 Gamma2(u) is the double integral of exp(omega^ tau)
    that CPI V2's closed-form position increment needs."""
    th2, th = _theta2_safe(w)
    sk = skew(w)
    small = th2 < _cancel_cut(w.dtype)
    a = torch.where(small, 1.0 / 6.0 - th2 / 120.0 + th2 * th2 / 5040.0,
                    (th - torch.sin(th)) / (th * th * th))
    s2 = torch.sin(th / 2.0)
    b = torch.where(small, 1.0 / 24.0 - th2 / 720.0 + th2 * th2 / 40320.0,
                    (th * th / 2.0 - 2.0 * s2 * s2) / (th2 * th2))
    return 0.5 * _eye3(w) + a[..., None, None] * sk + b[..., None, None] * (sk @ sk)


def unskew(m):
    """Inverse of skew: (...,3,3) -> (...,3)."""
    return torch.stack([m[..., 2, 1], m[..., 0, 2], m[..., 1, 0]], dim=-1)


def jl_so3_inv(w):
    """Inverse left Jacobian of SO(3)."""
    th2, th = _theta2_safe(w)
    sk = skew(w)
    half = th / 2.0
    cot = half / torch.tan(half)
    small = th2 < _cancel_cut(w.dtype)
    b = torch.where(small, 1.0 / 12.0 + th2 / 720.0 + th2 * th2 / 30240.0,
                    (1.0 - cot) / (th * th))
    return _eye3(w) - 0.5 * sk + b[..., None, None] * (sk @ sk)


def _se3(R, p):
    """(...,3,3), (...,3) -> (...,4,4) homogeneous transform."""
    top = torch.cat([R, p[..., :, None]], dim=-1)
    bot = torch.zeros(R.shape[:-2] + (1, 4), dtype=R.dtype, device=R.device)
    bot[..., 0, 3] = 1.0
    return torch.cat([top, bot], dim=-2)


def exp_se3(xi):
    """se(3) exp: xi = [omega, rho] (...,6) -> (...,4,4)."""
    w, rho = xi[..., :3], xi[..., 3:]
    return _se3(exp_so3(w), (jl_so3(w) @ rho[..., :, None])[..., 0])


def log_se3(T):
    """SE(3) log: (...,4,4) -> (...,6) [omega, rho]."""
    w = log_so3(T[..., :3, :3])
    rho = (jl_so3_inv(w) @ T[..., :3, 3:4])[..., 0]
    return torch.cat([w, rho], dim=-1)


def inv_se3(T):
    """SE(3) inverse (...,4,4)."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    return _se3(Rt, -(Rt @ T[..., :3, 3:4])[..., 0])
