"""Small-matrix linear algebra (port of plviwo_tpu/ops/linalg.py).

Only the solvers the filter needs are ported.  The TPU package's
mixed-precision block (`dmatmul`, `solve_psd_refined`, `chol_equilibrated`,
`tri_lower_solve_refined`) works around the TPU's emulated float64; here the
factorizations run in native float64 instead (`chol_equilibrated` below keeps
only the equilibration, jitter and validity mask, which are numerics, not a
workaround).
"""

from __future__ import annotations

import math

import torch


def solve3x3(A, b):
    """Batched Cramer's-rule solve for (...,3,3) @ x = (...,3)."""
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a10, a11, a12 = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    a20, a21, a22 = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    c00 = a11 * a22 - a12 * a21
    c01 = a12 * a20 - a10 * a22
    c02 = a10 * a21 - a11 * a20
    det = a00 * c00 + a01 * c01 + a02 * c02
    det = torch.where(torch.abs(det) < 1e-18, torch.full_like(det, 1e-18), det)
    c10 = a02 * a21 - a01 * a22
    c11 = a00 * a22 - a02 * a20
    c12 = a01 * a20 - a00 * a21
    c20 = a01 * a12 - a02 * a11
    c21 = a02 * a10 - a00 * a12
    c22 = a00 * a11 - a01 * a10
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    x0 = (c00 * b0 + c10 * b1 + c20 * b2) / det
    x1 = (c01 * b0 + c11 * b1 + c21 * b2) / det
    x2 = (c02 * b0 + c12 * b1 + c22 * b2) / det
    return torch.stack([x0, x1, x2], dim=-1)


def eigvals_sym3x3(A):
    """Closed-form eigenvalues of symmetric (...,3,3), ascending (Smith)."""
    a00, a11, a22 = A[..., 0, 0], A[..., 1, 1], A[..., 2, 2]
    a01, a02, a12 = A[..., 0, 1], A[..., 0, 2], A[..., 1, 2]
    q = (a00 + a11 + a22) / 3.0
    p1 = a01**2 + a02**2 + a12**2
    p2 = (a00 - q) ** 2 + (a11 - q) ** 2 + (a22 - q) ** 2 + 2.0 * p1
    # clamp floor 1e-300 as in the JAX version; it flushes to 0 in float32
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=1e-300))
    b00, b11, b22 = (a00 - q) / p, (a11 - q) / p, (a22 - q) / p
    b01, b02, b12 = a01 / p, a02 / p, a12 / p
    detB = (b00 * (b11 * b22 - b12 * b12)
            - b01 * (b01 * b22 - b12 * b02)
            + b02 * (b01 * b12 - b11 * b02))
    r = torch.clamp(detB / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    e_hi = q + 2.0 * p * torch.cos(phi)
    e_lo = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    e_mid = 3.0 * q - e_hi - e_lo
    scalar = p2 < 1e-30
    e_lo = torch.where(scalar, q, e_lo)
    e_mid = torch.where(scalar, q, e_mid)
    e_hi = torch.where(scalar, q, e_hi)
    return torch.stack([e_lo, e_mid, e_hi], dim=-1)


def solve_psd(S, b):
    """Cholesky solve for symmetric PD S (...,n,n), b (...,n) or (...,n,k).

    `cholesky_ex` does not raise (no host sync); a failed factor yields
    non-finite values the callers' masks and gates reject.  Two triangular
    solves rather than `torch.cholesky_solve`, which cannot be captured in a
    CUDA graph."""
    L, _ = torch.linalg.cholesky_ex(S)
    squeeze = b.ndim == S.ndim - 1
    if squeeze:
        b = b[..., None]
    y = torch.linalg.solve_triangular(L, b, upper=False)
    x = torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True)
    return x[..., 0] if squeeze else x


def chol_unrolled(S):
    """Column-by-column Cholesky for small static n, diagonals clamped at 1e-20."""
    n = S.shape[-1]
    cols = []
    for j in range(n):
        Lj = torch.stack(cols, dim=-1) if cols else S[..., :, :0]  # (...,n,j)
        d2 = S[..., j, j] - torch.sum(Lj[..., j, :] ** 2, dim=-1)
        d = torch.sqrt(torch.clamp(d2, min=1e-20))
        col = S[..., :, j] - torch.einsum("...ik,...k->...i", Lj, Lj[..., j, :])
        col = col / d[..., None]
        rows = torch.arange(n, device=S.device)
        cols.append(torch.where(rows >= j, col, torch.zeros_like(col)))
    return torch.stack(cols, dim=-1)


def chi2_quadform(S, r):
    """r^T S^-1 r for SPD S (...,n,n) as ||L^-1 r||^2: one batched Cholesky
    and one triangular solve (the JAX package unrolls both, a TPU
    workaround; unrolled here they cost O(n^2) host operators)."""
    L, _ = torch.linalg.cholesky_ex(S)
    y = torch.linalg.solve_triangular(L, r[..., None], upper=False)[..., 0]
    return torch.sum(y * y, dim=-1)


def inv_small(A):
    """General small-matrix inverse via QR + triangular solve."""
    Q, R = torch.linalg.qr(A)
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device).expand(A.shape)
    Rinv = torch.linalg.solve_triangular(R, eye, upper=True)
    return Rinv @ Q.transpose(-1, -2)


def chol_equilibrated(G, jitter=3e-6):
    """(L, valid): lower factor with L L^T = G + jitter*diag(G) over the
    valid rows and columns, in float64.

    The unit-diagonal equilibration and the jitter regularize the null
    directions of empty clone slots (a plain Cholesky of the singular Gram
    fails); rows a failed factor leaves non-finite are replaced by identity
    rows, as the JAX version does.  valid marks rows whose Gram diagonal is
    numerically nonzero.  The other rows and columns are identity in the
    equilibrated matrix, so they stay out of the factor: a column of
    rounding noise (a diagonal ~1e-27 against ~1e6, from weights that are
    zero in exact arithmetic) would otherwise be scaled to unit size and,
    correlated at O(1) with the valid columns, take information from them.
    Where such a column is exactly zero the factor is unchanged bit for bit
    (the JAX version factors it in; ROADMAP C, known differences)."""
    diag = torch.diagonal(G, dim1=-2, dim2=-1)
    valid = diag > 1e-12 * torch.amax(diag, dim=-1, keepdim=True)
    d = torch.sqrt(torch.clamp(diag, min=1e-30))
    eye = torch.eye(G.shape[-1], dtype=G.dtype, device=G.device)
    both = valid[..., :, None] & valid[..., None, :]
    Si = torch.where(both, G / (d[..., :, None] * d[..., None, :]), eye)
    L, _ = torch.linalg.cholesky_ex(Si + jitter * eye)
    L = torch.where(torch.isnan(L), eye.expand_as(L), L)
    return d[..., :, None] * L, valid
