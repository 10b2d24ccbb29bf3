"""The gate/Gram system's plain version (the kernel's arithmetic in plain PyTorch)."""

from __future__ import annotations

import torch

F32 = torch.float32


def gate_rows(Hx, Hf, r, rowmask, w, cov, gate_vec, resid_cap):
    """The plain version's rows and gate (same arguments as `gram_gate`):
    (Hv (B,F,M,D), rv (B,F,M): the whitened rows projected onto Hf's left
    nullspace, the first k rows zero; ok (B,F); chi2 (B,F))."""
    B, F, M, D = Hx.shape
    k = Hf.shape[-1]
    m = rowmask[..., None]
    A = torch.cat([torch.where(m, Hf * w[..., None], 0.0),
                   torch.where(m, Hx * w[..., None], 0.0),
                   torch.where(rowmask, r * w, 0.0)[..., None]], dim=-1)
    raw_max = torch.amax(torch.abs(A[..., -1]), dim=-1)

    idx = torch.arange(M, device=Hx.device)
    for j in range(k):
        x = torch.where(idx >= j, A[..., :, j], 0.0)
        nx = torch.sqrt(torch.sum(x * x, dim=-1))
        sgn = torch.where(x[..., j] >= 0.0, 1.0, -1.0).to(F32)
        v = x - (-sgn * nx)[..., None] * (idx == j).to(F32)
        nv = torch.sqrt(torch.sum(v * v, dim=-1))
        small = nv < 1e-12
        v = v / torch.where(small, torch.ones_like(nv), nv)[..., None]
        scale = torch.where(small, 0.0, 2.0).to(F32)
        A = A - (scale[..., None] * v)[..., :, None] * (v[..., None, :] @ A)

    valid = (idx >= k)[:, None]
    Hv = torch.where(valid, A[..., k:k + D], 0.0)
    rv = torch.where(valid[:, 0], A[..., -1], 0.0)
    S = Hv @ cov[:, None] @ Hv.transpose(-1, -2)
    S = 0.5 * (S + S.transpose(-1, -2)) + torch.eye(M, dtype=F32, device=Hx.device)
    L, _ = torch.linalg.cholesky_ex(S)
    y = torch.linalg.solve_triangular(L, rv[..., None], upper=False)[..., 0]
    chi2 = torch.sum(y * y, dim=-1)

    n_rows = torch.sum(rowmask, dim=-1)
    gate_pad = torch.cat([gate_vec.to(F32), gate_vec.new_zeros(1, dtype=F32)])
    dof = torch.clamp(n_rows - k, min=1, max=gate_pad.shape[0] - 1)
    cap = torch.tensor(resid_cap, dtype=F32, device=Hx.device)
    ok = (chi2 < gate_pad[dof]) & (n_rows >= k + 2) & (raw_max < cap)
    return Hv, rv, ok, chi2


def gram_gate_plain(Hx, Hf, r, rowmask, w, cov, gate_vec, resid_cap):
    """Plain PyTorch version of the kernel (same arguments as `gram_gate`)."""
    Hv, rv, ok, chi2 = gate_rows(Hx, Hf, r, rowmask, w, cov, gate_vec, resid_cap)
    D = Hx.shape[-1]
    # [Hv | rv] of the accepted features in one product: G and c come out of
    # one matrix-matrix product per sequence.  On the CPU a separate
    # matrix-vector product for c sums in another order at B = 1 than at
    # B > 1, the one product not at the distributed layer's shapes (at F =
    # 128 neither form keeps it: `batch_invariance.py --device cpu`)
    Aok = torch.where(ok[..., None, None], torch.cat([Hv, rv[..., None]], dim=-1), 0.0)
    Gc = torch.einsum("bfmd,bfme->bde", Aok, Aok[..., :D])
    G, c = Gc[:, :D], Gc[:, D]
    return G, c, ok, chi2


def gram_gate(Hx, Hf, r, rowmask, w, cov, gate_vec, resid_cap: float):
    """The gated Gram system of a batch of per-feature MSCKF systems, plainly."""
    return gram_gate_plain(Hx, Hf, r, rowmask, w, cov, gate_vec, resid_cap)
