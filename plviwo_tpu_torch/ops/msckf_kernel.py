"""Fused MSCKF gate/Gram: the CUDA kernel's wrapper and its plain version.

Port of plviwo_tpu/ops/msckf_kernel.py (the Pallas TPU kernel
`gram_gate_fused`).  Per feature: whiten and mask the rows, project them
onto the left nullspace of Hf with k Householder reflectors, chi2-gate the
projected system against S = Hv cov Hv^T + I, and sum the accepted rows
into the Gram system (G = sum Hv^T Hv, c = sum Hv^T rv).

`gram_gate` takes batch-first tensors.  On CUDA tensors it launches the
hand-written kernel `csrc/msckf_gram_gate.cu` (built with nvcc for sm_90a
at first use by `ops/cuda_lib.py`) or raises; on CPU tensors it runs
`gram_gate_plain`.  There is no fallback between the two.
"""

from __future__ import annotations

import torch

from . import cuda_lib

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
    """Gated Gram system of a batch of per-feature MSCKF systems.

    Args (batch-first):
      Hx: (B, F, M, D) f32 state Jacobian stacks.
      Hf: (B, F, M, k) f32 feature Jacobians, k in {3, 4}.
      r, w: (B, F, M) f32 residuals and row whitening weights (1/sigma).
      rowmask: (B, F, M) bool.
      cov: (B, D, D) f32 covariance.
      gate_vec: (M+1,) f32 chi2 thresholds by dof (table * chi2_mult).
      resid_cap: raw-residual pre-gate, in whitened units.
    Returns:
      G (B, D, D), c (B, D), ok (B, F) bool, chi2 (B, F) — all f32 but ok.
      chi2 is meaningful only where a feature has more than k valid rows:
      with fewer nothing is left after the projection, and the kernel
      writes 0 there.

    CPU tensors take `gram_gate_plain`; CUDA tensors launch the kernel and
    count the launch in `gram_gate.launches`."""
    if Hx.device.type == "cpu":
        return gram_gate_plain(Hx, Hf, r, rowmask, w, cov, gate_vec, resid_cap)
    if Hx.device.type != "cuda":
        raise ValueError(f"gram_gate: unsupported device {Hx.device}")
    B, F, M, D = Hx.shape
    k = Hf.shape[-1]
    if not (1 <= k < M) or B < 1 or F < 1:
        raise ValueError(f"gram_gate: bad sizes B={B} F={F} M={M} k={k}")
    dev = Hx.device
    cuda_lib.check("Hx", Hx, F32, (B, F, M, D), dev)
    cuda_lib.check("Hf", Hf, F32, (B, F, M, k), dev)
    cuda_lib.check("r", r, F32, (B, F, M), dev)
    cuda_lib.check("rowmask", rowmask, torch.bool, (B, F, M), dev)
    cuda_lib.check("w", w, F32, (B, F, M), dev)
    cuda_lib.check("cov", cov, F32, (B, D, D), dev)
    cuda_lib.check("gate_vec", gate_vec, F32, (M + 1,), dev)
    lib = cuda_lib.library()
    smem = lib.msckf_gram_gate_smem_bytes(M, D, k)  # 0: sizes it does not take
    if not 0 < smem <= cuda_lib.SMEM_LIMIT:
        raise ValueError(f"gram_gate: sizes the kernel does not take: M={M} D={D} k={k} "
                         f"(M <= 64 rows, D <= 256 columns; {smem} B of shared memory)")

    P = torch.empty((B, F, M - k, D + 1), dtype=F32, device=dev)
    ok = torch.empty((B, F), dtype=torch.bool, device=dev)
    chi2 = torch.empty((B, F), dtype=F32, device=dev)
    G = torch.empty((B, D, D), dtype=F32, device=dev)
    c = torch.empty((B, D), dtype=F32, device=dev)
    with torch.cuda.device(dev):
        stream = cuda_lib.current_stream(dev)
        err = lib.msckf_gram_gate(
            Hx.data_ptr(), Hf.data_ptr(), r.data_ptr(), rowmask.data_ptr(),
            w.data_ptr(), cov.data_ptr(), gate_vec.data_ptr(), float(resid_cap),
            B, F, M, D, k, P.data_ptr(), ok.data_ptr(), chi2.data_ptr(),
            G.data_ptr(), c.data_ptr(), stream)
    if err != 0:
        msg = lib.msckf_gram_gate_error_string(err).decode()
        raise RuntimeError(f"msckf_gram_gate launch failed: {msg} ({err})")
    gram_gate.launches += 1
    return G, c, ok, chi2


gram_gate.launches = 0
