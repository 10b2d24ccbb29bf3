"""The port's fused MSCKF gate/Gram against the JAX package.

`plviwo_tpu_torch.ops.msckf_kernel.gram_gate_plain` (the plain PyTorch
version of the CUDA kernel, batch-first) is held to the Pallas kernel
`gram_gate_fused` in interpret mode and to the XLA composition
(`msckf_project_and_gate` + a masked Gram) on the same numpy inputs.  The
CUDA kernel itself is held to the plain version, at this file's small
shapes and at the bench shapes, in tests/test_torch_cuda.py: that file
imports no JAX, so it runs on a card machine that has none.

Tolerances: `ok` equal; G and c within atol 2e-5 max|G|, rtol 2e-4 — the
bounds of tests/test_msckf_kernel.py, float32 sums taken in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plviwo_tpu.ops.chi2 import _TABLE as _CHI2_NP
from plviwo_tpu.ops.msckf_kernel import gram_gate_fused
from plviwo_tpu.update import cam_helper as jcam
from plviwo_tpu_torch.ops.msckf_kernel import gram_gate, gram_gate_plain
from plviwo_tpu_torch.update import cam_helper as tcam

torch.set_num_threads(1)
F32 = np.float32


def _random_systems(rng, F, M, D, k, frac_valid=0.7, res_scale=1.0):
    """As tests/test_msckf_kernel.py: random systems with one fully masked
    feature and one below the k+2 row requirement."""
    Hx = rng.normal(size=(F, M, D)).astype(F32)
    Hf = rng.normal(size=(F, M, k)).astype(F32)
    r = (res_scale * rng.normal(size=(F, M))).astype(F32)
    rowmask = rng.uniform(size=(F, M)) < frac_valid
    rowmask[0] = False
    rowmask[1] = np.arange(M) < (k + 1)
    A = rng.normal(size=(D, 2 * D)).astype(F32)
    cov = (A @ A.T / (2 * D) * 0.05).astype(F32)
    return Hx, Hf, r, rowmask, cov


def _gate_vec(M, chi2_mult):
    return _CHI2_NP[: M + 1].astype(F32) * F32(chi2_mult)


def _plain(Hx, Hf, r, rowmask, w, cov, gate_vec, cap):
    """gram_gate_plain on one sequence (adds and removes the B axis)."""
    t = [torch.as_tensor(a)[None] for a in (Hx, Hf, r, rowmask, w, cov)]
    G, c, ok, chi = gram_gate_plain(*t, torch.as_tensor(gate_vec), cap)
    return G[0].numpy(), c[0].numpy(), ok[0].numpy(), chi[0].numpy()


def _assert_gram_close(G1, c1, G0, c0):
    sc = float(np.max(np.abs(G0))) + 1e-9
    np.testing.assert_allclose(G1, G0, atol=2e-5 * sc, rtol=2e-4)
    sc_c = float(np.max(np.abs(c0))) + 1e-9
    np.testing.assert_allclose(c1, c0, atol=2e-5 * sc_c, rtol=2e-4)


@pytest.mark.parametrize("k", [3, 4])
def test_plain_matches_pallas_interpret(k):
    rng = np.random.default_rng(0 if k == 3 else 1)
    F, M, D = 8, 12, 40
    sigma, chi2_mult = 1.3, 5.0
    Hx, Hf, r, rowmask, cov = _random_systems(rng, F, M, D, k)
    gate_vec = _gate_vec(M, chi2_mult)
    w = np.full(r.shape, 1.0 / sigma, dtype=F32)

    G0, c0, ok0, chi0 = gram_gate_fused(
        jnp.asarray(Hx), jnp.asarray(Hf), jnp.asarray(r), jnp.asarray(rowmask),
        jnp.asarray(w), jnp.asarray(cov), jnp.asarray(gate_vec), 15.0,
        interpret=True)
    G1, c1, ok1, chi1 = _plain(Hx, Hf, r, rowmask, w, cov, gate_vec, 15.0)

    np.testing.assert_array_equal(ok1, np.asarray(ok0))
    assert 0 < ok1.sum() < F
    _assert_gram_close(G1, c1, np.asarray(G0), np.asarray(c0))
    # chi2 of the features with rows (f32 Cholesky in another order)
    has = rowmask.sum(axis=1) > k
    np.testing.assert_allclose(chi1[has], np.asarray(chi0)[has], rtol=1e-3)


@pytest.mark.parametrize("k", [3, 4])
def test_plain_matches_xla_composition(k):
    rng = np.random.default_rng(10 + k)
    F, M, D = 8, 12, 40
    sigma, chi2_mult = 1.3, 5.0
    Hx, Hf, r, rowmask, cov = _random_systems(rng, F, M, D, k)

    s2 = jnp.full(r.shape, sigma**2, dtype=jnp.float32)  # per-row -> whitened
    Hn, rn, rowvalid, ok0 = jcam.msckf_project_and_gate(
        jnp.asarray(Hx), jnp.asarray(Hf), jnp.asarray(r), jnp.asarray(rowmask),
        jnp.asarray(cov), s2, jnp.asarray(_CHI2_NP).astype(jnp.float32), chi2_mult)
    m = (rowvalid & ok0[:, None]).astype(jnp.float32)
    G0 = jnp.einsum("fmd,fme->de", Hn * m[..., None], Hn * m[..., None])
    c0 = jnp.einsum("fmd,fm->d", Hn * m[..., None], rn * m)

    w = np.full(r.shape, 1.0 / sigma, dtype=F32)
    G1, c1, ok1, _ = _plain(Hx, Hf, r, rowmask, w, cov, _gate_vec(M, chi2_mult), 15.0)
    np.testing.assert_array_equal(ok1, np.asarray(ok0))
    _assert_gram_close(G1, c1, np.asarray(G0), np.asarray(c0))


@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("k", [3, 4])
def test_project_and_gate_port(k, per_row):
    """The port's XLA-path cross-check against the JAX function, in f64."""
    rng = np.random.default_rng(20 + k)
    F, M, D = 6, 10, 24
    Hx, Hf, r, rowmask, cov = (a.astype(np.float64) if a.dtype == F32 else a
                               for a in _random_systems(rng, F, M, D, k, res_scale=0.5))
    table = _CHI2_NP
    s2 = (rng.uniform(0.5, 2.0, size=(F, M)) if per_row else 1.7)
    out0 = jcam.msckf_project_and_gate(
        jnp.asarray(Hx), jnp.asarray(Hf), jnp.asarray(r), jnp.asarray(rowmask),
        jnp.asarray(cov), jnp.asarray(s2), jnp.asarray(table), 3.0)
    s2_t = torch.as_tensor(s2)[None] if per_row else s2
    out1 = tcam.msckf_project_and_gate(
        torch.as_tensor(Hx)[None], torch.as_tensor(Hf)[None], torch.as_tensor(r)[None],
        torch.as_tensor(rowmask)[None], torch.as_tensor(cov)[None], s2_t,
        torch.as_tensor(table), 3.0)
    for a, b in zip(out0, out1):
        np.testing.assert_allclose(b[0].numpy(), np.asarray(a), rtol=1e-10, atol=1e-10)


def test_gate_behaviour():
    """Huge residuals are rejected by the cap; consistent features accepted."""
    rng = np.random.default_rng(3)
    F, M, D, k = 6, 10, 24, 3
    Hx, Hf, r, rowmask, cov = _random_systems(rng, F, M, D, k, frac_valid=1.0,
                                              res_scale=0.3)
    rowmask = np.ones((F, M), dtype=bool)
    r[2] = 200.0
    gate_vec = _CHI2_NP[: M + 1].astype(F32) * F32(1e6)  # chi2 gate open
    G, c, ok, _ = _plain(Hx, Hf, r, rowmask, np.ones((F, M), F32), cov, gate_vec, 50.0)
    assert not ok[2]
    assert ok[[0, 1, 3, 4, 5]].all()
    eig = np.linalg.eigvalsh(G.astype(np.float64))
    assert eig.min() > -1e-3 and eig.max() > 0


def test_nullspace_zero_pivot():
    """A masked (zero) row in pivot position must not leak feature-Jacobian
    content into the projected rows (float64 port of _nullspace)."""
    rng = np.random.default_rng(7)
    M, D, k = 10, 16, 3
    mask = np.ones(M, dtype=bool)
    mask[1] = False
    Hf = torch.as_tensor(rng.normal(size=(M, k)) * mask[:, None])
    r = torch.as_tensor(rng.normal(size=M) * mask)
    y = torch.as_tensor(rng.normal(size=k))
    Hfy = Hf @ y[:, None] @ torch.ones((1, D), dtype=torch.float64)
    H2, _, valid = tcam._nullspace(Hf, Hfy, r)
    leak = torch.max(torch.abs(torch.where(valid[:, None], H2, 0.0)))
    assert float(leak) < 1e-10, float(leak)


def test_plain_zero_pivot():
    """The same leak check through the plain kernel version (float32): rows
    built from Hf alone project to (numerically) nothing."""
    rng = np.random.default_rng(8)
    F, M, D, k = 3, 10, 16, 3
    mask = np.ones((F, M), dtype=bool)
    mask[:, 1] = False
    Hf = rng.normal(size=(F, M, k)).astype(F32)
    Hx = np.einsum("fmk,kd->fmd", Hf, rng.normal(size=(k, D))).astype(F32)
    r = rng.normal(size=(F, M)).astype(F32)
    cov = np.eye(D, dtype=F32)
    gate_vec = _CHI2_NP[: M + 1].astype(F32) * F32(1e9)
    G, _, ok, _ = _plain(Hx, Hf, r, mask, np.ones((F, M), F32), cov, gate_vec, 1e9)
    assert ok.all()
    assert np.abs(G).max() < 1e-8 * np.abs(Hx).max() ** 2 * M, np.abs(G).max()


def test_batch_matches_per_sequence():
    """A batch of B = 3 sequences equals per-sequence calls."""
    rng = np.random.default_rng(3)
    B, F, M, D, k = 3, 4, 10, 24, 3
    seqs = [_random_systems(rng, F, M, D, k) for _ in range(B)]
    stacked = [torch.as_tensor(np.stack([s[i] for s in seqs])) for i in range(5)]
    gate_vec = torch.as_tensor(_CHI2_NP[: M + 1].astype(F32))
    w = torch.full((B, F, M), 2.0)
    Hx, Hf, r, rowmask, cov = stacked
    out_b = gram_gate_plain(Hx, Hf, r, rowmask, w, cov, gate_vec, 1e9)
    for b in range(B):
        out_1 = gram_gate_plain(Hx[b:b + 1], Hf[b:b + 1], r[b:b + 1], rowmask[b:b + 1],
                                w[b:b + 1], cov[b:b + 1], gate_vec, 1e9)
        for a, bb in zip(out_b, out_1):
            np.testing.assert_allclose(a[b].double().numpy(), bb[0].double().numpy(),
                                       rtol=0, atol=1e-5)


def test_wrapper_takes_plain_path_on_cpu():
    """On CPU tensors the wrapper is the plain version and launches nothing."""
    rng = np.random.default_rng(4)
    Hx, Hf, r, rowmask, cov = (torch.as_tensor(a)[None] for a in
                               _random_systems(rng, 4, 10, 24, 4))
    w = torch.ones_like(r)
    gate_vec = torch.as_tensor(_gate_vec(10, 2.0))
    before = gram_gate.launches
    out = gram_gate(Hx, Hf, r, rowmask, w, cov, gate_vec, 30.0)
    ref = gram_gate_plain(Hx, Hf, r, rowmask, w, cov, gate_vec, 30.0)
    assert gram_gate.launches == before
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
