"""CUDA kernels of the port against their plain PyTorch versions, on a card.

Every test here needs an NVIDIA card (marker `cuda`) and skips without one.
The file imports no JAX, so it also runs where JAX is not installed; from
the repository root on a machine with a card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(`--noconftest`: tests/conftest.py configures JAX.)

Tolerances: `ok` equal; G and c within atol 2e-5 max|G|, rtol 2e-4 (the
bounds of tests/test_msckf_kernel.py); the fused step within max|dp| < 1e-5
and max|dcov| < 1e-4 max|cov|.
"""

import numpy as np
import pytest
import torch

from plviwo_tpu.ops.chi2 import _TABLE as _CHI2_NP
from plviwo_tpu_torch.examples import SIGMA_LINE, WHEEL_NOISE, batch_args, example_inputs_full
from plviwo_tpu_torch.ops.msckf_kernel import gram_gate, gram_gate_plain

F32 = np.float32
COUNTS = ("accepted", "lines_accepted", "wheel_accepted")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _systems(rng, B, F, M, D, k, dev):
    """Random per-feature systems (as tests/test_msckf_kernel.py makes them)
    for B sequences, on `dev`."""
    Hx = rng.normal(size=(B, F, M, D)).astype(F32)
    Hf = rng.normal(size=(B, F, M, k)).astype(F32)
    r = rng.normal(size=(B, F, M)).astype(F32)
    rowmask = rng.uniform(size=(B, F, M)) < 0.7
    rowmask[:, 0] = False
    rowmask[:, 1] = np.arange(M) < (k + 1)
    A = rng.normal(size=(B, D, 2 * D)).astype(F32)
    cov = (A @ A.transpose(0, 2, 1) / (2 * D) * 0.05).astype(F32)
    return [torch.as_tensor(a, device=dev) for a in (Hx, Hf, r, rowmask, cov)]


def _gate_vec(M, chi2_mult, dev):
    return torch.as_tensor(_CHI2_NP[: M + 1].astype(F32) * F32(chi2_mult), device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("k,B,F,M,D", [
    (3, 4, 40, 40, 162), (4, 4, 16, 40, 162),  # the filter bench's M and D
    # the CPU tests' shapes: fewer rows than one pass-1 row chunk, and D + 1
    # not a multiple of the pass-2 tile
    (3, 1, 8, 12, 40), (4, 1, 8, 12, 40)])
def test_kernel_matches_plain(cuda_device, k, B, F, M, D):
    Hx, Hf, r, rowmask, cov = _systems(np.random.default_rng(30 + k + M), B, F, M, D, k,
                                       cuda_device)
    w = torch.full(r.shape, 1.0 / 1.3, device=cuda_device)
    gate_vec = _gate_vec(M, 5.0, cuda_device)
    before = gram_gate.launches
    G1, c1, ok1, chi1 = gram_gate(Hx, Hf, r, rowmask, w, cov, gate_vec, 15.0)
    G0, c0, ok0, chi0 = gram_gate_plain(Hx, Hf, r, rowmask, w, cov, gate_vec, 15.0)
    torch.cuda.synchronize()
    assert gram_gate.launches == before + 1
    assert torch.equal(ok1, ok0) and 0 < int(ok1.sum()) < ok1.numel()
    for a, b in ((G1, G0), (c1, c0)):
        sc = float(b.abs().max()) + 1e-9
        torch.testing.assert_close(a, b, atol=2e-5 * sc, rtol=2e-4)
    has = rowmask.sum(-1) > k
    torch.testing.assert_close(chi1[has], chi0[has], rtol=1e-3, atol=0.0)


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda_device):
    Hx, Hf, r, rowmask, cov = _systems(np.random.default_rng(5), 1, 4, 10, 24, 3,
                                       cuda_device)
    w = torch.ones_like(r)
    gate_vec = _gate_vec(10, 1.0, cuda_device)
    with pytest.raises(ValueError):
        gram_gate(Hx.double(), Hf, r, rowmask, w, cov, gate_vec, 1.0)
    with pytest.raises(ValueError):
        gram_gate(Hx.transpose(-1, -2).contiguous().transpose(-1, -2), Hf, r, rowmask,
                  w, cov, gate_vec, 1.0)
    with pytest.raises(ValueError):
        gram_gate(Hx, Hf, r, rowmask, w, cov.cpu(), gate_vec, 1.0)


@pytest.mark.cuda
def test_step_kernel_path_matches_plain_path(cuda_device, monkeypatch):
    """fused_step_full on the card launches the kernel twice per frame and
    matches the same step with the plain gate."""
    from plviwo_tpu_torch.core import step

    b = batch_args(example_inputs_full(n_clones=8, F=6, O=5, imu_n=8, L=3, n_wheel=8),
                   3, cuda_device)

    def run():
        return step.fused_step_full(*b, SIGMA_LINE, WHEEL_NOISE, cam_dtype=torch.float32)

    before = gram_gate.launches
    s1, m1 = run()
    torch.cuda.synchronize()
    assert gram_gate.launches == before + 2
    monkeypatch.setattr(step, "gram_gate", gram_gate_plain)
    s0, m0 = run()
    for k in COUNTS:
        assert torch.equal(m1[k], m0[k]) and int(m1[k].sum()) > 0
    assert float((s1.p - s0.p).abs().max()) < 1e-5
    assert float((s1.cov - s0.cov).abs().max()) < 1e-4 * float(s0.cov.abs().max())
