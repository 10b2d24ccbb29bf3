"""The port's fused filter step against the JAX package.

`plviwo_tpu_torch.core.step.fused_step` / `fused_step_full` (batch-first,
on the CPU: the gate/Gram kernel's plain version) against the JAX
`fused_step` / `fused_step_full(cam_dtype=f32, use_pallas=True,
pallas_interpret=True)` on `__graft_entry__._example_inputs_full(n_clones=8,
F=6, O=5, imu_n=8, L=3, n_wheel=8)`.

Tolerances: accepted / lines_accepted / wheel_accepted equal;
max|dp| < 1e-5 and max|dcov| < 1e-4 max|cov| — the bounds of
tests/test_msckf_kernel.py::test_fused_step_pallas_matches_xla (float32
camera tensors, and the JAX update's float32 factor against the port's
float64 one).
"""

import dataclasses
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import SIGMA_LINE, WHEEL_NOISE, _example_inputs, _example_inputs_full
from plviwo_tpu.core.step import fused_step as j_fused_step
from plviwo_tpu.core.step import fused_step_full as j_fused_step_full
from plviwo_tpu_torch.core.state import FilterState
from plviwo_tpu_torch.core.step import fused_step, fused_step_full
from plviwo_tpu_torch.examples import batch_args, example_inputs, example_inputs_full
from plviwo_tpu_torch.ops.msckf_kernel import gram_gate

torch.set_num_threads(1)

SMALL = dict(n_clones=8, F=6, O=5, imu_n=8, L=3, n_wheel=8)
COUNTS = ("accepted", "lines_accepted", "wheel_accepted")


def _jax_state_arrays(st):
    return {f.name: np.asarray(getattr(st, f.name))
            for f in dataclasses.fields(st) if f.name != "layout"}


def _jax_full(args):
    return j_fused_step_full(*args, SIGMA_LINE, WHEEL_NOISE, model=0, window_size=1.0,
                             cam_dtype=jnp.float32, use_pallas=True, pallas_interpret=True)


def _torch_full(b):
    return fused_step_full(*b, SIGMA_LINE, WHEEL_NOISE, model=0, window_size=1.0,
                           cam_dtype=torch.float32)


def _assert_step_close(ts, tm, js, jm, b=0, counts=COUNTS):
    for k in counts:
        assert int(tm[k][b]) == int(jm[k]), (k, int(tm[k][b]), int(jm[k]))
    dp = np.max(np.abs(ts.p[b].numpy() - np.asarray(js.p)))
    cov = np.asarray(js.cov)
    dcov = np.max(np.abs(ts.cov[b].numpy() - cov))
    assert dp < 1e-5, dp
    assert dcov < 1e-4 * np.max(np.abs(cov)), (dcov, np.max(np.abs(cov)))
    np.testing.assert_array_equal(ts.clone_valid[b].numpy(), np.asarray(js.clone_valid))


@pytest.fixture(scope="module")
def full_inputs():
    return _example_inputs_full(**SMALL), example_inputs_full(**SMALL, device="cpu")


def test_examples_match_jax_builders(full_inputs):
    ja, ta = full_inputs
    assert len(ja) == len(ta)
    js = _jax_state_arrays(ja[0])
    ts = ta[0].to_numpy()
    assert js.keys() == ts.keys()
    for k in js:
        np.testing.assert_array_equal(ts[k], js[k], err_msg=k)
    for i, (a, b) in enumerate(zip(ja[1:], ta[1:]), start=1):
        if isinstance(b, tuple):
            assert a == b
        else:
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a), err_msg=str(i))
    pa, pb = _example_inputs(), example_inputs(device="cpu")
    for k, v in _jax_state_arrays(pa[0]).items():
        np.testing.assert_array_equal(pb[0].to_numpy()[k], v, err_msg=k)
    for a, b in zip(pa[1:9], pb[1:9]):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


def test_state_numpy_round_trip(full_inputs):
    ja, _ = full_inputs
    arrays = _jax_state_arrays(ja[0])
    st = FilterState.from_numpy(arrays, ja[0].layout, device="cpu")
    assert st.batch == 1 and st.cov.dtype == torch.float64
    assert st.clone_valid.dtype == torch.bool and st.slam_id.dtype == torch.int32
    back = st.to_numpy()
    for k, v in arrays.items():
        assert back[k].dtype == v.dtype, k
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    # a list of states stacks to B
    two = FilterState.from_numpy([arrays, arrays], ja[0].layout, device="cpu")
    assert two.batch == 2
    np.testing.assert_array_equal(two.to_numpy(1)["cov"], arrays["cov"])
    with pytest.raises(ValueError):
        FilterState.from_numpy({**arrays, "q": arrays["q"][None, None]}, ja[0].layout,
                               device="cpu")


def test_fused_step_matches_jax():
    """Points only: the port's kernel-path gate against the JAX XLA path
    (whose "rows" counts projected rows, the kernel path's raw rows)."""
    ja, ta = _example_inputs(n_clones=8, F=6, O=5, imu_n=8), example_inputs(
        n_clones=8, F=6, O=5, imu_n=8, device="cpu")
    js, jm = j_fused_step(*ja, model=0, window_size=1.0, cam_dtype=jnp.float32)
    ts, tm = fused_step(*batch_args(ta, 1, "cpu", n_batched=8), model=0, window_size=1.0,
                        cam_dtype=torch.float32)
    assert int(jm["accepted"]) > 0
    _assert_step_close(ts, tm, js, jm, counts=("accepted",))


def test_fused_step_full_matches_jax(full_inputs):
    ja, ta = full_inputs
    js, jm = _jax_full(ja)
    before = gram_gate.launches
    ts, tm = _torch_full(batch_args(ta, 1, "cpu"))
    assert gram_gate.launches == before  # CPU tensors: plain version, no launch
    assert min(int(jm[k]) for k in COUNTS) > 0
    _assert_step_close(ts, tm, js, jm)
    assert int(tm["rows"][0]) == int(jm["rows"])


def test_chained_frames_match_jax(full_inputs):
    """Three chained frames, each fed the previous frame's state."""
    ja, ta = full_inputs
    js, ts = ja[0], batch_args(ta, 1, "cpu")[0]
    per_j, per_t = ja[1:], batch_args(ta, 1, "cpu")[1:]
    for _ in range(3):
        js, jm = _jax_full((js,) + per_j)
        ts, tm = _torch_full((ts,) + per_t)
        _assert_step_close(ts, tm, js, jm)


def test_batch_of_different_sequences(full_inputs):
    """B = 2 sequences that differ (state, IMU, observation noise); each
    sequence of the batched port step matches its own JAX call."""
    ja, ta = full_inputs
    rng = np.random.default_rng(5)
    seqs = []
    for b in range(2):
        st = ja[0].replace(
            p=ja[0].p + 0.01 * b, v=ja[0].v * (1.0 + 0.05 * b),
            bg=jnp.asarray(1e-4 * rng.normal(size=3)))
        imu_w = np.asarray(ja[2]) + 1e-3 * b * rng.normal(size=np.shape(ja[2]))
        obs_uv = np.asarray(ja[5]) + 0.3 * b * rng.normal(size=np.shape(ja[5]))
        seqs.append((st, ja[1], jnp.asarray(imu_w), ja[3], ja[4], jnp.asarray(obs_uv)) + ja[6:])
    stacked = [FilterState.from_numpy([_jax_state_arrays(s[0]) for s in seqs], ja[0].layout,
                                      device="cpu")]
    for i in range(1, 17):
        a = np.stack([np.asarray(s[i]) for s in seqs])
        t = torch.as_tensor(a)
        stacked.append(t.long() if a.dtype == np.int32 else t)
    stacked += [torch.tensor(np.asarray(ja[17]))] + list(ja[18:])
    ts, tm = _torch_full(tuple(stacked))
    for b, seq in enumerate(seqs):
        js, jm = _jax_full(seq)
        _assert_step_close(ts, tm, js, jm, b=b)
    assert not torch.equal(ts.p[0], ts.p[1])


def test_port_imports_no_jax():
    """Importing every module of the port leaves jax and the JAX package
    (`plviwo_tpu`, `plviwo_tpu.*`) out of sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import plviwo_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import batch_invariance, chip_smoke, gram_gate_ab, lk_ab, store_ab\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib', 'flax')))\n"
        "assert not bad, bad\n"
        "ref = sorted(m for m in sys.modules if m == 'plviwo_tpu' or m.startswith('plviwo_tpu.'))\n"
        "assert not ref, ref\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
