"""The port's GPS rows against the JAX package, on the CPU.

`plviwo_tpu_torch.core.step._gps_rows` (batch-first: the fixes of B
sequences at once, the FEJ Jacobians of all fixes in closed form)
and `core.interp.interpolate_pose_linear` against the JAX `_gps_rows` and
`interpolate_pose_linear`, on the cases of tests/test_gps_fused.py: zero
residual at the truth, an absurd fix gated out, an uncovered fix masked,
the antenna lever arm, and a fix at a clone time (both bounding clones are
that one clone).

Tolerances: the masks and accepted counts equal; H and r within 1e-9
(float64 throughout; the closed-form Jacobians against jax.jacfwd).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plviwo_tpu.core.interp import interpolate_pose_linear as j_interp
from plviwo_tpu.core.layout import StateLayout as JLayout
from plviwo_tpu.core.state import make_state as j_make_state
from plviwo_tpu.core.step import _gps_rows as j_gps_rows
from plviwo_tpu.ops import lie as j_lie
from plviwo_tpu_torch.core import ekf
from plviwo_tpu_torch.core.interp import interpolate_pose_linear
from plviwo_tpu_torch.core.layout import StateLayout
from plviwo_tpu_torch.core.state import FilterState, make_state
from plviwo_tpu_torch.core.step import _gps_rows

F64 = torch.float64


def _state(n_clones=6, lever=(0.0, 0.0, 0.0), yaw=0.0, B=2):
    """B sequences with clones along +x at 1 m/s (sequence b yawed by
    b * yaw, its clone b dropped when b > 0), a clone-position prior and
    the antenna at `lever`; as numpy dicts and the batch-first state."""
    layout = StateLayout(n_clones=n_clones, n_cams=1, n_gps=1)
    base = make_state(layout, priors={"imu_th": 1e-3, "imu_p": 1e-2, "imu_v": 1e-2,
                                      "imu_bg": 1e-3, "imu_ba": 1e-2}, device="cpu").to_numpy()
    seqs = []
    for b in range(B):
        st = {k: v.copy() for k, v in base.items()}
        th = b * yaw + 0.05 * np.arange(n_clones)
        q = np.stack([np.zeros(n_clones), np.zeros(n_clones), np.sin(th / 2), np.cos(th / 2)], -1)
        p = np.stack([np.arange(n_clones, dtype=float), 0.1 * b * np.ones(n_clones),
                      np.zeros(n_clones)], -1)
        valid = np.ones(n_clones, bool)
        if b > 0:
            valid[b] = False
        st.update(clone_q=q, clone_p=p, clone_q_fej=q.copy(), clone_p_fej=p + 1e-3,
                  clone_t=np.where(valid, np.arange(n_clones, dtype=float), np.inf),
                  clone_valid=valid, time=np.array(float(n_clones - 1)),
                  gps_p=np.array([lever]))
        for i in range(n_clones):
            s = layout.clone(i)
            st["cov"][s + 3:s + 6, s + 3:s + 6] = 0.25 * np.eye(3)
        seqs.append(st)
    js = j_make_state(JLayout(n_clones=n_clones, n_cams=1, n_gps=1))
    jstates = [js.replace(**{k: jnp.asarray(v) for k, v in st.items()}) for st in seqs]
    return jstates, FilterState.from_numpy(seqs, layout, "cpu")


def _both(jstates, tstate, gt, gp, gv, sigma, mult):
    """Port rows of all sequences, checked against JAX's per sequence;
    returns the port's (H, r, mask, accepted)."""
    out = _gps_rows(tstate, torch.as_tensor(gt), torch.as_tensor(gp), torch.as_tensor(gv),
                    sigma, mult)
    for b, js in enumerate(jstates):
        H, r, m, n = (np.asarray(a) for a in j_gps_rows(js, jnp.asarray(gt[b]),
                                                         jnp.asarray(gp[b]),
                                                         jnp.asarray(gv[b]), sigma, mult))
        np.testing.assert_array_equal(out[2][b].numpy(), m)
        assert int(out[3][b]) == int(n)
        np.testing.assert_allclose(out[0][b].numpy(), H, rtol=0, atol=1e-9)
        np.testing.assert_allclose(out[1][b].numpy(), r, rtol=0, atol=1e-9)
    return out


def _on_track(t, b, lever=(0.0, 0.0, 0.0), yaw=0.0):
    """The antenna at time t on sequence b's clone trajectory (x = t,
    y = 0.1 b, yaw b yaw + 0.05 t), which the interpolated pose reproduces."""
    th = b * yaw + 0.05 * t
    R_GtoI = np.array([[np.cos(th), np.sin(th), 0], [-np.sin(th), np.cos(th), 0], [0, 0, 1]])
    return np.array([t, 0.1 * b, 0.0]) + R_GtoI.T @ np.asarray(lever)


def test_zero_residual_at_truth():
    jst, st = _state()
    gt = np.array([[2.5, 1.5], [2.5, 0.5]])
    gp = np.stack([[_on_track(t, b) for t in gt[b]] for b in range(2)])
    H, r, mask, n = _both(jst, st, gt, gp, np.ones((2, 2), bool), 0.5, 1.0)
    assert n.tolist() == [2, 2] and bool(mask.all())
    assert float(r.abs().max()) < 1e-9
    # the rows touch only the bounding clones' columns
    lo = st.layout
    nz = set(np.nonzero(H[0, :3].abs().sum(0).numpy() > 1e-12)[0])
    assert nz <= set(range(lo.clone(2), lo.clone(2) + 6)) | set(range(lo.clone(3), lo.clone(3) + 6))


def test_gate_rejects_absurd_fix():
    jst, st = _state()
    gt = np.array([[2.5, 3.0]] * 2)
    gp = np.stack([[_on_track(2.5, b), [500.0, 300.0, 0.0]] for b in range(2)])
    _, _, mask, n = _both(jst, st, gt, gp, np.ones((2, 2), bool), 0.5, 1.0)
    assert n.tolist() == [1, 1]
    assert mask.reshape(2, 2, 3)[:, 0].all() and not mask.reshape(2, 2, 3)[:, 1].any()


def test_uncovered_and_invalid_fixes_masked():
    jst, st = _state()
    gt = np.array([[99.0, 2.5, -1.0]] * 2)  # after the newest clone, valid, before the oldest
    gp = np.stack([[[99.0, 0.0, 0.0], _on_track(2.5, b), [-1.0, 0.0, 0.0]] for b in range(2)])
    gv = np.array([[True, False, True], [True, True, True]])
    _, _, mask, n = _both(jst, st, gt, gp, gv, 0.5, 9999.0)
    assert n.tolist() == [0, 1] and int(mask.sum()) == 3


def test_lever_arm_used():
    lever = (0.1, -0.2, 0.3)
    jst, st = _state(lever=lever, yaw=0.4)
    gt = np.array([[2.0, 3.3]] * 2)
    gp = np.stack([[_on_track(t, b, lever, 0.4) for t in gt[b]] for b in range(2)])
    _, r, _, n = _both(jst, st, gt, gp, np.ones((2, 2), bool), 0.5, 1.0)
    assert n.tolist() == [2, 2] and float(r.abs().max()) < 1e-9


def test_fix_on_a_clone_time_uses_one_clone():
    """slot0 == slot1: the two 6-column blocks land on the same columns and
    add; in sequence 1 the fix's clone is dropped, so it brackets two."""
    jst, st = _state()
    gt = np.array([[1.0, 4.0]] * 2)
    gp = np.stack([[_on_track(t, b) + 0.05 for t in gt[b]] for b in range(2)])
    H, _, _, n = _both(jst, st, gt, gp, np.ones((2, 2), bool), 0.5, 8.0)
    lo = st.layout
    cols = set(np.nonzero(H[0, :3].abs().sum(0).numpy() > 1e-12)[0])
    assert cols <= set(range(lo.clone(1), lo.clone(1) + 6)) and n.tolist() == [2, 2]
    cols = set(np.nonzero(H[1, :3].abs().sum(0).numpy() > 1e-12)[0])
    assert cols & set(range(lo.clone(0), lo.clone(0) + 6))
    assert cols & set(range(lo.clone(2), lo.clone(2) + 6))


def test_update_pulls_toward_fixes():
    jst, st = _state()
    gt = np.array([[1.5, 2.5, 3.5]] * 2)
    gp = np.stack([[_on_track(t, b) + [0.0, 0.3, 0.0] for t in gt[b]] for b in range(2)])
    H, r, mask, n = _both(jst, st, gt, gp, np.ones((2, 3), bool), 0.5, 10.0)
    assert n.tolist() == [3, 3]
    new = ekf.update(st, H, r, torch.ones_like(r), mask)
    dy = (new.clone_p[0, 2] - st.clone_p[0, 2]).numpy()
    assert dy[1] > 0.05 and abs(dy[0]) < 0.05 and abs(dy[2]) < 0.05


@pytest.mark.parametrize("lam", [0.0, 0.3, 1.0])
def test_interpolate_pose_linear_matches_jax(lam):
    rng = np.random.default_rng(2)
    q = rng.normal(size=(2, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    p = rng.normal(size=(2, 3))
    R, pt = interpolate_pose_linear(*(torch.as_tensor(a) for a in (q[0], p[0], q[1], p[1])),
                                    torch.tensor(lam, dtype=F64))
    jR, jp = j_interp(*(jnp.asarray(a) for a in (q[0], p[0], q[1], p[1])), lam)
    np.testing.assert_allclose(R.numpy(), np.asarray(jR), rtol=0, atol=1e-12)
    np.testing.assert_allclose(pt.numpy(), np.asarray(jp), rtol=0, atol=1e-12)
    if lam in (0.0, 1.0):
        want = np.asarray(j_lie.quat_2_rot(jnp.asarray(q[int(lam)])))
        np.testing.assert_allclose(R.numpy(), want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("spread", [1.0, 1e-7])
def test_gps_linear_system_matches_jax_between_far_clones(spread):
    """The closed-form Jacobian against jax.jacfwd where the two bounding
    clones are far apart in rotation (spread 1: angles of ~1 rad) and where
    they nearly coincide (the small-angle branches)."""
    from plviwo_tpu.update.gps import gps_linear_system as j_system
    from plviwo_tpu_torch.update.gps import gps_linear_system

    rng = np.random.default_rng(5)
    C, Ng = 4, 5
    q = rng.normal(size=(C, 4))
    q[1:] = q[0] + spread * rng.normal(size=(C - 1, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q *= np.sign(q[:, 3:])
    p = rng.normal(size=(C, 3))
    qf = q + 1e-3 * rng.normal(size=q.shape)
    qf /= np.linalg.norm(qf, axis=1, keepdims=True)
    pf = p + 1e-3
    s0, s1 = np.array([0, 1, 2, 3, 0]), np.array([1, 3, 0, 3, 0])
    lam = np.array([0.3, 0.0, 1.0, 0.0, 0.7])
    ext, meas = rng.normal(size=3), rng.normal(size=(Ng, 3))
    H, r = gps_linear_system(*(torch.as_tensor(a)[None] for a in (q, p, qf, pf, s0, s1, lam,
                                                                   ext, meas)))
    for i in range(Ng):
        jH, jr = j_system(*(jnp.asarray(a) for a in (q, p, qf, pf)), int(s0[i]), int(s1[i]),
                          lam[i], jnp.asarray(ext), jnp.asarray(meas[i]))
        np.testing.assert_allclose(H[0, i].numpy(), np.asarray(jH), rtol=0, atol=1e-9)
        np.testing.assert_allclose(r[0, i].numpy(), np.asarray(jr), rtol=0, atol=1e-9)
