"""Module-by-module parity of the port's filter core with the JAX package.

Each case makes its inputs once with numpy, feeds them to the JAX function
and to its port (with a leading sequence axis where the port is
batch-first), and compares the outputs.  Tolerance 1e-10 (relative to the
output's scale) where both sides compute in float64; looser, with the
reason, where the JAX side runs part of the work in float32 (its TPU
mixed-precision solves and float32 transition matrices).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plviwo_tpu.core import ekf as jekf
from plviwo_tpu.core import propagator as jprop
from plviwo_tpu.core import step as jstep
from plviwo_tpu.core.layout import StateLayout
from plviwo_tpu.core.state import FilterState as JState
from plviwo_tpu.core.state import make_state as jmake_state
from plviwo_tpu.ops import cam as jcam
from plviwo_tpu.ops import lie as jlie
from plviwo_tpu.ops import linalg as jlin
from plviwo_tpu.ops import plucker as jplk
from plviwo_tpu.update import cam_helper as jch
from plviwo_tpu.update import lines as jlines
from plviwo_tpu.update import wheel as jwheel
from plviwo_tpu_torch.core import ekf as tekf
from plviwo_tpu_torch.core import propagator as tprop
from plviwo_tpu_torch.core import step as tstep
from plviwo_tpu_torch.core.state import FilterState as TState
from plviwo_tpu_torch.core.state import make_state as tmake_state
from plviwo_tpu_torch.ops import cam as tcam
from plviwo_tpu_torch.ops import lie as tlie
from plviwo_tpu_torch.ops import linalg as tlin
from plviwo_tpu_torch.ops import plucker as tplk
from plviwo_tpu_torch.update import cam_helper as tch
from plviwo_tpu_torch.update import lines as tlines
from plviwo_tpu_torch.update import wheel as twheel

torch.set_num_threads(1)

F64_TOL = 1e-10


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _close(got, want, tol=F64_TOL):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if want.dtype == bool or np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got, want)
        return
    scale = max(float(np.max(np.abs(want))) if want.size else 0.0, 1.0)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


def _quats(rng, n):
    q = rng.normal(size=(n, 4))
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _spd(rng, n, batch=()):
    A = rng.normal(size=batch + (n, 2 * n))
    return A @ np.swapaxes(A, -1, -2) / (2 * n) + 0.1 * np.eye(n)


# --------------------------------------------------------------------------
# L0: lie, linalg, cam, plucker
# --------------------------------------------------------------------------

def _case_lie(rng):
    q, p = _quats(rng, 16), _quats(rng, 16)
    # rotation angles from 0 through the Taylor cutoff to ~pi
    w = rng.normal(size=(16, 3)) * np.logspace(-9, 0.4, 16)[:, None]
    R = np.asarray(jlie.quat_2_rot(jnp.asarray(q)))
    for jf, tf, x in [
        (jlie.skew, tlie.skew, w), (jlie.quat_norm, tlie.quat_norm, q * 3.0),
        (jlie.quat_2_rot, tlie.quat_2_rot, q), (jlie.rot_2_quat, tlie.rot_2_quat, R),
        (jlie.exp_so3, tlie.exp_so3, w), (jlie.jl_so3, tlie.jl_so3, w),
        (jlie.jr_so3, tlie.jr_so3, w), (jlie.log_so3, tlie.log_so3, R),
        (jlie.omega, tlie.omega, w),
    ]:
        _close(tf(_t(x)), jf(jnp.asarray(x)))
    _close(tlie.quat_multiply(_t(q), _t(p)), jlie.quat_multiply(jnp.asarray(q), jnp.asarray(p)))


def _case_linalg(rng):
    A = rng.normal(size=(10, 3, 3))
    b = rng.normal(size=(10, 3))
    S3 = _spd(rng, 3, (10,))
    S6 = _spd(rng, 6, (5,))
    r6 = rng.normal(size=(5, 6))
    _close(tlin.solve3x3(_t(A), _t(b)), jlin.solve3x3(jnp.asarray(A), jnp.asarray(b)))
    _close(tlin.eigvals_sym3x3(_t(S3)), jlin.eigvals_sym3x3(jnp.asarray(S3)))
    _close(tlin.solve_psd(_t(S6), _t(r6)), jlin.solve_psd(jnp.asarray(S6), jnp.asarray(r6)))
    L = jlin.chol_unrolled(jnp.asarray(S6))
    _close(tlin.chol_unrolled(_t(S6)), L)
    _close(tlin.forward_sub_unrolled(_t(np.asarray(L)), _t(r6)),
           jlin.forward_sub_unrolled(L, jnp.asarray(r6)))
    _close(tlin.chi2_quadform(_t(S6), _t(r6)), jlin.chi2_quadform(jnp.asarray(S6), jnp.asarray(r6)))
    G = rng.normal(size=(4, 5, 5)) + 3 * np.eye(5)
    _close(tlin.inv_small(_t(G)), jlin.inv_small(jnp.asarray(G)))


def _case_cam(rng):
    zn = rng.uniform(-0.6, 0.6, size=(20, 2))
    zn[0] = 0.0  # the equidistant small-radius branch
    k = np.array([300.0, 310.0, 320.0, 240.0, -0.28, 0.07, 1e-4, -2e-4])
    for model, jf, tf in [(0, jcam.distort_radtan, tcam.distort_radtan),
                          (1, jcam.distort_equi, tcam.distort_equi)]:
        _close(tf(_t(zn), _t(k)), jf(jnp.asarray(zn), jnp.asarray(k)))
        Jz0, Jk0 = jcam.distort_jacobian(jnp.asarray(zn), jnp.asarray(k), model)
        Jz1, Jk1 = tcam.distort_jacobian(_t(zn), _t(k), model)
        _close(Jz1, Jz0)
        _close(Jk1, Jk0)
        p_C = np.concatenate([zn * 4.0, np.full((20, 1), 4.0)], axis=1)
        _close(tcam.project(_t(p_C), _t(k), model), jcam.project(jnp.asarray(p_C), jnp.asarray(k), model))


def _case_plucker(rng):
    n, v = rng.normal(size=(12, 3)), rng.normal(size=(12, 3))
    R = np.asarray(jlie.quat_2_rot(jnp.asarray(_quats(rng, 12))))
    pc = rng.normal(size=(12, 3))
    k = np.array([300.0, 310.0, 320.0, 240.0, 0, 0, 0, 0])
    d4 = 0.1 * rng.normal(size=(12, 4))
    uv = rng.uniform(0, 600, size=(12, 2))
    J = lambda *a: [jnp.asarray(x) for x in a]  # noqa: E731
    T = lambda *a: [_t(x) for x in a]  # noqa: E731
    for a, b in zip(tplk.transform(*T(n, v, R, pc)), jplk.transform(*J(n, v, R, pc))):
        _close(a, b)
    l0 = jplk.project(*J(n, k))
    _close(tplk.project(*T(n, k)), l0)
    _close(tplk.point_line_distance(_t(uv), _t(np.asarray(l0))), jplk.point_line_distance(jnp.asarray(uv), l0))
    for a, b in zip(tplk.to_orthonormal(*T(n, v)), jplk.to_orthonormal(*J(n, v))):
        _close(a, b)
    for a, b in zip(tplk.apply_orthonormal_delta(*T(n, v, d4)),
                    jplk.apply_orthonormal_delta(*J(n, v, d4))):
        _close(a, b)
    _close(tplk.closest_point_to_origin(*T(n, v)), jplk.closest_point_to_origin(*J(n, v)))


# --------------------------------------------------------------------------
# L2: state helpers, propagation, EKF primitives
# --------------------------------------------------------------------------

LAYOUT = StateLayout(n_clones=6, n_cams=1)
PRIORS = {"imu_th": 1e-3, "imu_p": 1e-3, "imu_v": 1e-2, "imu_bg": 1e-2,
          "imu_ba": 1e-2, "cam_ext": 1e-3, "cam_int": 1.0}


def _warm_state(rng, layout=LAYOUT, n_valid=4):
    """A JAX state with random clones, poses and a dense SPD covariance."""
    st = jmake_state(layout, priors=PRIORS)
    C, D = layout.n_clones, layout.dim
    valid = np.arange(C) < n_valid
    cq = _quats(rng, C)
    q = _quats(rng, 1)[0]
    cov = _spd(rng, D) * 1e-3
    st = st.replace(
        time=jnp.asarray(0.5), q=jnp.asarray(q), q_fej=jnp.asarray(q),
        p=jnp.asarray(rng.normal(size=3)), v=jnp.asarray(rng.normal(size=3)),
        p_fej=jnp.asarray(rng.normal(size=3)), v_fej=jnp.asarray(rng.normal(size=3)),
        bg=jnp.asarray(1e-3 * rng.normal(size=3)), ba=jnp.asarray(1e-2 * rng.normal(size=3)),
        clone_q=jnp.asarray(cq), clone_q_fej=jnp.asarray(cq),
        clone_p=jnp.asarray(rng.normal(size=(C, 3))),
        clone_p_fej=jnp.asarray(rng.normal(size=(C, 3))),
        clone_t=jnp.asarray(np.where(valid, np.linspace(-0.6, 0.4, C), np.inf)),
        clone_valid=jnp.asarray(valid),
        cov=jnp.asarray(cov))
    return st


def _to_torch(st: JState) -> TState:
    return TState.from_numpy({f.name: np.asarray(getattr(st, f.name))
                              for f in dataclasses.fields(st) if f.name != "layout"},
                             st.layout, device="cpu")


def _close_state(ts: TState, js: JState, tol=F64_TOL, cov_tol=None):
    got = ts.to_numpy()
    for name, want in got.items():
        _close(got[name], np.asarray(getattr(js, name)),
               cov_tol if (name == "cov" and cov_tol) else tol)


def _case_state(rng):
    js = jmake_state(LAYOUT, priors=PRIORS)
    ts = tmake_state(LAYOUT, priors=PRIORS, device="cpu")
    _close_state(ts, js)
    ws = _warm_state(rng)
    _close(tstep.newest_clone_slot(_to_torch(ws)), np.asarray(jstep.newest_clone_slot(ws))[None])


def _imu_window(rng, n=12):
    t = np.concatenate([np.linspace(0.5, 0.6, n - 3), np.full(3, 0.6)])  # padded
    w = 0.3 * rng.normal(size=(n, 3))
    a = np.array([0.0, 0.0, 9.81]) + 0.5 * rng.normal(size=(n, 3))
    return t, w, a


SIGMAS = (1.7e-4, 2.0e-3, 1.9e-5, 3.0e-3)
GRAV = np.array([0.0, 0.0, 9.81])


def _case_rk4(rng):
    q = _quats(rng, 6)
    p, v = rng.normal(size=(6, 3)), rng.normal(size=(6, 3))
    w1, a1, w2, a2 = (rng.normal(size=(6, 3)) for _ in range(4))
    dt = np.array([0.005, 0.01, 0.0, 0.002, 0.005, 0.02])
    for i in range(6):
        out0 = jprop.rk4_mean(*(jnp.asarray(x[i]) for x in (q, p, v, w1, a1, w2, a2, dt)),
                              jnp.asarray(GRAV))
        out1 = tprop.rk4_mean(*(_t(x[i:i + 1]) for x in (q, p, v, w1, a1, w2, a2)),
                              _t(dt[i:i + 1]), _t(GRAV))
        for a, b in zip(out1, out0):
            _close(a[0], b)


def _case_step_transition(rng):
    """Both in float64 here (the step runs it in float32 on both sides)."""
    qf, nq = _quats(rng, 5), _quats(rng, 5)
    dp, dv, wh = (rng.normal(size=(5, 3)) for _ in range(3))
    dt = np.array([0.005, 0.0, 0.01, 0.002, 0.005])
    F1, Q1 = tprop.step_transition(_t(qf), _t(dp), _t(dv), _t(nq), _t(wh), _t(dt), SIGMAS)
    for i in range(5):
        F0, Q0 = jprop.step_transition(*(jnp.asarray(x[i]) for x in (qf, dp, dv, nq, wh, dt)),
                                       SIGMAS)
        _close(F1[i], F0)
        _close(Q1[i], Q0)


def _case_propagate(rng):
    """Mean in float64 on both sides (1e-10); Phi/Qd and so the covariance
    come from float32 transition matrices on both sides, whose products
    associate alike but round differently (1e-6 of the scale)."""
    js = _warm_state(rng)
    t, w, a = _imu_window(rng)
    j1 = jprop.propagate(js, jnp.asarray(t), jnp.asarray(w), jnp.asarray(a), 0.6, GRAV, SIGMAS)
    t1 = tprop.propagate(_to_torch(js), _t(t)[None], _t(w)[None], _t(a)[None],
                         _t([0.6]), _t(GRAV), SIGMAS)
    _close_state(t1, j1, cov_tol=1e-6)


def _case_ekf(rng):
    """The JAX EKF update solves with an f32 factor + one f64 refinement and
    split-f32 products (TPU workarounds); the port factors in float64, so
    the two agree to ~1e-8 of the scale."""
    js = _warm_state(rng)
    D = LAYOUT.dim
    M = 9
    H = rng.normal(size=(M, D))
    r = 1e-2 * rng.normal(size=M)
    rd = rng.uniform(0.5, 2.0, size=M)
    mask = rng.uniform(size=M) < 0.8
    H[~mask] = np.nan  # masked rows may carry NaN
    j1 = jekf.update(js, jnp.asarray(H), jnp.asarray(r), jnp.asarray(rd), jnp.asarray(mask))
    t1 = tekf.update(_to_torch(js), _t(H)[None], _t(r)[None], _t(rd)[None], _t(mask)[None])
    _close_state(t1, j1, tol=1e-8)

    chi0 = jekf.chi2(js.cov, jnp.asarray(H), jnp.asarray(r), jnp.asarray(rd), jnp.asarray(mask))
    chi1 = tekf.chi2(_t(np.asarray(js.cov))[None], _t(H)[None], _t(r)[None], _t(rd)[None],
                     _t(mask)[None])
    _close(chi1[0], chi0, tol=1e-8)

    Hw = rng.normal(size=(6, D))
    rw = rng.normal(size=6)
    Rf = _spd(rng, 6)
    for a, b in zip(tekf.whiten(_t(Hw)[None], _t(rw)[None], _t(Rf)[None]),
                    jekf.whiten(jnp.asarray(Hw), jnp.asarray(rw), jnp.asarray(Rf))):
        _close(a[0], b)

    phi = np.eye(15) + 0.01 * rng.normal(size=(15, 15))
    qd = _spd(rng, 15) * 1e-4
    _close(tekf.propagate_cov(_t(np.asarray(js.cov))[None], _t(phi)[None], _t(qd)[None])[0],
           jekf.propagate_cov(js.cov, jnp.asarray(phi), jnp.asarray(qd)), tol=1e-8)


def _case_clone_marginalize(rng):
    js = _warm_state(rng, n_valid=LAYOUT.n_clones)  # full ring: forces a drop
    ts = _to_torch(js)
    jm = jstep._auto_marginalize(js, 0.5, 1.0)
    tm = tstep._auto_marginalize(ts, ts.time, 1.0)
    _close_state(tm, jm)
    _close_state(tekf.augment_clone(tm), jekf.augment_clone(jm))
    drop = np.array([True, False, False, True, False, False])
    _close_state(tstep.marginalize_mask(ts, _t(drop)[None]),
                 jstep.marginalize_mask(js, jnp.asarray(drop)))
    dx = 1e-3 * rng.normal(size=LAYOUT.dim)
    _close_state(tekf.apply_dx(ts, _t(dx)[None]), jekf.apply_dx(js, jnp.asarray(dx)))


def _case_compress(rng):
    """JAX factors the equilibrated Gram in float32 (TPU workaround); the
    port in float64: the compressed rows agree to ~1e-6 relative, and both
    give the same information (H'^T H' = G + jitter)."""
    D = 30
    H = rng.normal(size=(50, D))
    H[:, 20:] = 0.0  # null directions (empty clone slots)
    G = H.T @ H
    c = H.T @ rng.normal(size=50)
    Hc0, rc0, v0 = jekf.compress_from_gram(jnp.asarray(G), jnp.asarray(c))
    Hc1, rc1, v1 = tekf.compress_from_gram(_t(G)[None], _t(c)[None])
    _close(v1[0], v0)
    _close(Hc1[0], Hc0, tol=1e-5)
    _close(rc1[0], rc0, tol=1e-5)
    np.testing.assert_allclose((Hc1[0].T @ Hc1[0]).numpy(), G, rtol=1e-4, atol=1e-4 * np.abs(G).max())


# --------------------------------------------------------------------------
# L3: triangulation, point / line systems, wheel
# --------------------------------------------------------------------------

def _geometry(rng, F=5, O=4, C=6):
    """Clones along x looking at points ~5 m ahead, with noisy observations."""
    cq = _quats(rng, C) * 0.02 + np.array([0, 0, 0, 1.0])
    cq /= np.linalg.norm(cq, axis=1, keepdims=True)
    cp = np.stack([0.2 * np.arange(C), 0.05 * rng.normal(size=C), np.zeros(C)], 1)
    p_f = np.stack([rng.uniform(-1, 1, F), rng.uniform(-1, 1, F), rng.uniform(4, 6, F)], 1)
    slot = np.stack([rng.permutation(C)[:O] for _ in range(F)])
    R = np.asarray(jlie.quat_2_rot(jnp.asarray(cq)))
    valid = np.ones((F, O), dtype=bool)
    valid[0, -1] = False
    pc = np.einsum("foij,foj->foi", R[slot], p_f[:, None] - cp[slot])
    uvn = pc[..., :2] / pc[..., 2:3] + 1e-3 * rng.normal(size=(F, O, 2))
    return cq, cp, p_f, slot, valid, uvn


CAM_Q = np.array([0.01, -0.02, 0.005, 1.0]) / np.linalg.norm([0.01, -0.02, 0.005, 1.0])
CAM_P = np.array([0.05, -0.01, 0.02])
CAM_K = np.array([300.0, 300.0, 320.0, 240.0, -0.1, 0.01, 1e-4, 1e-4])


def _case_triangulate(rng):
    cq, cp, _, slot, valid, uvn = _geometry(rng)
    out0 = jch.triangulate_batch(jnp.asarray(uvn), jnp.asarray(cq[slot]), jnp.asarray(cp[slot]),
                                 jnp.asarray(valid), jnp.asarray(CAM_Q), jnp.asarray(CAM_P))
    out1 = tch.triangulate_batch(_t(uvn)[None], _t(cq[slot])[None], _t(cp[slot])[None],
                                 _t(valid)[None], _t(CAM_Q)[None], _t(CAM_P)[None])
    assert np.asarray(out0[1]).any()
    for a, b in zip(out1, out0):
        _close(a[0], b, tol=1e-9)  # 5 Gauss-Newton steps of 3x3 Cramer solves


def _case_point_systems(rng, model=0):
    cq, cp, p_f, slot, valid, uvn = _geometry(rng)
    C = cq.shape[0]
    uv = 300 * uvn + np.array([320.0, 240.0])
    cqf = cq + 1e-3 * rng.normal(size=cq.shape)
    cqf /= np.linalg.norm(cqf, axis=1, keepdims=True)
    cpf = cp + 1e-3 * rng.normal(size=cp.shape)
    D = StateLayout(n_clones=C).dim
    out0 = jch.point_systems_batch(*(jnp.asarray(x) for x in (p_f, uv, slot, valid, cq, cp, cqf,
                                                              cpf, CAM_Q, CAM_P, CAM_K)),
                                   model, C, 15, D)
    out1 = tch.point_systems_batch(*(_t(x)[None] for x in (p_f, uv, slot, valid, cq, cp, cqf,
                                                           cpf, CAM_Q, CAM_P, CAM_K)),
                                   model, C, 15, D)
    for a, b in zip(out1, out0):
        _close(a[0], b)


def _case_point_systems_equi(rng):
    _case_point_systems(rng, model=1)


def _case_lines(rng):
    cq, cp, _, slot, valid, _ = _geometry(rng, F=4, O=4)
    L, O = slot.shape
    P1 = np.stack([rng.uniform(-1, 1, L), rng.uniform(-1, 1, L), rng.uniform(4, 6, L)], 1)
    P2 = P1 + rng.normal(size=(L, 3))
    R = np.asarray(jlie.quat_2_rot(jnp.asarray(cq)))
    Rc = np.asarray(jlie.quat_2_rot(jnp.asarray(CAM_Q)))

    def proj(P):
        pc = np.einsum("ij,foj->foi", Rc, np.einsum("foij,foj->foi", R[slot], P[:, None] - cp[slot])) + CAM_P
        return pc[..., :2] / pc[..., 2:3]

    uvn = np.concatenate([proj(P1), proj(P2)], -1) + 1e-4 * rng.normal(size=(L, O, 4))
    args = (uvn, cq[slot], cp[slot], valid, CAM_Q, CAM_P)
    out0 = jlines.triangulate_two_plane(*(jnp.asarray(x) for x in args))
    out1 = tlines.triangulate_two_plane(*(_t(x)[None] for x in args))
    for a, b in zip(out1, out0):
        _close(a[0], b)
    n_G, v_G = np.asarray(out0[0]), np.asarray(out0[1])
    C = cq.shape[0]
    D = StateLayout(n_clones=C).dim
    uv = uvn * 300.0 + np.array([320.0, 240.0, 320.0, 240.0])
    k = np.array([300.0, 300.0, 320.0, 240.0, 0, 0, 0, 0])
    sargs = (n_G, v_G, uv, slot, valid, cq, cp, cq, cp, CAM_Q, CAM_P, k)
    out0 = jlines.line_systems_batch(*(jnp.asarray(x) for x in sargs), C, 15, D)
    out1 = tlines.line_systems_batch(*(_t(x)[None] for x in sargs), C, 15, D)
    for a, b in zip(out1, out0):
        _close(a[0], b, tol=1e-9)  # forward-mode Jacobians through Plücker algebra


def _case_wheel(rng):
    n = 12
    t = np.concatenate([np.linspace(0.3, 0.4, n - 3), np.full(3, 0.4)])
    m1 = 2.0 + 0.3 * rng.normal(size=n)
    m2 = 2.2 + 0.3 * rng.normal(size=n)
    intr = np.array([0.31, 0.32, 1.5])
    for tc in (jwheel.W3D_ANG, jwheel.W3D_LIN, jwheel.W3D_CEN):
        out0 = jwheel.preintegrate_3d(jnp.asarray(t), jnp.asarray(m1), jnp.asarray(m2),
                                      jnp.asarray(intr), 0.2, 0.5, 0.1, tc)
        out1 = twheel.preintegrate_3d(_t(t)[None], _t(m1)[None], _t(m2)[None], _t(intr)[None],
                                      0.2, 0.5, 0.1, tc)
        for a, b in zip(out1, out0):
            _close(a[0], b)
    R_m, p_m, _, dR, dp = (np.asarray(x) for x in out0)
    C = 6
    cq, cp = _quats(rng, C), rng.normal(size=(C, 3))
    wq = _quats(rng, 1)[0]
    wp = rng.normal(size=3)
    lo = StateLayout(n_clones=C, use_wheel=True)
    for calib in (False, True):
        H0, r0 = jwheel.linear_system_3d(
            *(jnp.asarray(x) for x in (cq, cp, cq, cp)), 1, 4,
            *(jnp.asarray(x) for x in (wq, wp, R_m, p_m, dR, dp)),
            C, lo.clone_off, lo.dim, lo.wheel_ext, lo.wheel_int, calib, calib)
        H1, r1 = twheel.linear_system_3d(
            *(_t(x)[None] for x in (cq, cp, cq, cp)), _t([1]), _t([4]),
            *(_t(x)[None] for x in (wq, wp, R_m, p_m, dR, dp)),
            C, lo.clone_off, lo.dim, lo.wheel_ext, lo.wheel_int, calib, calib)
        _close(H1[0], H0)
        _close(r1[0], r0)


CASES = {
    "lie": _case_lie, "linalg": _case_linalg, "cam": _case_cam, "plucker": _case_plucker,
    "state": _case_state, "rk4_mean": _case_rk4, "step_transition": _case_step_transition,
    "propagate": _case_propagate, "ekf": _case_ekf,
    "clone_marginalize": _case_clone_marginalize, "compress_from_gram": _case_compress,
    "triangulate": _case_triangulate, "point_systems_radtan": _case_point_systems,
    "point_systems_equi": _case_point_systems_equi, "lines": _case_lines, "wheel": _case_wheel,
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_parity(name):
    CASES[name](np.random.default_rng(sorted(CASES).index(name)))
