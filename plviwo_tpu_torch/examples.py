"""Example filter inputs for the fused step, built with numpy alone.

Port of `__graft_entry__._example_inputs` / `_example_inputs_full` (which
need JAX): a warm clone ring along an x-baseline observing landmarks and
3-D line segments ~5 m ahead with exact projections, a quiet IMU window and
a constant-velocity wheel stack, so one step accepts real point, line and
wheel rows.  The same seeds give the same arrays as the JAX builders.
"""

from __future__ import annotations

import numpy as np
import torch

from plviwo_tpu.core.layout import StateLayout

from .core.state import FilterState, make_state

SIGMA_LINE = 2.0
WHEEL_NOISE = (0.2, 0.5, 0.1)  # KAIST Wheel3DAng noise (config_wheel.yaml)
FX, FY, CX, CY = 300.0, 300.0, 320.0, 240.0


def example_inputs(n_clones=8, F=8, O=6, imu_n=8):
    """(state (B = 1), imu_t, imu_w, imu_a, t_new, obs_uv, obs_uvn, obs_slot,
    obs_valid, gravity, sigmas, sigma_pix, chi2_mult) — unbatched numpy
    arrays after the state, as `__graft_entry__._example_inputs` orders them."""
    layout = StateLayout(n_clones=n_clones, n_cams=1)
    st = make_state(layout, priors={"imu_th": 1e-3, "imu_p": 1e-6, "imu_v": 1e-2,
                                    "imu_bg": 1e-2, "imu_ba": 1e-2}).to_numpy()
    st["time"] = np.array(0.0)
    st["cam_k"][0] = [FX, FY, CX, CY, 0, 0, 0, 0]

    K = min(O, n_clones - 2)
    dt = 0.005
    t_new = (imu_n - 1) * dt
    spacing_t = 0.85 / max(K - 1, 1)
    vel = 0.1 / spacing_t
    rng = np.random.default_rng(0)
    clone_t = np.full(n_clones, np.inf)
    clone_p = np.zeros((n_clones, 3))
    clone_valid = np.zeros(n_clones, dtype=bool)
    for j in range(K):
        clone_t[j] = t_new - 0.9 + spacing_t * j
        clone_p[j] = [0.1 * j, 0.0, 0.0]
        clone_valid[j] = True
    x0 = 0.1 * (K - 1) + vel * (0.0 - clone_t[K - 1])
    st.update(clone_t=clone_t, clone_p=clone_p, clone_p_fej=clone_p.copy(),
              clone_valid=clone_valid,
              p=np.array([x0, 0.0, 0.0]), p_fej=np.array([x0, 0.0, 0.0]),
              v=np.array([vel, 0.0, 0.0]), v_fej=np.array([vel, 0.0, 0.0]))
    diag_idx = np.arange(layout.clone_off, layout.clone_off + 6 * K)
    st["cov"][diag_idx, diag_idx] = np.tile([1e-4] * 3 + [1e-3] * 3, K)

    imu_t = np.arange(imu_n) * dt
    imu_w = 1e-4 * rng.normal(size=(imu_n, 3))
    imu_a = np.array([0.0, 0.0, 9.81]) + 1e-4 * rng.normal(size=(imu_n, 3))

    p_f = np.stack([rng.uniform(-1.5, 1.5, size=F), rng.uniform(-1.0, 1.0, size=F),
                    rng.uniform(4.0, 7.0, size=F)], axis=1)
    obs_uvn = np.zeros((F, O, 2))
    obs_uv = np.zeros((F, O, 2))
    obs_slot = np.zeros((F, O), dtype=np.int32)
    obs_valid = np.zeros((F, O), dtype=bool)
    for i in range(F):
        for o in range(min(O, K)):
            rel = p_f[i] - clone_p[o]  # identity rotations and extrinsic
            uvn = rel[:2] / rel[2]
            obs_uvn[i, o] = uvn
            obs_uv[i, o] = [FX * uvn[0] + CX, FY * uvn[1] + CY]
            obs_slot[i, o] = o
            obs_valid[i, o] = True

    state = FilterState.from_numpy(st, layout)
    gravity = np.array([0.0, 0.0, 9.81])
    sigmas = (1.7e-4, 2.0e-3, 1.9e-5, 3.0e-3)
    return (state, imu_t, imu_w, imu_a, t_new, obs_uv, obs_uvn, obs_slot,
            obs_valid, gravity, sigmas, 1.0, 1.0)


def example_inputs_full(n_clones=8, F=8, O=6, imu_n=8, L=4, n_wheel=16):
    """`example_inputs` plus consistent line segments and a wheel stack, in
    the argument order of `fused_step_full` (up to chi2_mult)."""
    args = example_inputs(n_clones=n_clones, F=F, O=O, imu_n=imu_n)
    st = args[0].to_numpy()
    K = min(O, n_clones - 2)
    clone_p, clone_t = st["clone_p"], st["clone_t"]
    t_new = args[4]
    rng = np.random.default_rng(1)

    base = np.stack([rng.uniform(-1.0, 1.0, size=L), rng.uniform(-0.8, 0.8, size=L),
                     rng.uniform(4.5, 6.5, size=L)], axis=1)
    d = rng.normal(size=(L, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    P1, P2 = base, base + d
    line_uv = np.zeros((L, O, 4))
    line_uvn = np.zeros((L, O, 4))
    line_slot = np.zeros((L, O), dtype=np.int32)
    line_valid = np.zeros((L, O), dtype=bool)
    for i in range(L):
        for o in range(min(O, K)):
            e1 = (P1[i] - clone_p[o])[:2] / (P1[i] - clone_p[o])[2]
            e2 = (P2[i] - clone_p[o])[:2] / (P2[i] - clone_p[o])[2]
            line_uvn[i, o] = [e1[0], e1[1], e2[0], e2[1]]
            line_uv[i, o] = [FX * e1[0] + CX, FY * e1[1] + CY,
                             FX * e2[0] + CX, FY * e2[1] + CY]
            line_slot[i, o] = o
            line_valid[i, o] = True

    spacing_t = 0.85 / max(K - 1, 1)
    vel = 0.1 / spacing_t
    n_real = max(n_wheel // 2, 2)
    wt = np.linspace(clone_t[K - 1], t_new, n_real)
    wt = np.concatenate([wt, np.full(n_wheel - n_real, wt[-1])])
    wm = np.full(n_wheel, vel)  # m1 = m2 = vel -> w = 0, v = vel (intr 1,1,1)

    return args[:9] + (line_uv, line_uvn, line_slot, line_valid,
                       wt, wm, wm.copy(), np.array(True)) + args[9:]


def batch_args(args, B: int, device="cpu", n_batched: int = 16):
    """Repeat an example over B sequences as batch-first tensors on `device`.

    The state and the first `n_batched` per-frame arrays get the leading B
    axis (t_new becomes (B,)); float arrays become float64, index arrays
    int64; of the trailing arguments, gravity becomes a float64 tensor on
    `device` and the scalars (sigmas, sigma_pix, ...) pass through."""
    state = args[0]
    out = [FilterState.from_numpy([state.to_numpy()] * B, state.layout, device)]
    for a in args[1:1 + n_batched]:
        a = np.asarray(a)
        if a.dtype == bool:
            dt = torch.bool
        elif np.issubdtype(a.dtype, np.integer):
            dt = torch.int64
        else:
            dt = torch.float64
        t = torch.as_tensor(a, device=device).to(dt)
        out.append(t.expand((B,) + t.shape).contiguous())
    out.extend(torch.as_tensor(a, dtype=torch.float64, device=device)
               if isinstance(a, np.ndarray) else a for a in args[1 + n_batched:])
    return tuple(out)
