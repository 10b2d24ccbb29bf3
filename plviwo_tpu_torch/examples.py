"""Example inputs of the fused step and the images-in frame, built with
numpy (and the port's simulator) alone.

- `example_inputs` / `example_inputs_full`: port of
  `__graft_entry__._example_inputs` / `_example_inputs_full` (which need
  JAX): a warm clone ring along an x-baseline observing landmarks and 3-D
  line segments ~5 m ahead with exact projections, a quiet IMU window and a
  constant-velocity wheel stack, so one step accepts real point, line and
  wheel rows.  The same seeds give the same arrays as the JAX builders.
- `seed_state`, `imu_window`, `wheel_window`: ports of the builders of
  tests/test_fused_frame.py:29-82; `noisy_batch`, `lk_pair` and
  `frame_inputs` assemble B-sequence frame inputs on the card as bench.py's
  images-in unit does.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.layout import StateLayout
from .core.state import CUDA, FilterState, make_state

SIGMA_LINE = 2.0
WHEEL_NOISE = (0.2, 0.5, 0.1)  # KAIST Wheel3DAng noise (config_wheel.yaml)
FX, FY, CX, CY = 300.0, 300.0, 320.0, 240.0


def example_inputs(n_clones=8, F=8, O=6, imu_n=8, device=CUDA):
    """(state (B = 1, on `device`), imu_t, imu_w, imu_a, t_new, obs_uv,
    obs_uvn, obs_slot, obs_valid, gravity, sigmas, sigma_pix, chi2_mult) —
    unbatched numpy arrays after the state, as
    `__graft_entry__._example_inputs` orders them."""
    layout = StateLayout(n_clones=n_clones, n_cams=1)
    st = make_state(layout, priors={"imu_th": 1e-3, "imu_p": 1e-6, "imu_v": 1e-2,
                                    "imu_bg": 1e-2, "imu_ba": 1e-2},
                    device="cpu").to_numpy()
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

    state = FilterState.from_numpy(st, layout, device)
    gravity = np.array([0.0, 0.0, 9.81])
    sigmas = (1.7e-4, 2.0e-3, 1.9e-5, 3.0e-3)
    return (state, imu_t, imu_w, imu_a, t_new, obs_uv, obs_uvn, obs_slot,
            obs_valid, gravity, sigmas, 1.0, 1.0)


def example_inputs_full(n_clones=8, F=8, O=6, imu_n=8, L=4, n_wheel=16, device=CUDA):
    """`example_inputs` plus consistent line segments and a wheel stack, in
    the argument order of `fused_step_full` (up to chi2_mult)."""
    args = example_inputs(n_clones=n_clones, F=F, O=O, imu_n=imu_n, device=device)
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


def batch_args(args, B: int, device=CUDA, n_batched: int = 16):
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


# ---------------------------------------------------------------------------
# images-in frame inputs from the simulator (numpy ports of the builders of
# tests/test_fused_frame.py:29-82)
# ---------------------------------------------------------------------------

IMU_PAD = 32
WHEEL_PAD = 16


def seed_state(sim, layout: StateLayout, t0: float) -> dict:
    """Ground-truth-seeded filter state at t0 (the Initializer's set_state)
    as a dict of numpy arrays with the JAX FilterState's unbatched shapes;
    `FilterState.from_numpy([d] * B, layout, device)` batches it."""
    c = sim.cfg
    st = make_state(layout, priors={"imu_th": 1e-3, "imu_p": 1e-5, "imu_v": 1e-2,
                                    "imu_bg": 1e-3, "imu_ba": 1e-2},
                    device="cpu").to_numpy()
    q, p = sim.gt_pose(t0)
    v = sim.gt_kin(t0)["v_IinG"]
    # bias truths are random-walk series; seed with the value at t0
    i0 = min(int(np.searchsorted(sim.imu_t, t0)), len(sim.bg_true) - 1)
    bg, ba = sim.bg_true[i0], sim.ba_true[i0]
    st.update(time=np.array(t0, dtype=np.float64), q=q, p=p, v=v, bg=bg, ba=ba,
              q_fej=q.copy(), p_fej=p.copy(), v_fej=v.copy(), bg_fej=bg.copy(),
              ba_fej=ba.copy(),
              wheel_q=np.asarray(c.wheel_ext_q, dtype=np.float64),
              wheel_p=np.asarray(c.wheel_ext_p, dtype=np.float64),
              wheel_k=np.array([c.wheel_rl, c.wheel_rr, c.wheel_base]))
    st["cam_k"][0] = c.intrinsics
    st["cam_q"][0] = c.cam_ext_q
    st["cam_p"][0] = c.cam_ext_p
    return st


def imu_window(imu_t, imu_w, imu_a, t_prev, t_new, pad=IMU_PAD):
    """Padded IMU stack covering (t_prev, t_new] plus one boundary sample
    each side: (t (pad,), w (pad,3), a (pad,3))."""
    i0 = max(int(np.searchsorted(imu_t, t_prev)) - 1, 0)
    i1 = min(int(np.searchsorted(imu_t, t_new)) + 1, len(imu_t))
    t, w, a = imu_t[i0:i1][:pad], imu_w[i0:i1][:pad], imu_a[i0:i1][:pad]
    n = len(t)
    return (np.concatenate([t, np.full(pad - n, t[-1])]),
            np.concatenate([w, np.tile(w[-1], (pad - n, 1))]),
            np.concatenate([a, np.tile(a[-1], (pad - n, 1))]))


def wheel_window(sim, t_prev, t_new, pad=WHEEL_PAD):
    """pad // 2 wheel samples over [t_prev, t_new], padded with the last:
    (t (pad,), m1 (pad,), m2 (pad,))."""
    ts = np.linspace(t_prev, t_new, pad // 2)
    m = np.array([sim.wheel_sample(t) for t in ts])
    rep = pad - len(ts)
    return (np.concatenate([ts, np.full(rep, ts[-1])]),
            np.concatenate([m[:, 0], np.full(rep, m[-1, 0])]),
            np.concatenate([m[:, 1], np.full(rep, m[-1, 1])]))


def noisy_batch(img, B: int, gen: torch.Generator, sigma: float = 2e-3):
    """(B,H,W) copies of one (H,W) frame on gen's device, each with its own
    +-1 gray-level pixel noise (as bench.py decorrelates the sequences:
    the front-end then does B sequences' work, not one)."""
    img = torch.as_tensor(img, device=gen.device)
    noise = torch.randn((B,) + tuple(img.shape), generator=gen, device=gen.device)
    return torch.clamp(img[None] + sigma * noise, 0.0, 1.0)


def lk_pair(sim, B: int, n_pts: int, t: float, gen: torch.Generator, dt: float = 0.1,
            grid=(16, 12)):
    """LK kernel inputs at a frame's shapes: two consecutive rendered frames
    (t, t + dt) per sequence with `noisy_batch` noise, equalized into
    3-level pyramids, and the corners `detect_grid` finds in the first.
    Returns (prev_pyr, next_pyr, uv_prev (B,n_pts,2), valid (B,n_pts))."""
    from .ops import image, klt

    pyrs = [tuple(image.build_pyramid(image.hist_equalize_quantile(
        noisy_batch(sim.render_frame(tt), B, gen)), 3)) for tt in (t, t + dt)]
    none = torch.zeros((B, 0, 2), device=gen.device)
    uv, valid = klt.detect_grid(pyrs[0][0], none, none[..., 0].bool(), grid[0], grid[1],
                                n_pts, min_px_dist=10.0)
    return pyrs[0], pyrs[1], uv, valid


def frame_inputs(sim, B: int, n_frames: int, gen: torch.Generator, t0: float = 1.0,
                 dt: float = 0.1):
    """`fused_frame` inputs of n_frames frames at t0 + dt (i + 1) for B
    sequences on gen's device: per frame a dict with `t`, `img` (B,H,W)
    (`noisy_batch` noise), `imu` (t (B,32), w (B,32,3), a (B,32,3)),
    `t_new` (B,) and `wheel` (t, m1, m2 (B,16)) — the same IMU and wheel
    data for every sequence, as bench.py feeds them."""
    imu = sim.imu_stream()
    frames, t_prev = [], t0
    for i in range(n_frames):
        t = t0 + dt * (i + 1)
        win = imu_window(*imu, t_prev, t) + (np.full(1, t),) + wheel_window(sim, t_prev, t)
        per = [torch.as_tensor(a, device=gen.device).expand((B,) + a.shape).contiguous()
               for a in win]
        frames.append(dict(t=t, img=noisy_batch(sim.render_frame(t), B, gen), imu=per[:3],
                           t_new=per[3][:, 0], wheel=per[4:]))
        t_prev = t
    return frames
