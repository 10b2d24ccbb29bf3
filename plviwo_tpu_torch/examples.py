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
  `frame_inputs` assemble B-sequence frame inputs (with GPS fixes) on the
  card as bench.py's images-in unit does.
- The live driver's scenarios: `live_options`, `live_calibrate` and
  `live_events` (images in); `track_events` (the per-track path, fed as
  run_sim feeds it without --images); `feed`.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.layout import StateLayout
from .core.state import CUDA, FilterState, make_state
from .update import lines as line_up

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
GPS_PAD = 4  # fixes per frame (bench.py)


def seed_state(sim, layout: StateLayout, t0: float) -> dict:
    """Ground-truth-seeded filter state at t0 (the Initializer's set_state)
    as a dict of numpy arrays with the JAX FilterState's unbatched shapes;
    `FilterState.from_numpy([d] * B, layout, device)` batches it.  With a
    GPS block in the layout, its antenna lever arm is the simulator's
    (as bench.py sets it); with two cameras, camera 1 is the simulator's
    right stereo camera."""
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
    if layout.n_cams >= 2:
        st["cam_k"][1] = c.intrinsics
        st["cam_q"][1] = c.cam_ext_q
        st["cam_p"][1] = np.asarray(c.cam_ext_p) + [-c.stereo_baseline, 0.0, 0.0]
    if layout.n_gps > 0:
        st["gps_p"][0] = c.gps_ext_p
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


def line_images(B: int, H: int, W: int, seed: int = 0) -> np.ndarray:
    """B float32 images (B, H, W) of bright 2.4-px stripes on a noisy grey
    ground, for the line detector's tests: in each image one stripe along
    each of the 8 lattice directions and eight at angles between them, each
    through a random point and between 20 px and twice the image's diagonal
    long, so that many run into a border."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    lattice = [np.arctan2(dy, dx) for dx, dy in
               ((1, 0), (2, 1), (1, 1), (1, 2), (0, 1), (-1, 2), (-1, 1), (-2, 1))]
    out = np.empty((B, H, W), np.float32)
    for b in range(B):
        img = 0.45 + 0.01 * rng.standard_normal((H, W))
        for ang in lattice + [a + rng.uniform(0.1, 0.3) for a in lattice]:
            cx, cy = rng.uniform(0, W), rng.uniform(0, H)
            half = rng.uniform(10.0, np.hypot(H, W))
            ux, uy = np.cos(ang), np.sin(ang)
            along = (xx - cx) * ux + (yy - cy) * uy
            across = -(xx - cx) * uy + (yy - cy) * ux
            d = np.hypot(across, np.maximum(np.abs(along) - half, 0.0))
            img += rng.uniform(0.15, 0.4) * np.exp(-0.5 * (d / 1.2) ** 2)
        out[b] = np.clip(img, 0.0, 1.0)
    return out


def frame_inputs(sim, B: int, n_frames: int, gen: torch.Generator, t0: float = 1.0,
                 dt: float = 0.1, gps_pad: int = GPS_PAD, stereo: bool = False):
    """`fused_frame` inputs of n_frames frames at t0 + dt (i + 1) for B
    sequences on gen's device: per frame a dict with `t`, `img` (B,H,W)
    (`noisy_batch` noise), `imu` (t (B,32), w (B,32,3), a (B,32,3)),
    `t_new` (B,), `wheel` (t, m1, m2 (B,16)) and, with gps_pad > 0, `gps`
    (t (B,gps_pad), p (B,gps_pad,3), valid (B,gps_pad)): the fixes in
    (t_prev, t], padded with the frame time.  The same IMU, wheel and GPS
    data for every sequence, drawn from the simulator's generator in
    bench.py's order: every GPS sample first, then per frame the image
    and the wheel samples.  With stereo each frame also has `img_r`, the
    right camera's image (rendered after the left one, its own noise)."""
    imu = sim.imu_stream()
    fixes = [(float(t), sim.gps_sample(t)) for t in sim.gps_times()] if gps_pad else []
    frames, t_prev = [], t0
    for i in range(n_frames):
        t = t0 + dt * (i + 1)
        img = noisy_batch(sim.render_frame(t), B, gen)
        img_r = noisy_batch(sim.render_frame(t, cam=1), B, gen) if stereo else None
        win = imu_window(*imu, t_prev, t) + (np.full(1, t),) + wheel_window(sim, t_prev, t)
        if gps_pad:
            gt, gp, gv = np.full(gps_pad, t), np.zeros((gps_pad, 3)), np.zeros(gps_pad, bool)
            for j, (ft, fp) in enumerate([f for f in fixes if t_prev < f[0] <= t][:gps_pad]):
                gt[j], gp[j], gv[j] = ft, fp, True
            win = win + (gt, gp, gv)
        per = [torch.as_tensor(a, device=gen.device).expand((B,) + a.shape).contiguous()
               for a in win]
        frames.append(dict(t=t, img=img, imu=per[:3], t_new=per[3][:, 0], wheel=per[4:7]))
        if stereo:
            frames[-1]["img_r"] = img_r
        if gps_pad:
            frames[-1]["gps"] = per[7:]
        t_prev = t
    return frames


LOOP_PTS, LOOP_LINES, LOOP_OBS = 96, 16, 8  # closed_loop's point slots, line slots, history


def closed_loop(sim, B: int, n_frames: int, gen: torch.Generator):
    """The 60-frame closed loop of tests/test_fused_frame.py:113-162 for B
    sequences on gen's device: points, lines and wheel (no GPS) from the
    ground-truth seed at t = 1 s, 14 clones, LOOP_PTS point and LOOP_LINES
    line slots of LOOP_OBS observations, float32 camera tensors as in the
    bench, per-sequence pixel noise.
    Returns per sequence (numpy (B,)): the position error after each frame
    `errs` (n_frames, B), its `rmse` and `final`, and the totals
    `accepted`, `lines_accepted` and `wheel_accepted`."""
    from .core import frame
    from .core.layout import StateLayout

    dev = gen.device
    c = sim.cfg
    frames = frame_inputs(sim, B, n_frames, gen, gps_pad=0)
    layout = StateLayout(n_clones=14, n_cams=1, use_wheel=True)
    state = FilterState.from_numpy([seed_state(sim, layout, 1.0)] * B, layout, dev)
    ts = frame.make_track_state(c.height, c.width, LOOP_PTS, LOOP_LINES, LOOP_OBS, batch=B,
                                device=dev)
    gravity = torch.tensor([0.0, 0.0, 9.81], dtype=torch.float64, device=dev)
    sigmas = (c.sigma_w, c.sigma_a, c.sigma_wb, c.sigma_ab)
    wheel_valid = torch.ones(B, dtype=torch.bool, device=dev)
    errs, totals = [], {k: 0 for k in ("accepted", "lines_accepted", "wheel_accepted")}
    for f in frames:
        state, ts, m = frame.fused_frame(
            state, ts, f["img"], *f["imu"], f["t_new"], *f["wheel"], wheel_valid, gravity,
            sigmas, 1.5, 8.0, 2.0, (0.05, 0.05, 0.02), model=0, window_size=1.0,
            cam_dtype=torch.float32, min_track=4)
        p_gt = torch.as_tensor(sim.gt_pose(f["t"])[1], device=dev)
        errs.append(torch.linalg.vector_norm(state.p - p_gt, dim=-1))
        for k in totals:
            totals[k] = totals[k] + m[k]
    errs = torch.stack(errs).cpu().numpy()
    out = {k: v.cpu().numpy() for k, v in totals.items()}
    out.update(errs=errs, rmse=np.sqrt(np.mean(errs**2, axis=0)), final=errs[-1])
    return out


# ---------------------------------------------------------------------------
# the live driver's scenarios (tests/test_feed_image.py, tests/test_gps_fused.py,
# tests/test_dynamic_fused.py, tests/test_stereo_fused.py)
# ---------------------------------------------------------------------------

def live_options(opts, gps: bool = False):
    """Set the options of tests/test_feed_image.py (points, 24 line slots,
    wheel) or, with gps, of tests/test_gps_fused.py (16 line slots, GPS
    sigma 0.3 m, 4-DoF init after 8 m) on an `EstimatorOptions` tree (the
    port's or the JAX package's: the fields are the same).  Returns opts."""
    opts.cam.n_pts = 96
    opts.cam.max_lines = 16 if gps else 24
    opts.cam.use_lines = True
    opts.cam.sigma_pix = 1.5
    opts.cam.sigma_pix_line = 2.5
    opts.cam.chi2_mult = 8.0
    opts.cam.min_track_length = 4
    opts.wheel.enabled = True
    opts.wheel.noise_w = 0.05
    opts.wheel.noise_v = 0.05
    opts.wheel.noise_p = 0.02
    if gps:
        opts.gps.enabled = True
        opts.gps.noise = 0.3
        opts.gps.chi2_mult = 10.0
        opts.gps.init_distance = 8.0
    return opts


def dynamic_options(opts):
    """tests/test_dynamic_fused.py's options: `live_options`' points, lines
    (16 slots) and wheel, with dynamic cloning capped at the 10 Hz camera
    rate.  Returns opts."""
    live_options(opts)
    opts.cam.max_lines = 16
    opts.dynamic_cloning = True
    opts.clone_freq = 10
    return opts


def stereo_options(opts, stereo: bool = True):
    """tests/test_stereo_fused.py's options: `live_options`' points and
    wheel without lines, two cameras (one for its mono run).  Returns
    opts."""
    live_options(opts)
    opts.cam.use_lines = False
    opts.cam.max_n = 2 if stereo else 1
    return opts


def live_calibrate(system, sim, t0: float):
    """Install the simulator's camera (both stereo cameras where the layout
    has two), wheel and (with GPS) antenna calibration into a VioSystem and
    seed it from ground truth at t0, as the live-driver tests do (and, with
    t0 the first IMU sample, run_sim without --images).  Works with the
    port's VioSystem and, without GPS, the JAX package's."""
    c = sim.cfg
    system.set_calibration(np.asarray(c.intrinsics), np.asarray(c.cam_ext_q),
                           np.asarray(c.cam_ext_p))
    if system.layout.n_cams >= 2:
        system.set_calibration(np.asarray(c.intrinsics), np.asarray(c.cam_ext_q),
                               np.asarray(c.cam_ext_p) + [-c.stereo_baseline, 0.0, 0.0], cam=1)
    system.set_wheel_calibration(np.asarray(c.wheel_ext_q), np.asarray(c.wheel_ext_p),
                                 [c.wheel_rl, c.wheel_rr, c.wheel_base])
    if system.gps is not None:
        system.set_gps_calibration(c.gps_ext_p)
    q0, p0 = sim.gt_pose(t0)
    i0 = min(int(np.searchsorted(sim.imu_t, t0)), len(sim.bg_true) - 1)
    system.initialize_from(t0, np.asarray(q0), p0, sim.gt_kin(t0)["v_IinG"],
                           sim.bg_true[i0], sim.ba_true[i0])


def live_events(sim, t0: float, n_frames: int, enu=None, stereo: bool = False):
    """The sensor stream of the live-driver tests' loop, in their order:
    frames at t0 + 0.1 (i + 1); per IMU sample the GPS fixes, wheel samples
    and frames due by then, then the sample itself; it ends with the IMU
    sample that covers the last frame.  With enu = (R, t) the simulator's
    fixes after t0 arrive in an ENU frame p_E = R p + t, all drawn first,
    as tests/test_gps_fused.py draws them; with stereo each frame also
    carries the right camera's image (rendered after the left, as
    tests/test_stereo_fused.py renders them).  Works with the port's
    simulator and the JAX package's.  Returns [(kind, args)] with kind in
    "gps", "wheel", "image", "imu": the arguments of VioSystem.feed_gps_enu,
    feed_wheel, feed_image and feed_imu."""
    imu_t, imu_w, imu_a = sim.imu_stream()
    wheel_ts = sim.wheel_times()
    cam_ts = [t0 + 0.1 * (i + 1) for i in range(n_frames)]
    fixes = []
    if enu is not None:
        R, tr = enu
        fixes = [(float(t), R @ np.asarray(sim.gps_sample(t)) + tr)
                 for t in sim.gps_times() if t > t0]
    events, gi, wi, ci = [], 0, 0, 0
    for i in range(len(imu_t)):
        t = imu_t[i]
        while gi < len(fixes) and fixes[gi][0] <= t:
            events.append(("gps", fixes[gi]))
            gi += 1
        while wi < len(wheel_ts) and wheel_ts[wi] <= t:
            m1, m2 = sim.wheel_sample(wheel_ts[wi])
            events.append(("wheel", (float(wheel_ts[wi]), float(m1), float(m2))))
            wi += 1
        while ci < len(cam_ts) and cam_ts[ci] <= t:
            tc = cam_ts[ci]
            img = (tc, np.asarray(sim.render_frame(tc)))
            events.append(("image", img + ((np.asarray(sim.render_frame(tc, cam=1)),)
                                           if stereo else ())))
            ci += 1
        events.append(("imu", (float(t), imu_w[i], imu_a[i])))
        if ci >= len(cam_ts):
            break
    return events


def attached_points(segs, ids, uvs):
    """Per segment (L,4), the ids of the points (ids (N,), uvs (N,2)) that
    `update.lines.assign_points_to_lines` attaches to it: line_pids for
    `VioSystem.feed_camera`."""
    A = line_up.assign_points_to_lines(
        torch.as_tensor(np.asarray(segs, np.float64).reshape(-1, 4))[None],
        torch.as_tensor(np.asarray(uvs, np.float64).reshape(-1, 2))[None],
        torch.ones((1, len(ids)), dtype=torch.bool))[0].numpy()
    return [[int(i) for i in np.asarray(ids)[row]] for row in A]


def track_events(sim, stereo: bool = False, wheel: bool = False, gps: bool = False,
                 lines: bool = False, plc: bool = False, images: bool = False):
    """The per-track path's sensor stream as run_sim replays it without
    images: the simulator's data association at every camera time (with
    stereo the right camera's after the left's, with lines then the lines'
    (`line_frame`), frame by frame), then the wheel samples, then the GPS
    fixes (world frame = ENU), all drawn in that order after the IMU
    stream, as the JAX driver draws them; then per IMU sample the fixes,
    wheel samples and frames due by then, then the sample itself.  With plc
    each frame's lines also carry their attached points (`attached_points`).
    With images each frame is instead the rendered image (and with stereo
    the right one), with the lines drawn when lines is set, for the host
    trackers (`feed_tracked`), as run_sim --images --host-tracker draws them.
    Works with the port's simulator and the JAX package's.  Returns
    [(kind, args)] with kind in "gps", "wheel", "camera", "stereo", "imu"
    (the arguments of VioSystem.feed_gps_enu, feed_wheel, feed_camera,
    feed_stereo and feed_imu) and "frame" ((t, img) or (t, img, img_r))."""
    imu_t, imu_w, imu_a = sim.imu_stream()

    def frame(t):
        if images:
            return ("frame", (float(t), sim.render_frame(t, with_lines=lines))
                    + ((sim.render_frame(t, with_lines=lines, cam=1),) if stereo else ()))
        out = sim.cam_frame(t, cam=0) + (sim.cam_frame(t, cam=1) if stereo else ())
        if lines:
            lids, segs = sim.line_frame(t)
            out += (lids, segs) + ((attached_points(segs, *out[:2]),) if plc else ())
        return ("stereo" if stereo else "camera", (float(t),) + out)

    cams = [frame(t) for t in sim.cam_times()]
    wheels = ([("wheel", (float(t),) + tuple(sim.wheel_sample(t))) for t in sim.wheel_times()]
              if wheel else [])
    fixes = [("gps", (float(t), sim.gps_sample(t))) for t in sim.gps_times()] if gps else []
    events, idx = [], [0, 0, 0]
    for i in range(len(imu_t)):
        for k, stream in enumerate((fixes, wheels, cams)):
            while idx[k] < len(stream) and stream[idx[k]][1][0] <= imu_t[i]:
                events.append(stream[idx[k]])
                idx[k] += 1
        events.append(("imu", (float(imu_t[i]), imu_w[i], imu_a[i])))
    return events


def joint_update_replay(joint: bool, slam: int = 0, gps: bool = False, feat_rep="GLOBAL_3D",
                        device=CUDA):
    """tests/test_joint_update.py's live replay through the port: 6 s of
    points, lines and wheel (6 lines and 12 MSCKF features an update), with
    `slam` landmark slots in the representation feat_rep and GPS fixes in the
    world frame, one joint update a frame or sequential updates; the
    simulator's draws in that test's order (wheel samples, frames with their
    lines, fixes).  Returns (RMSE of the positions, stats, the VioSystem)."""
    from .config.options import EstimatorOptions
    from .core.system import VioSystem
    from .sim.simulator import SimConfig, Simulator

    sim = Simulator(SimConfig(duration=6.0, seed=4, sigma_pix=0.5, n_pts=24, n_lines=10))
    o = EstimatorOptions()
    o.joint_update, o.clone_freq = joint, 10
    o.cam.n_pts, o.cam.max_msckf, o.cam.sigma_pix = 30, 12, 0.5
    o.cam.min_track_length, o.cam.chi2_mult = 4, 5.0
    o.cam.use_lines, o.cam.max_lines, o.cam.max_slam, o.cam.feat_rep = True, 6, slam, feat_rep
    o.wheel.enabled = True
    if gps:
        o.gps.enabled, o.gps.noise, o.gps.init_distance = True, 0.5, 3.0
    s = VioSystem(o, device=device)
    c = sim.cfg
    s.set_calibration(c.intrinsics, c.cam_ext_q, c.cam_ext_p)
    s.set_wheel_calibration(c.wheel_ext_q, c.wheel_ext_p, [c.wheel_rl, c.wheel_rr, c.wheel_base])
    imu_t, imu_w, imu_a = sim.imu_stream()
    kin0 = sim.gt_kin(imu_t[0])
    q0, p0 = sim.gt_pose(imu_t[0])
    s.initialize_from(float(imu_t[0]), np.asarray(q0), p0, kin0["v_IinG"], sim.bg_true[0],
                      sim.ba_true[0])
    wheel = [(float(t),) + sim.wheel_sample(t) for t in sim.wheel_times()]
    frames = [(float(t),) + sim.cam_frame(t) + sim.line_frame(t) for t in sim.cam_times()]
    fixes = [(float(t), sim.gps_sample(t)) for t in sim.gps_times()] if gps else []
    nxt = [0, 0, 0]
    for i in range(len(imu_t)):
        for k, (items, fn) in enumerate(((wheel, s.feed_wheel), (frames, s.feed_camera),
                                         (fixes, s.feed_gps_enu))):
            while nxt[k] < len(items) and items[nxt[k]][0] <= imu_t[i]:
                fn(*items[nxt[k]])
                nxt[k] += 1
        s.feed_imu(imu_t[i], imu_w[i], imu_a[i])
    errs = [np.linalg.norm(p - sim.gt_kin(t)["p_IinG"]) for t, _, p in s.traj]
    return float(np.sqrt(np.mean(np.square(errs)))), dict(s.stats), s


def feed(system, kind: str, args):
    """Hand one `live_events` or `track_events` event to a VioSystem."""
    {"gps": system.feed_gps_enu, "wheel": system.feed_wheel, "image": system.feed_image,
     "camera": system.feed_camera, "stereo": system.feed_stereo,
     "imu": system.feed_imu}[kind](*args)


def feed_tracked(system, tracker, kind: str, args, line_tracker=None, tag_tracker=None):
    """`feed`, with a "frame" event's images run through a host KLT tracker
    (`update/tracker.py`) into feed_camera (feed_stereo with a right
    image); with a line tracker (`update/line_tracker.py`) the left image's
    lines too, attached to the left points, as run_sim --images
    --host-tracker --lines feeds them; with a tag tracker
    (`update/aruco_tracker.py`, mono only) its corner features after the KLT
    ones, as run_sim --tags feeds them.  With `system.viz` set, the frame's
    tracking overlay (the left pixels, their previous positions, the lines)
    as JAX's run_sim draws it."""
    if kind != "frame":
        return feed(system, kind, args)
    t, *imgs = args
    if system.viz is not None:
        sel = tracker.ids >= 0
        prev_uvs = dict(zip(tracker.ids[sel].tolist(), tracker.uv[sel]))
    out = tracker.feed_stereo(*imgs) if len(imgs) == 2 else tracker.feed(imgs[0])
    if tag_tracker is not None and len(imgs) == 1:
        aids, auvs = tag_tracker.feed(imgs[0])
        if len(aids):
            # the tag corners ride the same feature database in their
            # reserved id block (TrackAruco.cpp:142)
            base = np.atleast_2d(out[1]) if len(out[0]) else np.zeros((0, 2))
            out = (np.concatenate([out[0], aids]), np.concatenate([base, auvs]))
    ids, uvs = out[:2]
    segs = None
    if line_tracker is not None:
        lines = line_tracker.feed(imgs[0], ids, uvs)
        segs = lines[1]
        out += lines
    if system.viz is not None:
        prev = (np.asarray([prev_uvs.get(i, uvs[k]) for k, i in enumerate(ids)])
                if len(ids) else None)
        system.viz.add_overlay(t, np.asarray(imgs[0]), uvs, prev, segs)
    (system.feed_stereo if len(imgs) == 2 else system.feed_camera)(t, *out)


def host_tracker_options(o, stereo: bool = False, n_pts: int = 80, lines: bool = False,
                         wheel: bool = False, plc: bool = False):
    """tests/test_tracker.py::test_image_driven_vio_e2e's filter options (80
    slots, 30 MSCKF features, sigma_pix 1.5, chi2 x 8, tracks of >= 4; with
    stereo run_sim --stereo's two cameras and tracks of >= 6); with lines
    run_sim --images --host-tracker --lines's (20 lines, sigma_pix_line 2.5,
    the point-line-coupled rows with plc); with the wheel run_sim --wheel's
    W3D_ANG rows.  Works on the port's options and the JAX package's.
    Returns o."""
    o.cam.n_pts, o.cam.max_msckf, o.cam.sigma_pix = n_pts, 30, 1.5
    o.cam.min_track_length, o.cam.chi2_mult = 4, 8.0
    if stereo:
        o.cam.max_n, o.cam.min_track_length = 2, 6
    if lines:
        o.cam.use_lines, o.cam.max_lines, o.cam.sigma_pix_line, o.cam.use_plc = True, 20, 2.5, plc
    if wheel:
        w = o.wheel
        w.enabled, w.type, w.chi2_mult = True, "Wheel3DAng", 10.0
        w.noise_w, w.noise_v, w.noise_p = 0.05, 0.05, 0.02
    return o


def host_tracker_system(sim, device=CUDA, stereo: bool = False, n_pts: int = 80,
                        grid=(12, 10), **options):
    """A VioSystem with `host_tracker_options(stereo, n_pts, **options)`,
    seeded from the ground truth at the first IMU sample, and its KLT
    tracker (n_pts slots on a 12 x 10 grid).  Returns (VioSystem,
    KltTracker or StereoKltTracker)."""
    from .config.options import EstimatorOptions
    from .core.system import VioSystem
    from .update.tracker import KltTracker, StereoKltTracker

    s = VioSystem(host_tracker_options(EstimatorOptions(), stereo, n_pts, **options),
                  device=device)
    c = sim.cfg
    live_calibrate(s, sim, float(sim.imu_t[0]))
    tracker = (StereoKltTracker if stereo else KltTracker)(
        n_pts=n_pts, cam_k=np.asarray(c.intrinsics), grid_x=grid[0], grid_y=grid[1],
        device=device)
    return s, tracker


def host_tracker_vio(device=CUDA, stereo: bool = False):
    """tests/test_tracker.py::test_image_driven_vio_e2e through the port:
    8 s, seed 2, 350 landmarks, rendered frames -> the host KLT tracker ->
    the per-track filter (`host_tracker_system`).  Returns (RMSE of the
    positions against the truth, stats, the VioSystem)."""
    from .sim.simulator import SimConfig, Simulator

    sim = Simulator(SimConfig(duration=8.0, seed=2, n_landmarks=350))
    s, tracker = host_tracker_system(sim, device, stereo)
    for kind, args in track_events(sim, stereo=stereo, images=True):
        feed_tracked(s, tracker, kind, args)
    errs = [np.linalg.norm(p - sim.gt_kin(t)["p_IinG"]) for t, _, p in s.traj]
    return float(np.sqrt(np.mean(np.square(errs)))), s.stats, s


def desc_tracker_vio(device=CUDA, frame_hook=None):
    """tests/test_descriptor.py::test_desc_tracker_e2e through the port: 8 s,
    seed 2, 45 landmarks a frame, rendered frames -> `DescTracker` (80
    slots, a 12 x 10 grid) -> the per-track filter (25 MSCKF features,
    sigma_pix 2, chi2 x 8, tracks of >= 4), seeded from the ground truth.
    frame_hook(tracker), when given, runs after each frame's tracking.
    Returns (RMSE of the positions, stats, the VioSystem, the tracker)."""
    from .config.options import EstimatorOptions
    from .core.system import VioSystem
    from .sim.simulator import SimConfig, Simulator
    from .update.desc_tracker import DescTracker

    sim = Simulator(SimConfig(duration=8.0, seed=2, n_pts=45))
    o = EstimatorOptions()
    o.cam.max_msckf, o.cam.sigma_pix, o.cam.min_track_length, o.cam.chi2_mult = 25, 2.0, 4, 8.0
    s = VioSystem(o, device=device)
    c = sim.cfg
    s.set_calibration(c.intrinsics, c.cam_ext_q, c.cam_ext_p)
    imu_t, imu_w, imu_a = sim.imu_stream()
    kin0 = sim.gt_kin(imu_t[0])
    q0, _ = sim.gt_pose(imu_t[0])
    s.initialize_from(float(imu_t[0]), np.asarray(q0), kin0["p_IinG"], kin0["v_IinG"],
                      sim.bg_true[0], sim.ba_true[0])
    tracker = DescTracker(n_pts=80, cam_k=np.asarray(c.intrinsics), grid_x=12, grid_y=10,
                          device=device)
    frames = [(float(t), sim.render_frame(t, with_lines=False)) for t in sim.cam_times()]
    k = 0
    for i in range(len(imu_t)):
        while k < len(frames) and frames[k][0] <= imu_t[i]:
            s.feed_camera(frames[k][0], *tracker.feed(frames[k][1]))
            if frame_hook is not None:
                frame_hook(tracker)
            k += 1
        s.feed_imu(imu_t[i], imu_w[i], imu_a[i])
    errs = [np.linalg.norm(p - sim.gt_kin(t)["p_IinG"]) for t, _, p in s.traj]
    return float(np.sqrt(np.mean(np.square(errs)))), dict(s.stats), s, tracker
