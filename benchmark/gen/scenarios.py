"""Traffic of the benchmark's cells, made from a seed and a traffic file's parameters.

Everything here is numpy on the host, or torch on the device for the fleet's frames, and
imports nothing of the system under test.  The simulator (`gen/simulator.py`,
`gen/bspline.py`) is a frozen copy of the port's, so that a later change to the port's
simulator leaves the yardstick as it is.

- `sub_seeds`: independent 32-bit seeds from any whole-number seed.
- `seed_state`: the filter state seeded from ground truth, as numpy arrays.
- `fleet_episode`: one episode of images-in frames for B sequences that share one rendered
  scene, each with its own pixel noise, on the device.
- `live_events`: one vehicle's images-in sensor stream (images, IMU, wheel, GPS in an ENU
  frame), in the order a live driver receives it.
- `track_events`: one vehicle's per-track stream (the simulator's data association, and
  GPS fixes in an ENU frame).
"""

from __future__ import annotations

import numpy as np
import torch

from ..reference.plv.core.layout import StateLayout
from ..reference.plv.core.state import make_state
from .simulator import SimConfig, Simulator, _rot

IMU_PAD = 32
WHEEL_PAD = 16


def sub_seeds(seed: int, n: int) -> list[int]:
    """n independent 32-bit seeds drawn from `seed` (any whole number)."""
    return [int(s) for s in np.random.SeedSequence(abs(int(seed))).generate_state(n)]


def simulator(sim: dict, seed: int) -> Simulator:
    """A simulator from a traffic file's `sim` block (SimConfig's fields) and a seed."""
    return Simulator(SimConfig(**dict(sim, seed=int(seed))))


def seed_state(sim: Simulator, layout: StateLayout, t0: float) -> dict:
    """The filter state at t0 seeded from ground truth (the initializer's state), as numpy
    arrays of one sequence: camera 0 and the wheel at the simulator's calibration, the
    GPS antenna's lever arm where the layout has a GPS block."""
    c = sim.cfg
    st = make_state(layout, priors={"imu_th": 1e-3, "imu_p": 1e-5, "imu_v": 1e-2,
                                    "imu_bg": 1e-3, "imu_ba": 1e-2}, device="cpu").to_numpy()
    q, p = sim.gt_pose(t0)
    v = sim.gt_kin(t0)["v_IinG"]
    i0 = min(int(np.searchsorted(sim.imu_t, t0)), len(sim.bg_true) - 1)
    bg, ba = sim.bg_true[i0], sim.ba_true[i0]
    st.update(time=np.array(t0, dtype=np.float64), q=q, p=p, v=v, bg=bg, ba=ba,
              q_fej=q.copy(), p_fej=p.copy(), v_fej=v.copy(), bg_fej=bg.copy(),
              ba_fej=ba.copy(), wheel_q=np.asarray(c.wheel_ext_q, dtype=np.float64),
              wheel_p=np.asarray(c.wheel_ext_p, dtype=np.float64),
              wheel_k=np.array([c.wheel_rl, c.wheel_rr, c.wheel_base]))
    st["cam_k"][0] = c.intrinsics
    st["cam_q"][0] = c.cam_ext_q
    st["cam_p"][0] = c.cam_ext_p
    if layout.n_gps > 0:
        st["gps_p"][0] = c.gps_ext_p
    return st


def wheel_samples(sim: Simulator, ts) -> np.ndarray:
    """(len(ts), 2) noisy wheel rates at the times ts: the simulator's `wheel_sample`
    for a whole array of times, its noise drawn in one block."""
    c = sim.cfg
    ts = np.asarray(ts, dtype=np.float64)
    kin = sim.spline.kin(ts)
    R_ItoO = _rot(c.wheel_ext_q)
    p_OinI = -R_ItoO.T @ np.asarray(c.wheel_ext_p)
    w_I = kin["w_IinI"]
    v_I = np.einsum("nij,nj->ni", kin["R_GtoI"], kin["v_IinG"]) + np.cross(w_I, p_OinI)
    vx, wz = v_I @ R_ItoO.T[:, 0], w_I @ R_ItoO.T[:, 2]
    psi = np.stack([(vx - wz * c.wheel_base / 2.0) / c.wheel_rl,
                    (vx + wz * c.wheel_base / 2.0) / c.wheel_rr], axis=1)
    return psi + sim.rng.normal(0, c.sigma_wheel, psi.shape)


def imu_window(imu_t, imu_w, imu_a, t_prev, t_new, pad=IMU_PAD):
    """Padded IMU stack covering (t_prev, t_new] with one boundary sample on each side:
    (t (pad,), w (pad,3), a (pad,3))."""
    i0 = max(int(np.searchsorted(imu_t, t_prev)) - 1, 0)
    i1 = min(int(np.searchsorted(imu_t, t_new)) + 1, len(imu_t))
    t, w, a = imu_t[i0:i1][:pad], imu_w[i0:i1][:pad], imu_a[i0:i1][:pad]
    n = len(t)
    return (np.concatenate([t, np.full(pad - n, t[-1])]),
            np.concatenate([w, np.tile(w[-1], (pad - n, 1))]),
            np.concatenate([a, np.tile(a[-1], (pad - n, 1))]))


def fleet_episode(sim: Simulator, B: int, n_frames: int, t0: float, dt: float,
                  gen: torch.Generator, noise: float, gps_pad: int):
    """One episode of `fused_frame` inputs for B sequences on gen's device: per frame a
    dict with `t`, `img` (B,H,W) float32 (the one rendered frame with each sequence's
    own Gaussian pixel noise of std `noise`, clamped to [0, 1]), `imu` (t, w, a (B,32,·)),
    `t_new` (B,), `wheel` (t, m1, m2 (B,16): WHEEL_PAD // 2 samples over the frame's
    interval, padded with the last) and, with gps_pad, `gps` (t (B,gps_pad), p, valid):
    the fixes in (t_prev, t], padded with the frame time.  IMU, wheel and GPS data are
    shared by the sequences.  The images are rendered on the host and made noisy on the
    device, one frame at a time."""
    dev = gen.device
    imu = sim.imu_stream()
    fixes = [(float(t), sim.gps_sample(t)) for t in sim.gps_times()] if gps_pad else []
    frames, t_prev = [], t0
    for i in range(n_frames):
        t = t0 + dt * (i + 1)
        clean = torch.as_tensor(sim.render_frame(t), device=dev)
        img = torch.randn((B,) + tuple(clean.shape), generator=gen, device=dev).mul_(noise)
        img = img.add_(clean).clamp_(0.0, 1.0)
        wt = np.linspace(t_prev, t, WHEEL_PAD // 2)
        m = wheel_samples(sim, wt)
        rep = WHEEL_PAD - len(wt)
        wheel = (np.concatenate([wt, np.full(rep, wt[-1])]),
                 np.concatenate([m[:, 0], np.full(rep, m[-1, 0])]),
                 np.concatenate([m[:, 1], np.full(rep, m[-1, 1])]))
        win = imu_window(*imu, t_prev, t) + (np.full(1, t),) + wheel
        if gps_pad:
            gt, gp, gv = np.full(gps_pad, t), np.zeros((gps_pad, 3)), np.zeros(gps_pad, bool)
            for j, (ft, fp) in enumerate([f for f in fixes if t_prev < f[0] <= t][:gps_pad]):
                gt[j], gp[j], gv[j] = ft, fp, True
            win = win + (gt, gp, gv)
        per = [torch.as_tensor(a, device=dev).expand((B,) + a.shape).contiguous() for a in win]
        f = dict(t=t, img=img, imu=per[:3], t_new=per[3][:, 0], wheel=per[4:7])
        if gps_pad:
            f["gps"] = per[7:]
        frames.append(f)
        t_prev = t
    return frames


def enu_frame(yaw: float, offset) -> tuple[np.ndarray, np.ndarray]:
    """(R, t) of an ENU frame yawed by `yaw` and offset by `offset` from the world."""
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]]), np.asarray(offset, float)


def live_events(sim: Simulator, t0: float, n_frames: int, enu=None):
    """One vehicle's images-in stream in a live driver's order: frames at t0 + 0.1 (i + 1);
    per IMU sample the GPS fixes (with enu = (R, t), the simulator's fixes after t0 in the
    frame p_E = R p + t, drawn first), wheel samples and frames due by then, then the
    sample itself; it ends with the IMU sample that covers the last frame.  Returns
    [(kind, args)], kind in "gps", "wheel", "image", "imu": the arguments of a driver's
    feed_gps_enu, feed_wheel, feed_image and feed_imu."""
    imu_t, imu_w, imu_a = sim.imu_stream()
    wheel_ts = sim.wheel_times()
    cam_ts = [t0 + 0.1 * (i + 1) for i in range(n_frames)]
    fixes = []
    if enu is not None:
        R, tr = enu
        fixes = [(float(t), R @ np.asarray(sim.gps_sample(t)) + tr)
                 for t in sim.gps_times() if t > t0]
    images = {tc: np.asarray(sim.render_frame(tc)) for tc in cam_ts}
    wheel = wheel_samples(sim, wheel_ts)
    events, gi, wi, ci = [], 0, 0, 0
    for i in range(len(imu_t)):
        t = imu_t[i]
        while gi < len(fixes) and fixes[gi][0] <= t:
            events.append(("gps", fixes[gi]))
            gi += 1
        while wi < len(wheel_ts) and wheel_ts[wi] <= t:
            events.append(("wheel", (float(wheel_ts[wi]), float(wheel[wi, 0]),
                                     float(wheel[wi, 1]))))
            wi += 1
        while ci < len(cam_ts) and cam_ts[ci] <= t:
            events.append(("image", (cam_ts[ci], images[cam_ts[ci]])))
            ci += 1
        events.append(("imu", (float(t), imu_w[i], imu_a[i])))
        if ci >= len(cam_ts):
            break
    return events


def track_events(sim: Simulator, lines: bool = True, wheel: bool = True, enu=None):
    """One vehicle's per-track stream: the simulator's data association at every camera
    time (and its lines), then the wheel samples, then with enu = (R, t) the GPS fixes
    in the frame p_E = R p + t, all drawn in that order after the IMU stream; then per
    IMU sample the wheel samples, frames and fixes due by then, then the sample itself.
    Returns [(kind, args)], kind in "wheel", "camera", "gps", "imu": the arguments of a
    driver's feed_wheel, feed_camera, feed_gps_enu and feed_imu."""
    imu_t, imu_w, imu_a = sim.imu_stream()
    cams = []
    for t in sim.cam_times():
        out = sim.cam_frame(t)
        if lines:
            out += sim.line_frame(t)
        cams.append(("camera", (float(t),) + out))
    wheels = []
    if wheel:
        wt = sim.wheel_times()
        m = wheel_samples(sim, wt)
        wheels = [("wheel", (float(t), float(a), float(b))) for t, (a, b) in zip(wt, m)]
    fixes = []
    if enu is not None:
        R, tr = enu
        fixes = [("gps", (float(t), R @ np.asarray(sim.gps_sample(t)) + tr))
                 for t in sim.gps_times() if t > imu_t[0]]
    events, idx = [], [0, 0, 0]
    for i in range(len(imu_t)):
        for k, stream in enumerate((wheels, cams, fixes)):
            while idx[k] < len(stream) and stream[idx[k]][1][0] <= imu_t[i]:
                events.append(stream[idx[k]])
                idx[k] += 1
        events.append(("imu", (float(imu_t[i]), imu_w[i], imu_a[i])))
    return events


def calibrate(system, sim: Simulator, t0: float):
    """Install the simulator's camera, wheel and (where the driver has GPS) antenna
    calibration into a driver, and seed it from ground truth at t0."""
    c = sim.cfg
    system.set_calibration(np.asarray(c.intrinsics), np.asarray(c.cam_ext_q),
                           np.asarray(c.cam_ext_p))
    system.set_wheel_calibration(np.asarray(c.wheel_ext_q), np.asarray(c.wheel_ext_p),
                                 [c.wheel_rl, c.wheel_rr, c.wheel_base])
    if system.gps is not None:
        system.set_gps_calibration(c.gps_ext_p)
    q0, p0 = sim.gt_pose(t0)
    i0 = min(int(np.searchsorted(sim.imu_t, t0)), len(sim.bg_true) - 1)
    system.initialize_from(t0, np.asarray(q0), p0, sim.gt_kin(t0)["v_IinG"], sim.bg_true[i0],
                           sim.ba_true[i0])
