"""Profile the batch-first fused step, or the images-in frame, on one CUDA card.

    python -m plviwo_tpu_torch.profile_step [--batch 128] [--steps 5]
    python -m plviwo_tpu_torch.profile_step --frame [--batch 64] [--steps 5]

The filter step runs at the filter bench's width (22 clones, 40 point
tracks x 20 obs, 16 line tracks, 32 IMU / 32 wheel samples); `--frame` runs
`core.frame.fused_frame` at the images-in width (640 x 480, 128 slots x 8
obs, 14 clones with wheel, the port's simulator, after 6 warm-up frames).
It prints:
  - host syncs that torch reports during one step (sync debug mode);
  - the wall time of a step, and its device time from CUDA events;
  - a per-stage breakdown: each stage, called in the same order, timed
    alone (synchronized before and after);
  - the profiler's top device kernels by time, and the device's busy
    share over the profiled steps (summed kernel time / wall time).
"""

from __future__ import annotations

import argparse
import time
import warnings

import torch


def _inputs(B, dev):
    from .examples import batch_args, example_inputs_full

    args = example_inputs_full(n_clones=22, F=40, O=20, imu_n=32, L=16, n_wheel=32)
    b = batch_args(args, B, dev)
    return b[0], b[1:17], b[17:21]


def _stage_times(state, per_frame, consts):
    """Device-synchronized wall time of each stage of fused_step_full."""
    from .core import ekf, propagator, step
    from .core.state import newest_clone_slot
    from .examples import SIGMA_LINE, WHEEL_NOISE
    from .update.wheel import W3D_ANG

    (imu_t, imu_w, imu_a, t_new, ouv, ouvn, oslot, ovalid,
     luv, luvn, lslot, lvalid, wt, wm1, wm2, wvalid) = per_frame
    gravity, sigmas, sigma_pix, chi2_mult = consts
    f32 = torch.float32
    out = {}
    timed = _timer(out)

    state = timed("propagate", lambda: propagator.propagate(
        state, imu_t, imu_w, imu_a, t_new, gravity, sigmas))

    def clone(state):
        state = step._auto_marginalize(state, state.time, 1.0)
        s0 = newest_clone_slot(state)
        state = ekf.augment_clone(state)
        return state, s0, newest_clone_slot(state)

    state, slot0, slot1 = timed("marginalize+clone", lambda: clone(state))
    G1, c1, _ = timed("point rows (incl. kernel)", lambda: step._camera_msckf_rows(
        state, ouv, ouvn, oslot, ovalid, sigma_pix, chi2_mult, 0, f32))
    G2, c2, _ = timed("line rows (incl. kernel)", lambda: step._line_msckf_rows(
        state, luv, luvn, lslot, lvalid, SIGMA_LINE, chi2_mult, f32))

    def wheel():
        Hw, rw, mw, _ = step._wheel_rows(state, slot0, slot1, wt, wm1, wm2, wvalid,
                                         WHEEL_NOISE, chi2_mult, W3D_ANG, f32)
        return step._rows_to_gram(Hw, rw, mw)

    Gw, cw = timed("wheel rows", wheel)

    def joint():
        Hj, rj, mj = ekf.compress_from_gram(G1 + G2 + Gw, c1 + c2 + cw)
        return ekf.update(state, Hj, rj, torch.ones_like(rj), mj)

    timed("compress+update", joint)
    return out


def _timer(out):
    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t0) * 1e3
        return res
    return timed


FRAME_KW = dict(model=0, window_size=1.0, cam_dtype=torch.float32, min_track=4,
                use_lines=False)
FRAME_CONSTS = (1.5, 8.0, 2.0, (0.05, 0.05, 0.02))  # sigma_pix, chi2_mult, sigma_line, wheel noise


def _frame_setup(B, n_frames, dev):
    """Simulator frames and a GT-seeded (state, track state) at the
    images-in width."""
    from .core import frame
    from .core.layout import StateLayout
    from .core.state import FilterState
    from .examples import frame_inputs, seed_state
    from .sim.simulator import SimConfig, Simulator

    sim = Simulator(SimConfig(duration=6.0, n_landmarks=350, n_lines=40, seed=3))
    frames = frame_inputs(sim, B, n_frames, torch.Generator(device=dev).manual_seed(7))
    layout = StateLayout(n_clones=14, n_cams=1, use_wheel=True)
    state = FilterState.from_numpy([seed_state(sim, layout, 1.0)] * B, layout, dev)
    ts = frame.make_track_state(480, 640, n_pts=128, max_obs=8, batch=B, device=dev)
    c = sim.cfg
    consts = (torch.tensor([0.0, 0.0, 9.81], dtype=torch.float64, device=dev),
              (c.sigma_w, c.sigma_a, c.sigma_wb, c.sigma_ab)) + FRAME_CONSTS
    return frames, state, ts, consts


def _frame_args(f, consts):
    B = f["img"].shape[0]
    return (f["img"], *f["imu"], f["t_new"], *f["wheel"],
            torch.ones(B, dtype=torch.bool, device=f["img"].device), *consts)


def _frame_stage_times(state, ts, f, consts):
    """Device-synchronized wall time of each stage of fused_frame; the
    front-end stages are timed alone and then `track_frame` whole."""
    from .core import ekf, frame, propagator, step
    from .core.state import newest_clone_slot
    from .ops import cam, image, klt, lk_kernel
    from .update.wheel import W3D_ANG

    out = {}
    timed = _timer(out)
    gravity, sigmas, sigma_pix, chi2_mult, _, wheel_noise = consts
    f32, N = torch.float32, ts.uv.shape[1]
    state = timed("propagate", lambda: propagator.propagate(
        state, *f["imu"], f["t_new"], gravity, sigmas))

    def clone(state):
        state = step._auto_marginalize(state, f["t_new"], 1.0)
        s0 = newest_clone_slot(state)
        state = ekf.augment_clone(state)
        return state, s0, newest_clone_slot(state)

    state, slot0, slot1 = timed("marginalize+clone", lambda: clone(state))
    pyr = timed("equalize+pyramid", lambda: image.build_pyramid(
        image.hist_equalize_quantile(f["img"]), 3))
    uv, ok = timed("LK (kernel)", lambda: lk_kernel.pyramidal_lk(
        (ts.pyr0, ts.pyr1, ts.pyr2), pyr, ts.uv, ts.valid & ts.has_prev[:, None], 3, 7, 6))
    kb = state.cam_k[:, :1]
    timed("undistort+RANSAC", lambda: klt.ransac_fundamental(
        *cam.undistort(torch.cat([ts.uv, uv], 1).double(), kb, 0).split(N, dim=1), ok, ts.key,
        ts.counter))
    timed("detect_grid", lambda: klt.detect_grid(pyr[0], uv, ok, 16, 12, N, min_px_dist=10.0))
    ts, harvest = timed("track_frame (all front-end)", lambda: frame.track_frame(
        ts, f["img"], state.cam_k[:, 0], f["t_new"], slot1))
    p_uv, p_uvn, p_slot, p_mask, p_t = harvest
    p_mask = frame._liveness(state, p_slot, p_t, p_mask)
    p_mask = p_mask & (torch.sum(p_mask, dim=-1, keepdim=True) >= 3)
    G1, c1, _ = timed("point rows (incl. kernel)", lambda: step._camera_msckf_rows(
        state, p_uv, p_uvn, p_slot, p_mask, sigma_pix, chi2_mult, 0, f32))

    def wheel():
        Hw, rw, mw, _ = step._wheel_rows(state, slot0, slot1, *f["wheel"],
                                         torch.ones_like(f["t_new"], dtype=torch.bool),
                                         wheel_noise, chi2_mult, W3D_ANG, f32)
        return step._rows_to_gram(Hw, rw, mw)

    Gw, cw = timed("wheel rows", wheel)

    def joint():
        Hj, rj, mj = ekf.compress_from_gram(G1 + Gw, c1 + cw)
        return ekf.update(state, Hj, rj, torch.ones_like(rj), mj)

    timed("compress+update", joint)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frame", action="store_true", help="profile the images-in frame")
    ap.add_argument("--batch", type=int, default=None, help="sequences (128; 64 with --frame)")
    ap.add_argument("--steps", type=int, default=5)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: needs a CUDA card")
    from .core.frame import fused_frame
    from .core.step import fused_step_full
    from .examples import SIGMA_LINE, WHEEL_NOISE

    dev = torch.device("cuda", 0)
    if a.frame:
        B = a.batch or 64
        n_warm = 6
        frames, state, ts, consts = _frame_setup(B, n_warm + 3 * a.steps + 2, dev)
        it = iter(frames)

        def step(s):
            st, tr = s
            f = next(it)
            return fused_frame(st, tr, *_frame_args(f, consts), **FRAME_KW)[:2]

        s = (state, ts)
        for _ in range(n_warm):
            s = step(s)

        def stages(s):
            return _frame_stage_times(s[0], s[1], next(it), consts)
    else:
        B = a.batch or 128
        state, per_frame, consts = _inputs(B, dev)

        def step(s):
            return fused_step_full(s, *per_frame, *consts, SIGMA_LINE, WHEEL_NOISE,
                                   cam_dtype=torch.float32)[0]

        def stages(s):
            return _stage_times(s, per_frame, consts)

        s = step(step(state))
    torch.cuda.synchronize()

    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        s = step(s)
        torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("default")
    msgs = sorted({str(w.message).splitlines()[0] for w in caught})
    print(f"host syncs in one step: {len(caught)}")
    for m in msgs:
        print("  sync:", m)

    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    e0.record()
    for _ in range(a.steps):
        s = step(s)
    e1.record()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / a.steps * 1e3
    print(f"step: wall {wall:.3f} ms, events {e0.elapsed_time(e1) / a.steps:.3f} ms "
          f"(B={B}, {B / wall * 1e3:.1f} frames/s)")

    for name, ms in stages(s).items():
        print(f"stage {name}: {ms:.3f} ms")

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(a.steps):
            s = step(s)
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t0
    # device-side entries only (kernels, memcpy, memset): the host operators
    # that launch them report the same time again
    kern = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]

    def dev_self(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)

    busy_us = sum(dev_self(e) for e in kern)
    n_ops = sum(e.count for e in kern)
    print(f"profiled {a.steps} steps: wall {pwall * 1e3:.3f} ms, device busy "
          f"{busy_us / 1e3:.3f} ms ({100 * busy_us / 1e6 / pwall:.1f}%), "
          f"{n_ops / a.steps:.0f} device ops per step")
    for e in sorted(kern, key=dev_self, reverse=True)[:20]:
        print(f"  {dev_self(e) / 1e3 / a.steps:9.3f} ms/step  x{e.count // a.steps:<5d} {e.key[:90]}")
    host = [e for e in prof.key_averages() if e.device_type == DeviceType.CPU]
    print(f"host operators: {sum(e.count for e in host) / a.steps:.0f} per step; top by self time:")
    for e in sorted(host, key=lambda e: e.self_cpu_time_total, reverse=True)[:15]:
        print(f"  {e.self_cpu_time_total / 1e3 / a.steps:9.3f} ms/step  x{e.count // a.steps:<5d} "
              f"{e.key[:90]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
