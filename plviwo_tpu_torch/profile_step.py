"""Profile the batch-first fused step, or the images-in frame, on one CUDA card.

    python -m plviwo_tpu_torch.profile_step [--batch 128] [--steps 5]
    python -m plviwo_tpu_torch.profile_step --frame [--stereo | --dynamic] [--batch 64] [--steps 5]

The filter step runs at the filter bench's width (22 clones, 40 point
tracks x 20 obs, 16 line tracks, 32 IMU / 32 wheel samples); `--frame` runs
`core.frame.fused_frame` as bench.py's images-in unit (640 x 480, 128
point slots x 8 obs, 24 line slots, 14 clones with wheel and one GPS block,
up to 4 GPS fixes a frame, the port's simulator, after 6 warm-up frames);
with `--stereo` a right image per sequence and two cameras (the L->R LK
pass in the front-end, the stereo point rows in the rows), with
`--dynamic` sequence b cloning on frames where (frame + b) is even (the
masked clone in the time update, the interpolated point rows in the
rows).  It prints:
  - host syncs that torch reports during one step (sync debug mode);
  - the wall time of a step, and its device time from CUDA events;
  - a per-stage breakdown: for the filter step each stage, called in the
    same order, timed alone (synchronized before and after); for the
    frame the stage spans of one profiled frame (`utils.timing.span`),
    each with its device time (CUDA events on the stream: its kernels
    and the gaps the host leaves between them), its share of the frame's
    and its host time;
  - the profiler's top device kernels by time, and the device's busy
    share over the profiled steps (summed kernel time / wall time).
"""

from __future__ import annotations

import argparse
import time
import warnings

import torch

from .sim.simulator import SimConfig


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
                use_gps=True, sigma_gps=SimConfig.sigma_gps, gps_chi2_mult=8.0)
FRAME_CONSTS = (1.5, 8.0, 2.0, (0.05, 0.05, 0.02))  # sigma_pix, chi2_mult, sigma_line, wheel noise


def _frame_setup(B, n_frames, dev, mode=None):
    """Simulator frames and a GT-seeded (state, track state) of bench.py's
    images-in unit; mode "stereo" adds right images and a second camera,
    "dynamic" each frame's per-sequence `do_clone`."""
    from .core import frame
    from .core.layout import StateLayout
    from .core.state import FilterState
    from .examples import frame_inputs, seed_state
    from .sim.simulator import Simulator

    sim = Simulator(SimConfig(duration=6.0, n_landmarks=350, n_lines=40, seed=3))
    frames = frame_inputs(sim, B, n_frames, torch.Generator(device=dev).manual_seed(7),
                          stereo=mode == "stereo")
    for i, f in enumerate(frames):
        f["do_clone"] = (torch.arange(B, device=dev) + i) % 2 == 0
    layout = StateLayout(n_clones=14, n_cams=1 + (mode == "stereo"), use_wheel=True, n_gps=1)
    state = FilterState.from_numpy([seed_state(sim, layout, 1.0)] * B, layout, dev)
    ts = frame.make_track_state(480, 640, 128, 24, 8, batch=B, device=dev)
    c = sim.cfg
    consts = (torch.tensor([0.0, 0.0, 9.81], dtype=torch.float64, device=dev),
              (c.sigma_w, c.sigma_a, c.sigma_wb, c.sigma_ab)) + FRAME_CONSTS
    return frames, state, ts, consts


def _frame_args(f, consts, mode=None):
    """(positional arguments, keyword arguments: GPS and mode) of one frame."""
    B = f["img"].shape[0]
    kw = dict(zip(("gps_t", "gps_p", "gps_valid"), f["gps"]))
    if mode == "stereo":
        kw.update(use_stereo=True, img_r=f["img_r"])
    elif mode == "dynamic":
        kw.update(use_dynamic=True, do_clone=f["do_clone"])
    return (f["img"], *f["imu"], f["t_new"], *f["wheel"],
            torch.ones(B, dtype=torch.bool, device=f["img"].device), *consts), kw


def _frame_spans(step, s):
    """One frame under the profiler; returns (state after it, its stage
    spans with their depth: [(span, depth)] in order of entry)."""
    from torch.profiler import ProfilerActivity, profile

    from .utils import timing

    timing.spans(clear=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        s = step(s)
        torch.cuda.synchronize()
    records = timing.spans(clear=True)
    depth = {}
    for r in records:
        depth[r.id] = 0 if r.parent is None else depth[r.parent] + 1
    return s, [(r, depth[r.id]) for r in records]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frame", action="store_true", help="profile the images-in frame")
    ap.add_argument("--batch", type=int, default=None, help="sequences (128; 64 with --frame)")
    ap.add_argument("--steps", type=int, default=5)
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--stereo", action="store_true",
                      help="with --frame: a right image per sequence, two cameras")
    mode.add_argument("--dynamic", action="store_true",
                      help="with --frame: dynamic cloning, sequence b cloning where "
                           "(frame + b) is even")
    a = ap.parse_args(argv)
    mode = "stereo" if a.stereo else "dynamic" if a.dynamic else None
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: needs a CUDA card")
    from .core.frame import fused_frame
    from .core.step import fused_step_full
    from .examples import SIGMA_LINE, WHEEL_NOISE

    dev = torch.device("cuda", 0)
    if a.frame:
        B = a.batch or 64
        n_warm = 6
        frames, state, ts, consts = _frame_setup(B, n_warm + 2 * a.steps + 2, dev, mode)
        it = iter(frames)

        def step(s):
            args, kw = _frame_args(next(it), consts, mode)
            return fused_frame(*s, *args, **kw, **FRAME_KW)[:2]

        s = (state, ts)
        for _ in range(n_warm):
            s = step(s)
    else:
        B = a.batch or 128
        state, per_frame, consts = _inputs(B, dev)

        def step(s):
            return fused_step_full(s, *per_frame, *consts, SIGMA_LINE, WHEEL_NOISE,
                                   cam_dtype=torch.float32)[0]

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

    if a.frame:
        s, records = _frame_spans(step, s)
        frame_ms = records[0][0].device_ms
        for r, depth in records:
            host = (r.t1_ns - r.t0_ns) / 1e6
            print(f"stage {'  ' * depth}{r.name}: device {r.device_ms:.3f} ms "
                  f"({100 * r.device_ms / frame_ms:.1f}% of the frame), host {host:.3f} ms")
    else:
        for name, ms in _stage_times(s, per_frame, consts).items():
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
    # that launch them report the same time again, and the stage spans'
    # ranges, which the trace also lays on the device timeline, span them
    notes = {e.name for e in prof.events() if getattr(e, "is_user_annotation", False)}
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.key not in notes]

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
