"""Profile the batch-first fused step on one CUDA card.

    python -m plviwo_tpu_torch.profile_step [--batch 128] [--steps 5]

At the filter bench's width (22 clones, 40 point tracks x 20 obs, 16 line
tracks, 32 IMU / 32 wheel samples) it prints:
  - host syncs that torch reports during one step (sync debug mode);
  - the wall time of a step, and its device time from CUDA events;
  - a per-stage breakdown: each stage of `fused_step_full`, called in the
    same order, timed alone (synchronized before and after);
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

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t0) * 1e3
        return res

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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--steps", type=int, default=5)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: needs a CUDA card")
    from .core.step import fused_step_full
    from .examples import SIGMA_LINE, WHEEL_NOISE

    dev = torch.device("cuda", 0)
    state, per_frame, consts = _inputs(a.batch, dev)

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
          f"(B={a.batch}, {a.batch / wall * 1e3:.1f} frames/s)")

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
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
