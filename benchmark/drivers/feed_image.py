"""Driver of an images-in vehicle cell: `VioSystem.feed_image` + `feed_imu` + `feed_wheel`
+ `feed_gps_enu` at B = 1, pixels in, poses out.

Set-up renders one episode from the seed (GPS fixes in a yawed, offset ENU frame, which
the driver's 4-DoF initialization finds once the vehicle has travelled the configured
distance) and warms a driver up on it.  The window replays the episode back to back,
each time from a fresh driver seeded from ground truth, in a closed loop.  The driver module's name for the frame, `system.fused_frame`, is bound to
a wrapper that keeps the inputs and outputs (references, no copy) of a few frames of the
episode drawn from the seed, and of whatever kernel calls they make through their
entries; after the window the reference runs each of them from the same inputs and
pre-frame state, and each kernel call's plain version from its arguments.  Beside it:
the start (the program's seeded driver state against the reference driver's).
"""

from __future__ import annotations

import time

import numpy as np

from .. import trace as tr
from ..gen import scenarios
from ..program import apply_options
from ..reference import checks
from ..reference.plv.config import options as ref_options
from ..reference.plv.core import system as ref_system
from ._vehicle import Loop, gps_initialized, window


def run(ctx):
    P, w, cfg, dev = ctx.program, ctx.workload, ctx.config, ctx.device
    n_ep = int(w["episode_frames"])
    s_sim, s_check = scenarios.sub_seeds(ctx.seed, 2)
    sim = scenarios.simulator(dict(cfg["sim"], duration=w["sim_duration"]), s_sim)
    enu = scenarios.enu_frame(w["gps_enu"]["yaw"], w["gps_enu"]["offset"])
    events = scenarios.live_events(sim, w["t0"], n_ep, enu)
    rng = np.random.default_rng(s_check)
    check_at = sorted(int(i) for i in rng.choice(np.arange(1, n_ep), int(w["check_frames"]),
                                                 replace=False))

    def new_system(mod, opts_mod, **extra):
        s = mod.VioSystem(apply_options(opts_mod.EstimatorOptions(), dict(cfg["options"], **extra)),
                          device=dev)
        scenarios.calibrate(s, sim, w["t0"])
        return s

    kept, count, starts = {}, [0], []
    frame_fn = P.system.fused_frame

    def keep(*args, **kw):
        i = count[0]
        count[0] += 1
        if i not in check_at:
            return frame_fn(*args, **kw)
        tap = {}
        with tr.kernel_calls(P, tap):
            out = frame_fn(*args, **kw)
        kept[i] = [args, kw, out, None, tap]
        return out

    def fresh(**extra):
        count[0] = 0
        s = new_system(P.system, P.options, **extra)
        starts.append(s.state)
        return s

    def recorded(s):
        # the pose the driver recorded after a kept frame, as the call returned
        i = count[0] - 1
        if i in kept and kept[i][3] is None:
            kept[i][3] = s.traj[-1]

    P.system.fused_frame = keep
    try:
        last = {}
        ctx.say(f"set-up: episode of {n_ep} frames made in {time.time() - ctx.t_start:.3f} s "
                "from the process's start")
        # the warm-up driver reaches its GPS initialization within a few frames, so that
        # the frames before it, the initialization and the frames that fuse fixes all run
        warm = Loop([(events, lambda: fresh(**{"gps.init_distance": w["warm_gps_init_distance"]}))])
        warm.frames_until(int(w["warm_frames"]))
        ctx.say(f"set-up: warmed up at {time.time() - ctx.t_start:.3f} s (GPS initialized: "
                f"{gps_initialized(warm.system)})")
        del warm
        loop = Loop([(events, fresh)], after_frame=recorded,
                    on_episode_end=lambda k, s: last.update(traj=list(s.traj),
                                                            enu=gps_initialized(s)))
        kept.clear()
        starts[:] = starts[-1:]
        rec = {}
        window(ctx, loop, rec, checked=lambda: len(kept) == len(check_at))
    finally:
        P.system.fused_frame = frame_fn
    R, t_enu = enu
    if last:
        def truth(t):
            p = sim.gt_kin(t)["p_IinG"]
            return R @ p + t_enu if last["enu"] else p
        ctx.say(f"accuracy: the last finished episode's position RMSE over its last 30 frames "
                f"{checks.position_rmse(last['traj'][-30:], truth):.4f} m (GPS initialized: "
                f"{last['enu']}); D = {loop.system.layout.dim}")
    del loop
    rec["checks"] = check(ctx, kept, starts[0], new_system(ref_system, ref_options).state)
    return rec


def check(ctx, kept, start, ref_start):
    """The numbers compared, each with its limit: the start, and the kept frames' gaps to
    the reference (`checks.aggregate`); every frame kept has to have run.  Beside them,
    printed: each kept frame's recorded pose against its output (`record_gap`; a GPS
    initialization later in the same call moves the whole trajectory)."""
    per = []
    for i in sorted(kept):
        args, kw, prog, pose, tap = kept[i]
        gaps = checks.frame_gaps(prog, checks.ref_fused_frame(args, kw))
        gaps.update(checks.call_gaps(tap))
        st = prog[0]
        gaps["record_gap"] = (float("inf") if pose is None else max(
            float(np.abs(pose[2] - st.p[0].cpu().numpy()).max()),
            float(np.abs(pose[1] - st.q[0].cpu().numpy()).max())))
        ctx.say(f"frame {i} of the episode against the reference: "
                + ", ".join(f"{k} {v!r}" for k, v in gaps.items()))
        per.append(gaps)
    numbers = checks.aggregate(per)
    numbers["start_gap"] = checks.state_gap(start, ref_start)
    if len(kept) < int(ctx.workload["check_frames"]):
        ctx.say(f"only {len(kept)} of the frames to check ran")
        numbers = {"start_gap": numbers["start_gap"]}
    ctx.numbers.update(numbers)
    return checks.compared(numbers, ctx.workload["limits"], ctx.say)
