"""Driver of a per-track vehicle cell: `VioSystem.feed_camera` + `feed_imu` +
`feed_wheel` + `feed_gps_enu` at B = 1, tracked ids and pixels in, poses out.

Set-up draws `vehicles` vehicles from the seed (each its own simulated scene and noise
along the configuration's drive, seeded from ground truth at its first IMU sample) and
warms a driver up on the first.  The window replays the vehicles in turn, each from a
fresh driver, in a closed loop.  Afterwards one vehicle drawn from the seed, among those
whose replay the window finished, is replayed from its start by the reference driver,
and every pose the program recorded on its last replay is compared.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..gen import scenarios
from ..program import apply_options
from ..reference import checks
from ..reference.plv.config import options as ref_options
from ..reference.plv.core import system as ref_system
from ._vehicle import FEED, Loop, gps_initialized, window


def round_state_f32(system):
    """The f32_state control: the driver's filter state rounded to float32 (mean and
    covariance) after a frame, as a filter that keeps its state in float32 would."""
    s = system.state
    system.state = s.replace(**{n: getattr(s, n).to(torch.float32).to(torch.float64)
                                for n in checks.ref_state.FIELDS
                                if getattr(s, n).dtype == torch.float64})


def run(ctx):
    P, w, cfg, dev = ctx.program, ctx.workload, ctx.config, ctx.device
    seeds = scenarios.sub_seeds(ctx.seed, int(w["vehicles"]) + 1)
    sims = [scenarios.simulator(cfg["sim"], s) for s in seeds[1:]]
    opts = cfg["options"]
    enu = (scenarios.enu_frame(w["gps_enu"]["yaw"], w["gps_enu"]["offset"])
           if opts.get("gps.enabled", False) else None)
    streams = [scenarios.track_events(sim, lines=opts.get("cam.use_lines", False),
                                      wheel=opts.get("wheel.enabled", False), enu=enu)
               for sim in sims]

    def new_system(mod, opts_mod, v, **extra):
        def make():
            s = mod.VioSystem(apply_options(opts_mod.EstimatorOptions(), dict(opts, **extra)),
                              device=dev)
            scenarios.calibrate(s, sims[v], float(sims[v].imu_t[0]))
            return s
        return make

    episodes = [(streams[v], new_system(P.system, P.options, v)) for v in range(len(sims))]
    after = round_state_f32 if P.control == "f32_state" else None
    ctx.say(f"set-up: {len(sims)} vehicles drawn in {time.time() - ctx.t_start:.3f} s from the "
            "process's start")
    # the warm-up driver reaches its GPS initialization within a few frames, so that
    # the frames before it, the initialization and the frames that fuse fixes all run
    warm = Loop([(streams[0], new_system(P.system, P.options, 0, **{
        "gps.init_distance": w["warm_gps_init_distance"]}))], after_frame=after)
    warm.frames_until(int(w["warm_frames"]))
    ctx.say(f"set-up: warmed up at {time.time() - ctx.t_start:.3f} s (GPS initialized: "
            f"{gps_initialized(warm.system)})")
    del warm
    done, enu_on = {}, {}

    def ended(k, s):
        done[k] = list(s.traj)
        enu_on[k] = gps_initialized(s)
    loop = Loop(episodes, after_frame=after, on_episode_end=ended)
    rec = {}
    window(ctx, loop, rec, checked=lambda: bool(done))
    del loop
    rng = np.random.default_rng(seeds[0])
    finished = sorted(done)
    limits = w["limits"]
    if not finished:
        ctx.say("no vehicle's replay finished in the window")
        rec["checks"] = {k: (float("inf"), lim) for k, lim in limits.items()}
        return rec
    v = finished[int(rng.integers(len(finished)))]
    ref = new_system(ref_system, ref_options, v)()
    for kind, args in streams[v]:
        getattr(ref, FEED[kind])(*args)
    gaps = checks.pose_gaps(done[v], ref.traj)

    def truth(t):
        p = sims[v].gt_kin(t)["p_IinG"]
        return enu[0] @ p + enu[1] if enu_on[v] else p
    ctx.say(f"accuracy: vehicle {v}'s position RMSE against the truth "
            f"{checks.position_rmse(done[v], truth):.4f} m (GPS initialized: {enu_on[v]})")
    ctx.say(f"vehicle {v}: {len(done[v])} poses against the reference's {len(ref.traj)}: "
            + ", ".join(f"{k} {x!r}" for k, x in gaps.items()))
    ctx.numbers.update(gaps)
    rec["checks"] = {k: (gaps[k], lim) for k, lim in limits.items()}
    return rec
