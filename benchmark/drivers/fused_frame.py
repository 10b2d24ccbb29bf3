"""Driver of a fleet cell: `core/frame.fused_frame` at batch B, pixels in, state out.

Set-up renders one episode of frames from the seed (one scene shared by the B sequences,
each with its own pixel noise) and keeps it on the device, builds the ground-truth seeded
start, and warms the frame up.  The window replays the episode back to back, every
episode from the seeded start, as a fleet replay starts its next batch: each frame batch
is launched as soon as the last one is handed in, and the window closes once the device
has finished the last batch launched.  The frames of a few positions in the episode,
drawn from the seed, keep their inputs and outputs, and those of their kernel calls
(references, no copy); afterwards the reference runs each from the same inputs and
pre-frame state, and each kernel call's plain version from the same arguments.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..gen import scenarios
from ..reference import checks
from .. import trace as tr
from ..run import CACHE


def frame_call(cfg, sim, state, ts, f, wheel_valid, gravity):
    """(args, kwargs) of one `fused_frame` call at the configuration's widths."""
    fr = cfg["frame"]
    c = sim.cfg
    kw = dict(model=0, window_size=fr["window_size"], cam_dtype=getattr(torch, fr["cam_dtype"]),
              min_track=fr["min_track"], grid_x=fr["grid"][0], grid_y=fr["grid"][1],
              use_lines=fr["use_lines"], use_gps=fr["use_gps"])
    if fr["use_gps"]:
        kw.update(gps_t=f["gps"][0], gps_p=f["gps"][1], gps_valid=f["gps"][2],
                  sigma_gps=c.sigma_gps, gps_chi2_mult=fr["gps_chi2_mult"])
    args = (state, ts, f["img"], *f["imu"], f["t_new"], *f["wheel"], wheel_valid, gravity,
            (c.sigma_w, c.sigma_a, c.sigma_wb, c.sigma_ab), fr["sigma_pix"], fr["chi2_mult"],
            fr["sigma_line"], tuple(fr["wheel_noise"]))
    return args, kw


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run(ctx):
    P, w, cfg, dev = ctx.program, ctx.workload, ctx.config, ctx.device
    fr = cfg["frame"]
    B, n_ep = int(w["batch"]), int(w["episode_frames"])
    s_sim, s_noise, s_check = scenarios.sub_seeds(ctx.seed, 3)
    sim = scenarios.simulator(dict(cfg["sim"], duration=w["sim_duration"]), s_sim)
    gen = torch.Generator(device=dev).manual_seed(s_noise)
    frames = scenarios.fleet_episode(sim, B, n_ep, w["t0"], 1.0 / cfg["sim"]["cam_hz"], gen,
                                     w["pixel_noise"], fr["gps_pad"] if fr["use_gps"] else 0)
    lay = dict(n_clones=fr["n_clones"], n_cams=1, use_wheel=True, n_gps=int(fr["use_gps"]))
    seed_arrays = [scenarios.seed_state(sim, checks.ref_layout.StateLayout(**lay), w["t0"])] * B
    state0 = P.state.FilterState.from_numpy(seed_arrays, P.layout.StateLayout(**lay), dev)
    ts0 = P.frame.make_track_state(sim.cfg.height, sim.cfg.width, fr["n_pts"], fr["max_lines"],
                                   fr["max_obs"], 0, batch=B, device=dev)
    gravity = torch.tensor([0.0, 0.0, 9.81], dtype=torch.float64, device=dev)
    wheel_valid = torch.ones(B, dtype=torch.bool, device=dev)
    ctx.say(f"set-up: episode of {n_ep} frames made in {time.time() - ctx.t_start:.3f} s "
            "from the process's start")
    rng = np.random.default_rng(s_check)
    check_at = sorted(int(i) for i in rng.choice(np.arange(1, n_ep), int(w["check_frames"]),
                                                 replace=False))
    kept = {}
    frame_fn = P.frame.fused_frame

    def one(state, ts, i):
        args, kw = frame_call(cfg, sim, state, ts, frames[i], wheel_valid, gravity)
        if i not in check_at:
            return frame_fn(*args, **kw)
        tap = {}
        with tr.kernel_calls(P, tap):
            out = frame_fn(*args, **kw)
        kept[i] = (args, kw, out, tap)
        return out

    state, ts = state0, ts0
    for i in range(int(w["warm_frames"])):
        state, ts, _ = one(state, ts, i)
    sync(dev)
    ctx.say(f"set-up: warmed up at {time.time() - ctx.t_start:.3f} s")
    kept.clear()
    rec = {}

    def batches(n, pos):
        """n frame batches from episode position pos; returns the next position."""
        nonlocal state, ts
        for _ in range(n):
            if pos == 0:
                state, ts = state0, ts0
            state, ts, _ = one(state, ts, pos)
            pos = (pos + 1) % n_ep
        return pos

    ctx.setup_done()
    t0 = time.perf_counter()
    pos, n_batches = batches(1, 0), 1
    if ctx.trace:
        # the traced stretch and the count start at a steady position of the episode,
        # where the clone window and the tracks have filled since the restart
        first, k, n = int(w["trace_from"]), int(w["trace_frames"]), int(w["count_frames"])
        ahead = (first - pos) % n_ep
        pos, n_batches = batches(ahead, pos), n_batches + ahead
        calls = {}
        with tr.kernel_calls(P, calls):
            rec["profile"] = tr.profile(lambda: batches(k, pos), CACHE / "trace" / "fleet.json")
        rec["kernel_calls"] = calls
        pos, n_batches = (pos + k) % n_ep, n_batches + k
        box = {}
        rec["host_ops"] = tr.count_ops(lambda: box.update(pos=batches(n, pos)))
        rec["host_ops_frames"] = n
        ctx.say(f"traced: episode positions {first}-{first + k - 1} profiled, "
                f"{first + k}-{first + k + n - 1} counted")
        pos, n_batches = box["pos"], n_batches + n
    while time.perf_counter() - t0 < ctx.seconds:
        pos, n_batches = batches(1, pos), n_batches + 1
    sync(dev)
    rec["window_s"] = time.perf_counter() - t0
    rec["frames"] = n_batches * B
    rec["attempted"] = rec["completed"] = n_batches * B
    # after the window, until every position to check has run once (a traced window, or
    # a window shorter than an episode, may not have reached them all): one episode at most
    for _ in range(n_ep):
        if len(kept) == len(check_at):
            break
        pos = batches(1, pos)
    rec["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                                if torch.device(dev).type == "cuda" else 0)
    ctx.say(f"{ctx.cell}: {n_batches} frame batches of B = {B} in {rec['window_s']:.3f} s, "
            f"D = {state.cov.shape[-1]}, episode {n_ep} frames, program {P.name}")
    t_last = frames[(pos - 1) % n_ep]["t"]
    err = torch.linalg.vector_norm(state.p.cpu() - torch.as_tensor(sim.gt_pose(t_last)[1]), dim=-1)
    ctx.say(f"accuracy: |p - p_true| at t = {t_last:.1f} s over the {B} sequences: largest "
            f"{float(err.max()):.4f} m, mean {float(err.mean()):.4f} m")
    # the window has closed: free the program's run, then the reference
    del frames, state, ts
    rec["checks"] = check(ctx, kept, state0, seed_arrays, lay)
    return rec


def check(ctx, kept, state0, seed_arrays, lay):
    """The numbers compared, each with its limit: the start, and the kept frames' gaps to
    the reference (`checks.aggregate`); every frame kept has to have run."""
    per = []
    for i in sorted(kept):
        args, kw, prog, tap = kept[i]
        gaps = checks.frame_gaps(prog, checks.ref_fused_frame(args, kw))
        gaps.update(checks.call_gaps(tap))
        ctx.say(f"frame {i} of the episode against the reference: "
                + ", ".join(f"{k} {v!r}" for k, v in gaps.items()))
        per.append(gaps)
    numbers = checks.aggregate(per)
    numbers["start_gap"] = checks.start_gap(state0, seed_arrays, lay, ctx.device)
    if len(kept) < int(ctx.workload["check_frames"]):
        ctx.say(f"only {len(kept)} of the frames to check ran")
        numbers = {"start_gap": numbers["start_gap"]}
    ctx.numbers.update(numbers)
    return checks.compared(numbers, ctx.workload["limits"], ctx.say)
