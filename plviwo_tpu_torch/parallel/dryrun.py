"""The multichip dry run on torch.distributed (the port's analogue of
`__graft_entry__.dryrun_multichip` and `_dryrun_fused_frame`).

With `world` ranks (`replay.run_ranks`): a batch of B = world independent
sequence filters, sharded one sequence per rank, runs

  1. one full step (points + lines + wheel) on `examples.example_inputs_full`
     with real measurement rows: the metric sums over the ranks must show
     accepted points, rows, lines and wheel updates, and the gathered p and
     cov must be within 1e-9 of one process running the same batch;
  2. one images-in frame (`core.frame.fused_frame`, points + lines + wheel)
     at JAX's dry-run settings (320 x 240, SimConfig(duration=3,
     n_landmarks=200, n_lines=24, seed=2), 8 clones, 32 point and 8 line
     slots x 4 obs, grid 8 x 6, from the ground-truth state at 1 s): tracked
     > 0 and p within 1e-9 of one process.  The port's line detector has
     fixed anchors and steps (192, 96; JAX's dry run passes 64 and 48).

Each rank reports its gate/Gram, LK and line run-length launches in its
sharded step and frame (2 gate/Gram in the step; 1 LK, 2 gate/Gram and 1
line run-length in the frame), and whether the sharded result equals the
one-process run bit for bit.

Run: python -m plviwo_tpu_torch.parallel.dryrun [--world 2] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from .replay import (CAM_DTYPE, batched_full_step, gather_rows, gather_states, kernel_launches,
                     reduce_metrics, run_ranks, shard_slice, sharded_full_step_fn, step_no_lone,
                     take_shard, zero_launches)

F64 = torch.float64
TOL = 1e-9


def _max_abs(a, b) -> float:
    return float(torch.max(torch.abs(a - b)))


def dryrun_step(*, group) -> dict:
    """Part 1 on this rank; rank 0 also runs the one-process reference."""
    from ..examples import SIGMA_LINE, WHEEL_NOISE, batch_args, example_inputs_full

    B = group.world
    full = batch_args(example_inputs_full(device="cpu"), B, device=group.device) + (
        SIGMA_LINE, WHEEL_NOISE)
    zero_launches()
    new, agg = sharded_full_step_fn(group, model=0, window_size=1.0)(*full)
    launches = kernel_launches()
    whole = gather_states(group, new)
    agg = {k: v.item() for k, v in agg.items()}
    if not bool(torch.isfinite(whole.p).all()):
        raise AssertionError("sharded step: p is not finite")
    for k in ("accepted", "rows", "lines_accepted", "wheel_accepted"):
        if agg[k] <= 0:
            raise AssertionError(f"sharded step: no {k} (agg={agg})")
    out = {"rank": group.rank, "backend": group.backend, "device": str(group.device),
           "agg": agg, "launches": launches}
    if group.rank == 0:
        ref, _ = batched_full_step(*full, model=0, window_size=1.0, cam_dtype=CAM_DTYPE)
        dp, dcov = _max_abs(whole.p, ref.p), _max_abs(whole.cov, ref.cov)
        if not (dp < TOL and dcov < TOL):
            raise AssertionError(f"sharded != one process: |dp|={dp:.3e} |dcov|={dcov:.3e}")
        out.update(dp=dp, dcov=dcov, bitwise=bool(torch.equal(whole.p, ref.p)
                                                  and torch.equal(whole.cov, ref.cov)))
    return out


def _frame_batch(B: int, device, t: float = 1.0):
    """The dry-run frame's whole batch on `device`: (state, track state,
    frame arguments, the arguments after them, keyword arguments), every
    sequence the same: the ground-truth state at t and the frame at
    t + 0.1 s (the dry run's: t = 1)."""
    from ..core.frame import make_track_state
    from ..core.layout import StateLayout
    from ..core.state import FilterState
    from ..sim.simulator import SimConfig, Simulator
    from .batch_replay import seed_state

    W, H = 320, 240
    cfg = SimConfig(duration=3.0, n_landmarks=200, n_lines=24, width=W, height=H, seed=2)
    sim = Simulator(cfg)
    layout = StateLayout(n_clones=8, n_cams=1, use_wheel=True)
    state = FilterState.from_numpy([seed_state(sim, layout, t)] * B, layout, device)
    ts = make_track_state(H, W, n_pts=32, max_lines=8, max_obs=4, batch=B, device=device)
    imu_t, imu_w, imu_a = sim.imu_stream()
    i0 = max(int(np.searchsorted(imu_t, t)) - 1, 0)
    sel = slice(i0, i0 + 24)

    def rep(x, dtype=F64):
        t = torch.as_tensor(np.asarray(x)).to(device, dtype)
        return t.expand((B,) + t.shape).contiguous()

    wm = np.full(8, 0.5)
    t1 = t + 0.1
    args = (rep(sim.render_frame(t1), torch.float32), rep(imu_t[sel]), rep(imu_w[sel]),
            rep(imu_a[sel]), rep(t1), rep(np.linspace(t, t1, 8)), rep(wm), rep(wm),
            rep(True, torch.bool))
    rest = (torch.tensor([0.0, 0.0, 9.81], dtype=F64, device=device),
            (cfg.sigma_w, cfg.sigma_a, cfg.sigma_wb, cfg.sigma_ab), 1.5, 8.0, 2.0,
            (0.05, 0.05, 0.02))
    kw = dict(model=0, window_size=1.0, cam_dtype=torch.float32, min_track=3, grid_x=8,
              grid_y=6)
    return state, ts, args, rest, kw


def dryrun_fused_frame(*, group) -> dict:
    """Part 2 on this rank; rank 0 also runs the one-process reference."""
    from ..core.frame import fused_frame

    state, ts, args, rest, kw = _frame_batch(group.world, group.device)
    sl = shard_slice(group, group.world)
    shard = [take_shard(group, x, sl) for x in (state, ts) + args]
    zero_launches()
    st2, _, m = step_no_lone(fused_frame, len(shard), *shard, *rest, **kw)
    launches = kernel_launches()
    agg = {k: v.item() for k, v in reduce_metrics(group, m).items()}
    p = gather_rows(group, st2.p)
    if not bool(torch.isfinite(p).all()):
        raise AssertionError("sharded frame: p is not finite")
    if agg["tracked"] <= 0:
        raise AssertionError("sharded frame tracked nothing")
    out = {"rank": group.rank, "backend": group.backend, "device": str(group.device),
           "tracked": agg["tracked"], "launches": launches}
    if group.rank == 0:
        ref, _, _ = fused_frame(state, ts, *args, *rest, **kw)
        dp = _max_abs(p, ref.p)
        if not dp < TOL:
            raise AssertionError(f"sharded frame != one process: |dp|={dp:.3e}")
        out.update(dp=dp, bitwise=bool(torch.equal(p, ref.p)))
    return out


def dryrun_rank(*, group) -> dict:
    """Both parts on this rank."""
    return {"step": dryrun_step(group=group), "frame": dryrun_fused_frame(group=group)}


def dryrun_multichip(world: int, device="cuda") -> list:
    """Both parts on `world` ranks; prints JAX's two lines (with the backend)
    and returns every rank's results."""
    res = run_ranks(dryrun_rank, world, device=device)
    s, f = res[0]["step"], res[0]["frame"]
    a = s["agg"]
    print(f"dryrun_multichip({world}): ok, agg={{accepted: {a['accepted']}, rows: "
          f"{a['rows']}, lines: {a['lines_accepted']}, wheel: {a['wheel_accepted']}}}, "
          f"equivalence |dp|={s['dp']:.2e} |dcov|={s['dcov']:.2e} (bitwise {s['bitwise']}); "
          f"backend {s['backend']} on {s['device']}")
    print(f"dryrun_fused_frame({world}): ok, tracked={f['tracked']}, |dp|={f['dp']:.2e} "
          f"(bitwise {f['bitwise']}); backend {f['backend']}")
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description="sharded step and frame against one process")
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    res = dryrun_multichip(args.world, args.device)
    print(json.dumps({"launches_per_rank": [{k: r[k]["launches"] for k in ("step", "frame")}
                                            for r in res]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
