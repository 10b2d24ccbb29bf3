"""Scaling measurement of the sharded batched step (port of
plviwo_tpu/parallel/scaling.py; BASELINE config 5 harness).

Throughput of `replay.sharded_step_fn` at B = ranks * b_per_dev against 1
rank: efficiency = throughput_N / (N * throughput_1).  `--sweep` adds the
decomposition of JAX's round-4 sweep: at each N the same total batch also
runs unsharded in one process (no process group, no collectives), and
comm_factor = fps_solo / fps_sharded isolates the cost of sharding from
the capacity of what the ranks run on.

What this measures depends on where the ranks run (`shared_note`): ranks
that share one card (Gloo, as on a one-card host) or the host's CPU cores
measure the cost of sharding, not scaling across cards; only one card per
rank (NCCL) measures scaling.

Run: python -m plviwo_tpu_torch.parallel.scaling [--ranks 4] [--b-per-dev 4]
     [--sweep] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

F64 = torch.float64


def _inputs(B, n_clones, F, O, imu_n, device):
    """JAX's measurement inputs: B copies of a fresh state, quiet IMU
    windows, random observations that are all invalid (the step's cost
    without accepted rows)."""
    from ..core.layout import StateLayout
    from ..core.state import make_state

    layout = StateLayout(n_clones=n_clones, n_cams=1)
    state = make_state(layout, priors={"imu_th": 1e-3, "imu_p": 1e-6, "imu_v": 1e-2,
                                       "imu_bg": 1e-2, "imu_ba": 1e-2},
                       batch=B, device=device)
    state.time.zero_()
    state.cam_k[:, 0] = torch.tensor([300.0, 300.0, 320.0, 240.0, 0, 0, 0, 0], dtype=F64)
    rng = np.random.default_rng(0)
    imu_t = np.tile(np.arange(imu_n) * 0.005, (B, 1))
    arrays = (imu_t, 0.01 * rng.normal(size=(B, imu_n, 3)),
              np.array([0.0, 0.0, 9.81]) + 0.01 * rng.normal(size=(B, imu_n, 3)),
              np.full(B, imu_t[0, -1]), rng.uniform(100, 500, size=(B, F, O, 2)),
              rng.uniform(-0.3, 0.3, size=(B, F, O, 2)))
    per_seq = [torch.as_tensor(a, dtype=F64, device=device) for a in arrays]
    per_seq += [torch.as_tensor(rng.integers(0, n_clones, size=(B, F, O)), device=device),
                torch.zeros((B, F, O), dtype=torch.bool, device=device)]
    rest = (torch.tensor([0.0, 0.0, 9.81], dtype=F64, device=device),
            (1.7e-4, 2.0e-3, 1.9e-5, 3.0e-3), 1.0, 1.0)
    return state, per_seq, rest


def _rate(step, state, per_seq, rest, B, n_iter, device):
    """Sequences x steps per second over n_iter chained steps after one
    warm-up step (synchronized)."""
    out, _ = step(state, *per_seq, *rest)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(n_iter):
        out, _ = step(out, *per_seq, *rest)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return B * n_iter / (time.perf_counter() - t0)


def measure_rank(b_per_dev=4, n_iter=10, n_clones=12, F=16, O=8, imu_n=16, *, group):
    """This rank's part of `measure`: the whole batch's inputs, its shard
    stepped n_iter times after a barrier.  Returns (B x n_iter / this rank's
    wall time, backend)."""
    import torch.distributed as dist

    from .replay import sharded_step_fn

    B = group.world * b_per_dev
    state, per_seq, rest = _inputs(B, n_clones, F, O, imu_n, group.device)
    dist.barrier()
    return _rate(sharded_step_fn(group), state, per_seq, rest, B, n_iter, group.device), \
        group.backend


def measure(ranks: int, b_per_dev: int = 4, n_iter: int = 10, n_clones: int = 12, F: int = 16,
            O: int = 8, imu_n: int = 16, solo: bool = False, device="cuda"):
    """Throughput (sequences x steps / s) of the sharded batched step at
    B = ranks * b_per_dev: the slowest rank's, since the batch's step ends
    with it.  With `solo=True` the same total batch runs unsharded in this
    process (no process group, no collectives): the comm-separation control
    of the weak-scaling sweep.  Returns (fps, backend; "none" for solo)."""
    from ..core.state import checked_device
    from .replay import CAM_DTYPE, batched_step, run_ranks

    kw = dict(b_per_dev=b_per_dev, n_iter=n_iter, n_clones=n_clones, F=F, O=O, imu_n=imu_n)
    if not solo:
        res = run_ranks(measure_rank, ranks, kwargs=kw, device=device)
        return min(r[0] for r in res), res[0][1]
    dev = checked_device(device)
    B = ranks * b_per_dev
    state, per_seq, rest = _inputs(B, n_clones, F, O, imu_n, dev)

    def step(st, *args):
        return batched_step(st, *args, cam_dtype=CAM_DTYPE)

    return _rate(step, state, per_seq, rest, B, n_iter, dev), "none"


def weak_row(n: int, b_per_dev: int, fps: float, fps_solo: float, fps1: float,
             backend: str) -> dict:
    """JAX's weak-scaling row at n ranks: per-rank work constant, so perfect
    is fps(n) = n fps(1); comm_factor is the sharding cost at equal work on
    the same silicon."""
    return {"devices": n, "batch": n * b_per_dev, "backend": backend, "fps_sharded": fps,
            "fps_solo_same_batch": fps_solo, "weak_efficiency": fps / (n * fps1),
            "comm_factor": fps_solo / max(fps, 1e-9)}


def shared_note(device, ranks: int) -> str:
    """What the readings at up to `ranks` ranks on `device` measure."""
    if torch.device(device).type == "cpu":
        return (f"CPU ranks share the host's {os.cpu_count()} cores: the readings measure the "
                "cost of sharding, not scaling across devices")
    cards = torch.cuda.device_count()
    if ranks > cards:
        return (f"ranks share {cards} card(s) over Gloo: the readings measure the cost of "
                "sharding, not scaling across cards")
    return "one card per rank (NCCL): the readings measure scaling across cards"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=1)
    ap.add_argument("--b-per-dev", type=int, default=4)
    ap.add_argument("--n-iter", type=int, default=10)
    ap.add_argument("--sweep", action="store_true",
                    help="weak-scaling sweep over 1/2/4/.../N ranks with an unsharded "
                         "same-batch control per point")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    n, b, kw = args.ranks, args.b_per_dev, dict(n_iter=args.n_iter, device=args.device)
    if args.sweep:
        rows, fps1, N = [], None, 1
        while N <= n:
            fpsN, backend = measure(N, b, **kw)
            fps1 = fps1 or fpsN
            rows.append(weak_row(N, b, fpsN, measure(N, b, solo=True, **kw)[0], fps1, backend))
            N *= 2
        print(json.dumps({
            "mode": "weak", "b_per_dev": b, "physical_cores": os.cpu_count(),
            "device": args.device, "rows": rows,
            "note": ("weak_efficiency = fps(N) / (N fps(1)) with constant per-rank work; "
                     "comm_factor = fps_solo / fps_sharded at the same total batch: ~1.0 means "
                     "a weak-efficiency loss is capacity, not collectives; "
                     + shared_note(args.device, n)),
        }))
        return 0
    fps1, backend1 = measure(1, b, **kw)
    fpsN, backend = measure(n, b, **kw)
    print(json.dumps({
        "devices": n, "fps_1dev": fps1, "fps_ndev": fpsN,
        "scaling_efficiency": fpsN / (n * fps1), "backend": backend,
        "backend_1dev": backend1, "device": args.device, "note": shared_note(args.device, n),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
