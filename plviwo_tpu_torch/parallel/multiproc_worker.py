"""One rank of a multi-process sharded step (port of
plviwo_tpu/parallel/multiproc_worker.py).

Each process is one rank of a torch.distributed process group (backend by
`replay.backend_for`), runs its shard of the batched full PL-VIWO step
(points + lines + wheel) on `examples.example_inputs_full` at B = world,
one sequence per rank, and the metric reduction rides a real cross-process
all_reduce.  It then runs its own shard alone (B = 1, no collective) and
compares the two.

Usage (one process per rank, all with the same rendezvous):
    python -m plviwo_tpu_torch.parallel.multiproc_worker <rank> <world> <init> [--device cpu]
with <init> a `file://` path or `tcp://127.0.0.1:<free port>`.

Prints one JSON line: {"pid" (the rank), "global_devices" (the world size),
"accepted", "rows" (whole-batch sums), "shard_equal" (the shard equals its
one-process run bit for bit), "max_abs_dp", "backend", "device"}; exits 0
iff rows were accepted and |dp| < 1e-9.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch
import torch.distributed as dist


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("rank", type=int)
    ap.add_argument("world", type=int)
    ap.add_argument("init", help="rendezvous: file://<path> or tcp://127.0.0.1:<port>")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cpu":
        torch.set_num_threads(1)

    from ..examples import SIGMA_LINE, WHEEL_NOISE, batch_args, example_inputs_full
    from .replay import (CAM_DTYPE, batched_full_step, init_rank_group, shard_slice,
                         sharded_full_step_fn, take_shard)

    group = init_rank_group(args.rank, args.world, args.init, args.device)
    try:
        B = group.world  # one sequence per rank
        full = batch_args(example_inputs_full(device="cpu"), B, device=group.device) + (
            SIGMA_LINE, WHEEL_NOISE)
        new, agg = sharded_full_step_fn(group, model=0, window_size=1.0)(*full)
        agg = {k: v.item() for k, v in agg.items()}
        # this rank's shard alone, with no collective
        sl = shard_slice(group, B)
        local = [take_shard(group, a, sl) for a in full[:17]]
        ref, _ = batched_full_step(*local, *full[17:], model=0, window_size=1.0,
                                   cam_dtype=CAM_DTYPE)
        dp = float(torch.max(torch.abs(new.p - ref.p)))
        equal = bool(torch.equal(new.p, ref.p))
    finally:
        dist.destroy_process_group()
    print(json.dumps({
        "pid": group.rank, "global_devices": group.world,
        "accepted": agg["accepted"], "rows": agg["rows"], "shard_equal": equal,
        "max_abs_dp": dp, "backend": group.backend, "device": str(group.device),
    }), flush=True)
    return 0 if agg["accepted"] > 0 and dp < 1e-9 else 1


if __name__ == "__main__":
    sys.exit(main())
