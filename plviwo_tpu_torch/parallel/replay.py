"""Sequence-sharded batch replay over torch.distributed (port of
plviwo_tpu/parallel/replay.py).

JAX lays the sequence axis of `fused_step` over a device mesh and lets a
`jnp.sum` over the sharded axis reduce the metrics.  Here the ranks of a
process group stand in for the mesh, one process per rank: rank r owns the
r-th contiguous shard of the B axis, runs the step on its own device, and
the metric sums go through `dist.all_reduce`.  The per-sequence filters are
independent, so the step itself exchanges nothing.

Backend rule (`backend_for`): NCCL when every rank has a card of its own
(CUDA ranks, no more ranks than cards on the host); Gloo when ranks share a
card (NCCL refuses two ranks on one device) or run on the CPU.  Gloo takes
CUDA tensors for all_reduce, all_gather (list form) and broadcast.  No
error is caught to switch backends.

`run_ranks` starts the ranks and runs one module-level function in each.
Importing this module starts no process group and no process.
"""

from __future__ import annotations

import dataclasses
import datetime
import multiprocessing
import queue
import tempfile
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

from ..core.state import FIELDS, FilterState, checked_device
from ..core.step import fused_step, fused_step_full

F64 = torch.float64
# The camera tensors' dtype on this layer's paths: the gate/Gram kernel's.
# (JAX's parallel layer runs its float64 rows through XLA, outside any
# pallas_call; the port's CUDA tensors always launch the kernel.)
CAM_DTYPE = torch.float32

# The unit of work.  The JAX package vmaps fused_step / fused_step_full
# over the sequence axis; the port's steps are batch-first already.
batched_step = fused_step
batched_full_step = fused_step_full


@dataclasses.dataclass(frozen=True)
class RankGroup:
    """This process's place in the default process group (the port's
    stand-in for JAX's device mesh over the sequence axis)."""
    rank: int
    world: int
    device: torch.device
    backend: str


def backend_for(device_type: str, world: int, n_cards: int) -> str:
    """NCCL when every rank has a card of its own, Gloo when ranks share a
    card or run on the CPU."""
    return "nccl" if device_type == "cuda" and world <= n_cards else "gloo"


def init_rank_group(rank: int, world: int, init_method: str, device="cuda",
                    timeout: float = 120.0) -> RankGroup:
    """Join the default process group as `rank` of `world`.

    init_method: a `file://` path or `tcp://127.0.0.1:<free port>`.  A CUDA
    rank works on card `rank % device_count`.  `timeout` (seconds) bounds
    the rendezvous and every collective, so a dead rank fails its peers
    instead of hanging them."""
    dev = checked_device(device)
    n_cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % n_cards)
        torch.cuda.set_device(dev)
    backend = backend_for(dev.type, world, n_cards)
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout))
    return RankGroup(rank, world, dev, backend)


def shard_slice(group: RankGroup, B: int) -> slice:
    """This rank's contiguous shard of a B axis; B must divide by the world
    size (as JAX's sharding of the sequence axis requires)."""
    if B % group.world:
        raise ValueError(f"a batch of {B} sequences does not divide over {group.world} ranks")
    n = B // group.world
    return slice(group.rank * n, (group.rank + 1) * n)


def _map(x, fn):
    """fn applied to every tensor in x: a tensor, a dataclass of tensors
    (FilterState, TrackState) or a dict, tuple or list of them; other values
    are kept."""
    if torch.is_tensor(x):
        return fn(x)
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{f.name: fn(getattr(x, f.name))
                                         for f in dataclasses.fields(x)
                                         if torch.is_tensor(getattr(x, f.name))})
    if isinstance(x, dict):
        return {k: _map(v, fn) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_map(v, fn) for v in x)
    return x


def step_no_lone(fn, n_batched: int, *args, **kwargs):
    """fn(*args, **kwargs), whose first n_batched arguments are batch-first
    (the first a FilterState), with a batch of one on the card run as two
    copies of itself (row 0 of every output kept).  On the card cuBLAS and
    cuSOLVER take another path for a lone matrix than for a batch of them
    (bmm of small products, cholesky_ex: `batch_invariance.py`), and the two
    round differently, while every batch count from two up rounds alike.
    So a rank that steps one sequence on the card computes it bit for bit
    as a process stepping it among others, at twice the device work.  On the
    CPU every operator of the step rounds a sequence alike at every batch
    size (`ekf.ekf_update` and `gram_gate_plain` take their vector parts out
    of matrix-matrix products), so a lone sequence runs alone."""
    if args[0].batch != 1 or args[0].p.device.type != "cuda":
        return fn(*args, **kwargs)
    pair = [_map(a, lambda t: torch.cat([t, t])) for a in args[:n_batched]]
    return _map(fn(*pair, *args[n_batched:], **kwargs), lambda t: t[:1])


# the port's kernels, by the names chip_smoke.py reports them under
KERNELS = ("lk_pyramid", "msckf_gram_gate", "line_runlen")


def zero_launches():
    """Set the kernels' launch counts to 0."""
    from ..ops import line_kernel, lk_kernel
    from ..ops.msckf_kernel import gram_gate

    lk_kernel.lk_pyramid.launches = 0
    gram_gate.launches = 0
    line_kernel.reaches.launches = 0


def kernel_launches() -> dict:
    """This process's launch count of each kernel since `zero_launches`."""
    from ..ops import line_kernel, lk_kernel
    from ..ops.msckf_kernel import gram_gate

    return dict(zip(KERNELS, (lk_kernel.lk_pyramid.launches, gram_gate.launches,
                              line_kernel.reaches.launches)))


def take_shard(group: RankGroup, x, sl: slice):
    """x[sl] on the group's device: a tensor, a numpy array, or a dataclass
    of tensors (FilterState, TrackState) whose tensor fields are sliced."""
    x = x if dataclasses.is_dataclass(x) else torch.as_tensor(x)
    return _map(x, lambda t: t[sl].to(group.device))


def reduce_metrics(group: RankGroup, metrics: dict) -> dict:
    """Whole-batch sums of per-sequence (B,) metrics, as JAX's `jnp.sum`
    over the sharded axis: the counts in one int64 all_reduce, the float
    metrics (the mean reprojection error) in one float64 all_reduce.
    Returns 0-d tensors on the group's device."""
    out = {}
    for dtype, floating in ((torch.int64, False), (F64, True)):
        keys = [k for k, v in metrics.items() if v.is_floating_point() == floating]
        if keys:
            buf = torch.stack([metrics[k].sum(dtype=dtype) for k in keys])
            dist.all_reduce(buf)
            out.update(zip(keys, buf))
    return out


def _sharded(step, n_batched: int, group: RankGroup, model: int, window_size: float):
    def run(states: FilterState, *args):
        B = len(args[0])
        sl = shard_slice(group, B)
        if states.batch == B:
            states = take_shard(group, states, sl)
        elif states.batch != sl.stop - sl.start:
            raise ValueError(f"states of {states.batch} sequences: neither the batch of {B} "
                             f"nor this rank's shard of it")
        per_seq = [take_shard(group, a, sl) for a in args[:n_batched]]
        rest = [a.to(group.device) if torch.is_tensor(a) else a for a in args[n_batched:]]
        new, metrics = step_no_lone(step, 1 + n_batched, states, *per_seq, *rest, model=model,
                                    window_size=window_size, cam_dtype=CAM_DTYPE)
        return new, reduce_metrics(group, metrics)

    return run


def sharded_step_fn(group: RankGroup, model: int = 0, window_size: float = 1.0):
    """`batched_step` with the sequence axis sharded over the group's ranks.

    The returned function takes the whole batch (the state and the 8
    per-sequence arrays imu_t ... obs_valid, then gravity, sigmas,
    sigma_pix, chi2_mult), runs this rank's shard on its device and returns
    (this shard's new states, whole-batch metric sums).  The states may also
    be this rank's shard, as the function returns them, so steps chain
    without a gather (as JAX's sharded arrays stay sharded)."""
    return _sharded(batched_step, 8, group, model, window_size)


def sharded_full_step_fn(group: RankGroup, model: int = 0, window_size: float = 1.0):
    """`batched_full_step` sharded as `sharded_step_fn` (16 per-sequence
    arrays: points, lines and the wheel stack)."""
    return _sharded(batched_full_step, 16, group, model, window_size)


def gather_rows(group: RankGroup, x: torch.Tensor) -> torch.Tensor:
    """The ranks' equal-shaped x concatenated along dim 0 in rank order, on
    every rank (all_gather in list form, which Gloo takes on CUDA)."""
    parts = [torch.empty_like(x) for _ in range(group.world)]
    dist.all_gather(parts, x.contiguous())
    return torch.cat(parts)


def gather_states(group: RankGroup, state: FilterState) -> FilterState:
    """The whole batch's states on every rank: each shard flattened into one
    float64 buffer (every field's values are exact in float64), gathered in
    one collective and cast back field by field."""
    flat = torch.cat([getattr(state, n).reshape(state.batch, -1).to(F64) for n in FIELDS], 1)
    whole = gather_rows(group, flat)
    out, off = {}, 0
    for n in FIELDS:
        t = getattr(state, n)
        size = t[0].numel()
        out[n] = whole[:, off:off + size].reshape(whole.shape[:1] + t.shape[1:]).to(t.dtype)
        off += size
    return state.replace(**out)


# ---------------------------------------------------------------------------
# starting ranks
# ---------------------------------------------------------------------------

def _run_rank(jobs, rank, world, init_method, device):
    group = init_rank_group(rank, world, init_method, device)
    try:
        # results leave the process as numpy arrays
        return [_map(fn(*args, group=group, **kwargs), lambda t: t.detach().cpu().numpy())
                for fn, args, kwargs in jobs]
    finally:
        dist.destroy_process_group()


def _rank_main(jobs, rank, world, init_method, device, results):
    """A spawned rank: runs the jobs and puts (rank, ok, results or traceback)."""
    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)  # several ranks share the host's cores
    try:
        out = _run_rank(jobs, rank, world, init_method, device)
    except Exception:
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)
    results.put((rank, True, out))


def _collect(procs, results, timeout: float) -> list:
    out = {}
    deadline = time.monotonic() + timeout
    while len(out) < len(procs):
        try:
            rank, ok, payload = results.get(timeout=1.0)
        except queue.Empty:
            missing = [r for r in range(len(procs)) if r not in out]
            if time.monotonic() > deadline:
                raise TimeoutError(f"ranks {missing} gave no result within {timeout} s")
            dead = [r for r in missing if procs[r].exitcode not in (None, 0)]
            if not dead:
                continue
            try:  # a failed rank puts its traceback before it exits
                rank, ok, payload = results.get(timeout=5.0)
            except queue.Empty:
                raise RuntimeError("ranks " + ", ".join(
                    f"{r} (exit code {procs[r].exitcode})" for r in dead)
                    + " ended without a result") from None
        if not ok:
            raise RuntimeError(f"rank {rank} failed:\n{payload}")
        out[rank] = payload
    return [out[r] for r in range(len(procs))]


def run_rank_jobs(jobs, world: int, device="cuda", timeout: float = 600.0) -> list:
    """Run each job (fn, args, kwargs) in turn as fn(*args, group=<RankGroup>,
    **kwargs) on the same `world` ranks: one process start for them all.
    Returns, per rank in rank order, the list of its jobs' results, tensors
    as numpy arrays.

    Each fn must be a module-level function (it is pickled by name).  World
    1 runs in this process, in a process group of one torn down afterwards;
    more ranks are processes of the `spawn` start method (never `fork`: this
    process may hold a CUDA context) that meet at a file rendezvous in a
    fresh temporary directory, CPU ranks with one thread each.  For CUDA
    ranks the kernel library is built here first, so that no two ranks run
    nvcc.  Raises RuntimeError when a rank fails (with its traceback) and
    TimeoutError when the ranks take longer than `timeout` seconds; every
    rank process has ended when this returns or raises."""
    jobs = [(fn, tuple(args), dict(kwargs or {})) for fn, args, kwargs in jobs]
    if checked_device(device).type == "cuda":
        from ..ops.cuda_lib import build_library

        build_library()
    with tempfile.TemporaryDirectory() as tmp:
        init = (Path(tmp) / "rendezvous").as_uri()
        if world == 1:
            return [_run_rank(jobs, 0, 1, init, device)]
        ctx = multiprocessing.get_context("spawn")
        results = ctx.Queue()
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(jobs, r, world, init, device, results))
                 for r in range(world)]
        for p in procs:
            p.start()
        done = False
        try:
            out = _collect(procs, results, timeout)
            done = True
            return out
        finally:
            for p in procs:
                p.join(timeout=30.0 if done else 0.0)
                if p.is_alive():
                    p.kill()
                    p.join()


def run_ranks(fn, world: int, args=(), kwargs=None, device="cuda",
              timeout: float = 600.0) -> list:
    """`run_rank_jobs` of the one job fn(*args, group=..., **kwargs): the
    ranks' results in rank order."""
    return [r[0] for r in run_rank_jobs([(fn, args, kwargs)], world, device, timeout)]
