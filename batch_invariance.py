"""Which operators of the full step depend on the batch size.

Run from the repository root:  python3 batch_invariance.py [--device cpu]

A sharded run gives each rank a smaller batch than one process gets, so a
sharded result equals the one-process result bit for bit only where every
operator computes a sequence's values the same way at every batch size.
This script runs `core.step.fused_step_full` (float32 camera tensors, as
the distributed layer runs it) with every ATen call logged
(`TorchDispatchMode`), once on sequence 0 alone (and once on it twice, as
`parallel.replay.step_no_lone` steps a lone sequence) and once on a batch
of k sequences that starts with it, for k = 2 and 4, on two inputs:
`examples.example_inputs_full` and the first frames of config 5's first
sequences (`parallel.batch_replay`).  The two call lists are aligned by
operator name (layout-only operators left out); where sequence 0's rows of
an output differ while every input's rows agree, that call is a root of
the difference.  Prints one JSON line per input and k: the differing calls,
the roots grouped by operator and input shapes and dtypes (calls, max
|difference|), and whether the new state is equal bit for bit.

Then the plain gate/Gram's two forms on chip_smoke.py's images-in shapes
(`gram_forms`): G and c from one product of [Hv | rv] (`gram_gate_plain`)
against G and c from two (Hv^T Hv, and Hv^T rv as a matrix-vector
product), on the same inputs: how far apart they are, whether each gives
sequence 0 alone as in the batch, and on the card each one's time and the
kernel's distance from each.  Then the card's name and power limit.
Imports no JAX.
"""

from __future__ import annotations

import argparse
import difflib
import json
import subprocess
import sys

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

LAYOUT_ONLY = ("view", "clone", "_unsafe_view", "expand", "aten.t.", "transpose", "permute",
               "slice", "select", "unsqueeze", "squeeze", "alias", "detach", "_reshape_alias",
               "as_strided", "copy_", "contiguous", "lift_fresh", "empty", "_to_copy")


class _Log(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = str(func)
        if not any(s in name for s in LAYOUT_ONLY):
            self.calls.append((name, out, args))
        return out


def _rows_equal(a, b, n_base: int):
    """Whether sequence 0's rows of a (the base batch of n_base sequences)
    equal those of b (a batch whose first dim is a multiple of a's), or None
    where the two are not comparable that way."""
    if not (torch.is_tensor(a) and torch.is_tensor(b)) or a.ndim == 0 or a.ndim != b.ndim:
        return None
    if a.is_meta or b.is_meta or a.shape[0] % n_base:
        return None
    if a.shape[1:] != b.shape[1:] or b.shape[0] % a.shape[0] or b.shape[0] == a.shape[0]:
        return None
    rows = a.shape[0] // n_base
    a, b = a[:rows], b[:rows]
    if a.is_floating_point():
        return bool(torch.equal(torch.nan_to_num(a), torch.nan_to_num(b)))
    return bool(torch.equal(a, b))


def _describe(args):
    return [f"{tuple(x.shape)} {str(x.dtype)[6:]}" if torch.is_tensor(x) else
            type(x).__name__ for x in args]


def compare(run, base: list, k: int) -> dict:
    """run(seqs) -> new state of the sequences seqs; sequence 0 in the batch
    `base` (alone: [0]; as `replay.step_no_lone` steps it: [0, 0]) against
    a batch of k sequences 0, 1, ..., k - 1."""
    with _Log() as one:
        s1 = run(base)
    with _Log() as many:
        sk = run(list(range(k)))
    names = [[c[0] for c in log.calls] for log in (one, many)]
    matcher = difflib.SequenceMatcher(a=names[0], b=names[1], autojunk=False)
    differing, roots = 0, {}
    for tag, i1, i2, j1, j2 in matcher.get_opcodes():
        if tag != "equal":
            continue
        for i, j in zip(range(i1, i2), range(j1, j2)):
            (name, a, a_in), (_, b, b_in) = one.calls[i], many.calls[j]
            if _rows_equal(a, b, len(base)) is not False:
                continue
            differing += 1
            inputs = [_rows_equal(x, y, len(base)) for x, y in zip(a_in, b_in)]
            if False in inputs or None in inputs:
                continue  # a difference passed on, or inputs this cannot compare
            rows = a.shape[0] // len(base)
            d = (a[:rows].double() - b[:rows].double()).abs().max().item() \
                if a.is_floating_point() else None
            key = f"{name} {' x '.join(_describe(a_in))}"
            n, worst = roots.get(key, (0, 0.0))
            roots[key] = (n + 1, max(worst, d or 0.0))
    equal = all(torch.equal(getattr(s1, n)[:1], getattr(sk, n)[:1]) for n in ("p", "q", "cov"))
    return {"base": base, "k": k, "calls": len(names[0]), "differing_calls": differing,
            "roots": {key: {"calls": n, "max_abs_diff": d} for key, (n, d) in roots.items()},
            "state_bitwise": equal}


def example_run(dev):
    from plviwo_tpu_torch.core.step import fused_step_full
    from plviwo_tpu_torch.examples import SIGMA_LINE, WHEEL_NOISE, batch_args, example_inputs_full

    args = example_inputs_full(device="cpu")

    def run(seqs):  # every sequence is the same example
        full = batch_args(args, len(seqs), device=dev) + (SIGMA_LINE, WHEEL_NOISE)
        return fused_step_full(*full, model=0, window_size=1.0, cam_dtype=torch.float32)[0]

    return run


def config5_run(dev, n_frames: int):
    """Config 5's first n_frames frames of sequences 0..B-1 (their own
    inputs, not copies), as `batch_replay.replay_rank` steps them."""
    from plviwo_tpu_torch.core.layout import StateLayout
    from plviwo_tpu_torch.core.state import FilterState
    from plviwo_tpu_torch.core.step import fused_step_full
    from plviwo_tpu_torch.parallel.batch_replay import build_sequence_inputs, seed_state
    from plviwo_tpu_torch.sim.simulator import SimConfig, Simulator

    layout = StateLayout(n_clones=11, n_cams=1, use_wheel=True)
    keys = ("imu_t", "imu_w", "imu_a", "times", "obs_uv", "obs_uvn", "obs_slot", "obs_valid",
            "line_uv", "line_uvn", "line_slot", "line_valid", "wheel_t", "wheel_m1",
            "wheel_m2", "wheel_valid")
    seqs, states = [], []
    for s in range(4):
        sim = Simulator(SimConfig(duration=12.0, seed=10 + s, n_pts=45, sigma_pix=0.8))
        seqs.append(build_sequence_inputs(sim, 1.0, 109, 10.0, 11, 32, 8, 12))
        states.append(seed_state(sim, layout, 1.0))
    cfg = sim.cfg

    def run(idx):
        st = FilterState.from_numpy([states[i] for i in idx], layout, dev)
        frames = [torch.as_tensor(np.stack([seqs[i][k] for i in idx], 1)).to(dev) for k in keys]
        frames = [f.long() if f.dtype == torch.int32 else f for f in frames]
        gravity = torch.tensor([0.0, 0.0, 9.81], dtype=torch.float64, device=dev)
        for i in range(n_frames):
            st, _ = fused_step_full(
                st, *(f[i] for f in frames), gravity,
                (cfg.sigma_w, cfg.sigma_a, cfg.sigma_wb, cfg.sigma_ab), 1.2, 6.0, 2.0,
                (0.05, 0.05, 0.02), model=0, window_size=0.95 * 11 / 10.0,
                cam_dtype=torch.float32)
        return st

    return run


def single_ops(dev) -> dict:
    """Batched matrix products and factorizations at the step's shapes: for
    each, the batch counts among 2, 3, 4 and 8 at which matrix 0's result
    equals its result alone (batch count 1), and those among 3, 4 and 8 at
    which it equals its result at batch count 2."""
    gen = torch.Generator(device="cpu").manual_seed(0)

    def rnd(*shape, dtype=torch.float64):
        return torch.randn(8, *shape, generator=gen, dtype=torch.float64).to(dev, dtype)

    def spd(n):
        A = rnd(n, 2 * n)
        return A @ A.transpose(-1, -2) / n + torch.eye(n, dtype=torch.float64, device=dev)

    f32 = torch.float32
    L78 = torch.linalg.cholesky_ex(spd(78))[0]
    cases = {  # name: (function, its batch-of-8 arguments)
        "bmm f32 15x15 @ 15x15": (torch.matmul, (rnd(15, 15, dtype=f32), rnd(15, 15, dtype=f32))),
        "bmm f64 3x3 @ 3x1": (torch.matmul, (rnd(3, 3), rnd(3, 1))),
        "bmm f64 3x3 @ 3x3": (torch.matmul, (rnd(3, 3), rnd(3, 3))),
        "bmm f64 78x78 @ 78x1": (torch.matmul, (rnd(78, 78), rnd(78, 1))),
        "bmm f64 78x78 @ 78x78": (torch.matmul, (rnd(78, 78), rnd(78, 78))),
        "bmm f64 78x40 @ 40x79": (torch.matmul, (rnd(78, 40), rnd(40, 79))),
        "cholesky_ex f64 78": (lambda A: torch.linalg.cholesky_ex(A)[0], (spd(78),)),
        "cholesky_ex f64 3": (lambda A: torch.linalg.cholesky_ex(A)[0], (spd(3),)),
        "solve_triangular f64 78, 1 column": (
            lambda L, b: torch.linalg.solve_triangular(L, b, upper=False), (L78, rnd(78, 1))),
        "solve_triangular f64 78, 79 columns": (
            lambda L, b: torch.linalg.solve_triangular(L, b, upper=False), (L78, rnd(78, 79))),
        "sum f64 over 78 of (n,78,78)": (lambda x: x.sum(-2), (rnd(78, 78),)),
    }
    out = {}
    for name, (fn, args) in cases.items():
        res = {n: fn(*(a[:n] for a in args))[0] for n in (1, 2, 3, 4, 8)}
        out[name] = {"alone_equal_at": [n for n in (2, 3, 4, 8) if torch.equal(res[1], res[n])],
                     "pair_equal_at": [n for n in (3, 4, 8) if torch.equal(res[2], res[n])]}
    return out


def gram_forms(dev) -> list:
    """The plain gate/Gram's one-product form against the two-product form
    on chip_smoke.py's random systems at the images-in frame's shapes (B =
    64, M = 16, D = 132; points k = 3, F = 128 and lines k = 4, F = 24) and
    at config 5's (B = 4, M = 16, D = 106; points F = 32, lines F = 12)."""
    import chip_smoke as cs
    from plviwo_tpu_torch.ops.msckf_kernel import gate_rows, gram_gate, gram_gate_plain

    def two_products(*args):
        Hv, rv, ok, chi2 = gate_rows(*args)
        Hok = torch.where(ok[..., None, None], Hv, 0.0)
        rok = torch.where(ok[..., None], rv, 0.0)
        return (torch.einsum("bfmd,bfme->bde", Hok, Hok),
                torch.einsum("bfmd,bfm->bd", Hok, rok), ok, chi2)

    rows = []
    for k, B, F, M, D in ((3, cs.B_IMG, cs.N_PTS, 2 * cs.MAX_OBS, cs.D_IMG),
                          (4, cs.B_IMG, cs.MAX_LINES, 2 * cs.MAX_OBS, cs.D_IMG),
                          (3, 4, 32, 16, 106), (4, 4, 12, 16, 106)):
        args = cs.gram_args(k, B, F, M, D, dev)
        one, two = gram_gate_plain(*args), two_products(*args)

        def alone_equal_at(form):
            """The batch counts among 2, 4 and B at which sequence 0's G and c
            equal its G and c alone."""
            def first(n):  # the per-sequence arguments cut to n sequences
                return form(*(a[:n] if i in (0, 1, 2, 3, 4, 5) else a
                              for i, a in enumerate(args)))[:2]
            alone = first(1)
            return [n for n in sorted({2, 4, B}) if all(torch.equal(a, b[:1])
                                                 for a, b in zip(alone, first(n)))]

        row = {"k": k, "B": B, "F": F, "M": M, "D": D, "max_abs_dG": float((one[0] - two[0]).abs().max()),
               "max_abs_dc": float((one[1] - two[1]).abs().max()),
               "ok_equal": bool(torch.equal(one[2], two[2])),
               "alone_equal_at_one_product": alone_equal_at(gram_gate_plain),
               "alone_equal_at_two_products": alone_equal_at(two_products)}
        if dev.type == "cuda":
            out = gram_gate(*args)
            row.update(kernel_err_one_product=cs.check_gram(out, one, "one product"),
                       kernel_err_two_products=cs.check_gram(out, two, "two products"))
            # each form timed twice, in turns two, one, one, two
            t = [cs.cuda_ms(lambda f=f: f(*args)) for f in (two_products, gram_gate_plain,
                                                            gram_gate_plain, two_products)]
            row.update(ms_two_products=[t[0], t[3]], ms_one_product=[t[1], t[2]])
        rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--frames", type=int, default=3, help="config 5 frames to step")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("batch_invariance: no CUDA card here (pass --device cpu)", file=sys.stderr)
        return 2
    dev = torch.device(args.device, 0) if args.device == "cuda" else torch.device("cpu")
    if dev.type == "cpu":
        torch.set_num_threads(1)
    print(json.dumps({"single_ops": single_ops(dev), "device": str(dev)}), flush=True)
    for label, run in (("example_inputs_full", example_run(dev)),
                       (f"config5_{args.frames}_frames", config5_run(dev, args.frames))):
        for base, k in (([0], 2), ([0], 4), ([0, 0], 4)):
            print(json.dumps({"input": label, "device": str(dev), **compare(run, base, k)}),
                  flush=True)
    print(json.dumps({"gram_forms": gram_forms(dev), "device": str(dev)}), flush=True)
    if dev.type == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
