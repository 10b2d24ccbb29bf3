"""A/B of the pyramidal LK kernel against another version of its source.

Run from the repository root on a CUDA card:
  python3 lk_ab.py OTHER.cu
OTHER.cu is another version of plviwo_tpu_torch/csrc/lk_pyramid.cu with the
same C entry point `lk_pyramid`, e.g. an earlier commit's
(`git show <rev>:plviwo_tpu_torch/csrc/lk_pyramid.cu > build/other.cu`).
It is compiled with the port's nvcc flags into build/
(`gram_gate_ab.build_other`).  On chip_smoke.py's synthetic LK inputs and on
the arguments the images-in path gave the kernel in its last frame, both
versions are held to the plain version (`chip_smoke.check_lk`), timed with
CUDA events over 20 calls in turns other, this, this, other, and split into
their kernels' device times per call by torch.profiler.  Prints one JSON
line per input (with each version's `-Xptxas -v` report), then the card's
name and power limit.  Imports no JAX.
"""

from __future__ import annotations

import ctypes
import json
import sys
from pathlib import Path

import chip_smoke as cs
from gram_gate_ab import build_other, kernel_ms


def call(lib, prev_pyr, next_pyr, uv_prev, valid, levels, half, iters, max_err, drift,
         drift_fine):
    """`lib.lk_pyramid` on `lk_pyramid`'s arguments; its outputs."""
    import torch

    from plviwo_tpu_torch.ops.cuda_lib import current_stream

    B, N = valid.shape
    f32, dev = torch.float32, uv_prev.device
    uv = torch.empty((B, N, 2), dtype=f32, device=dev)
    ok = torch.empty((B, N), dtype=torch.bool, device=dev)
    err = torch.empty((B, N), dtype=f32, device=dev)
    det = torch.empty((B, N), dtype=f32, device=dev)
    ptrs, ints = ctypes.c_void_p * levels, ctypes.c_int * levels
    code = lib.lk_pyramid(
        ptrs(*(p.data_ptr() for p in prev_pyr[:levels])),
        ptrs(*(p.data_ptr() for p in next_pyr[:levels])),
        ints(*(p.shape[-2] for p in prev_pyr[:levels])),
        ints(*(p.shape[-1] for p in prev_pyr[:levels])), levels, uv_prev.data_ptr(),
        valid.data_ptr(), B, N, half, iters, drift, drift_fine, float(max_err), uv.data_ptr(),
        ok.data_ptr(), err.data_ptr(), det.data_ptr(), current_stream(dev))
    if code != 0:
        raise RuntimeError(f"other lk_pyramid launch failed ({code})")
    return uv, ok, err, det


def early_exit_share(args):
    """What an early exit for invalid features, and for features failed at a
    coarser level, would skip on these inputs (the plain version's level
    loop): the share of features that are invalid, and the share of the
    (feature, level) runs that such an exit would leave out."""
    prev_pyr, next_pyr, uv_prev, valid, levels, half, iters, _, drift, drift_fine = args
    from plviwo_tpu_torch.ops import klt

    uv, alive, runs = uv_prev / 2.0 ** (levels - 1), valid, 0
    for l in range(levels - 1, -1, -1):
        runs += int(alive.sum())
        uv, _, good, inb, _ = klt._lk_level_conv(
            prev_pyr[l], next_pyr[l], uv_prev / 2.0**l, uv, half, iters,
            drift if l == levels - 1 else drift_fine)
        alive = alive & inb & (good if l == 0 else True)
        if l > 0:
            uv = uv * 2.0
    return dict(invalid=1.0 - float(valid.float().mean()),
                level_runs_skipped=1.0 - runs / (levels * valid.numel()))


def main() -> int:
    import torch

    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    from plviwo_tpu_torch.ops import cuda_lib, klt
    from plviwo_tpu_torch.ops.lk_kernel import lk_pyramid

    dev = torch.device("cuda", 0)
    other, other_log = build_other(Path(sys.argv[1]), "lk_pyramid")
    this_ptxas = cs.lk_spills(cuda_lib.build_library()[2])
    other_ptxas = cs.ptxas_report(other_log, "lk_pyramid_kernel")
    sim, frames = cs.images_in_inputs(dev)
    captured = {}
    cs.run_images_in(sim, frames, dev, captured)
    for tag, args in (("synthetic", cs.lk_args(dev)), ("captured images-in frame",
                                                       captured["lk"])):
        ref = klt.pyramidal_lk_conv_full(*args)
        cs.check_lk(lk_pyramid(*args), ref, tag)
        cs.check_lk(call(other, *args), ref, tag + " (other)")
        t_other = [cs.cuda_ms(lambda: call(other, *args))]
        t_this = [cs.cuda_ms(lambda: lk_pyramid(*args)) for _ in range(2)]
        t_other.append(cs.cuda_ms(lambda: call(other, *args)))
        prev_pyr, next_pyr, uv, valid, levels, half, iters, _, drift, drift_fine = args
        bms, by = cs.lk_bound(prev_pyr, next_pyr, uv, levels, half, iters, drift, drift_fine)
        print(json.dumps(dict(
            tag=tag, B=int(uv.shape[0]), N=int(uv.shape[1]), this_ms=t_this, other_ms=t_other,
            this_kernels_ms=kernel_ms(lambda: lk_pyramid(*args)),
            other_kernels_ms=kernel_ms(lambda: call(other, *args)),
            bound_ms=bms, bound_by=by, n_valid=int(valid.sum()), n_ok=int(ref[1].sum()),
            early_exit=early_exit_share(args), this_ptxas=this_ptxas,
            other_ptxas=other_ptxas)))
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
