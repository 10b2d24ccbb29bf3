"""A/B of the gate/Gram kernel against another version of its source.

Run from the repository root on a CUDA card:
  python3 gram_gate_ab.py OTHER.cu
OTHER.cu is another version of plviwo_tpu_torch/csrc/msckf_gram_gate.cu
with the same C entry point `msckf_gram_gate`, e.g. an earlier commit's
(`git show <rev>:plviwo_tpu_torch/csrc/msckf_gram_gate.cu > build/other.cu`).
It is compiled with the port's nvcc flags into build/.  On chip_smoke.py's
three synthetic gate/Gram shapes and on the arguments the images-in path
gave the kernel in its last frame, both versions are held to the plain
version, timed with CUDA events over 20 calls in turns other, this, this,
other, and split into their kernels' device times per call by
torch.profiler.  Prints one JSON line per input, then the card's name and
power limit.  Imports no JAX.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import chip_smoke as cs


def build_other(src: Path, entry: str = "msckf_gram_gate") -> tuple[ctypes.CDLL, str]:
    """`src` compiled with the port's nvcc flags into a shared library of its
    own under build/, its C function `entry` typed as this version's.
    Returns (library, the compiler's `-Xptxas -v` report)."""
    from plviwo_tpu_torch.ops import cuda_lib

    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    so = cuda_lib.BUILD_DIR / f"{entry}_ab_{digest}.so"
    log = so.with_suffix(".log")
    if not so.exists():
        so.parent.mkdir(parents=True, exist_ok=True)
        out = subprocess.run([cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-shared", "-o", str(so),
                              str(src)], check=True, capture_output=True, text=True)
        log.write_text(out.stdout + out.stderr)
    lib = ctypes.CDLL(str(so))
    fn, this = getattr(lib, entry), getattr(cuda_lib.library(), entry)
    fn.argtypes, fn.restype = this.argtypes, this.restype
    return lib, log.read_text() if log.exists() else ""


def call(lib, Hx, Hf, r, rowmask, w, cov, gate_vec, resid_cap):
    """`lib.msckf_gram_gate` on `gram_gate`'s arguments; its outputs."""
    import torch

    from plviwo_tpu_torch.ops.cuda_lib import current_stream

    B, F, M, D = Hx.shape
    k = Hf.shape[-1]
    f32, dev = torch.float32, Hx.device
    P = torch.empty((B, F, M - k, D + 1), dtype=f32, device=dev)
    ok = torch.empty((B, F), dtype=torch.bool, device=dev)
    chi2 = torch.empty((B, F), dtype=f32, device=dev)
    G = torch.empty((B, D, D), dtype=f32, device=dev)
    c = torch.empty((B, D), dtype=f32, device=dev)
    err = lib.msckf_gram_gate(
        Hx.data_ptr(), Hf.data_ptr(), r.data_ptr(), rowmask.data_ptr(), w.data_ptr(),
        cov.data_ptr(), gate_vec.data_ptr(), float(resid_cap), B, F, M, D, k, P.data_ptr(),
        ok.data_ptr(), chi2.data_ptr(), G.data_ptr(), c.data_ptr(), current_stream(dev))
    if err != 0:
        raise RuntimeError(f"other msckf_gram_gate launch failed ({err})")
    return G, c, ok, chi2


def kernel_ms(fn, n_iter=20):
    """Device ms per call of each kernel fn launches (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n_iter):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0.0)
        if t > 0:
            out[e.key.replace("(anonymous namespace)::", "")[:48]] = t / n_iter / 1e3
    return out


def main() -> int:
    import torch

    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    from plviwo_tpu_torch.ops.msckf_kernel import gram_gate, gram_gate_plain

    dev = torch.device("cuda", 0)
    other, _ = build_other(Path(sys.argv[1]))
    sim, frames = cs.images_in_inputs(dev)
    captured = {}
    cs.run_images_in(sim, frames, dev, captured)
    cases = [(f"k={k} B={Bn} F={F} M={M} D={D}", cs.gram_args(k, Bn, F, M, D, dev))
             for k, Bn, F, M, D in ((3, cs.B_IMG, cs.N_PTS, 2 * cs.MAX_OBS, 124),
                                    (3, cs.B, cs.F_PTS, cs.M_ROWS, 162),
                                    (4, cs.B, cs.L_LINES, cs.M_ROWS, 162))]
    cases.append(("captured images-in frame", captured["gram_gate"]))
    for tag, args in cases:
        ref = gram_gate_plain(*args)
        cs.check_gram(gram_gate(*args), ref, tag)
        cs.check_gram(call(other, *args), ref, tag + " (other)")
        t_other = [cs.cuda_ms(lambda: call(other, *args))]
        t_this = [cs.cuda_ms(lambda: gram_gate(*args)) for _ in range(2)]
        t_other.append(cs.cuda_ms(lambda: call(other, *args)))
        rowmask, D, k = args[3], args[0].shape[-1], args[1].shape[-1]
        bms, by = cs.gram_bound(rowmask, ref[2], D, k)
        print(json.dumps(dict(
            tag=tag, shape=list(args[0].shape), k=k, this_ms=t_this, other_ms=t_other,
            this_kernels_ms=kernel_ms(lambda: gram_gate(*args)),
            other_kernels_ms=kernel_ms(lambda: call(other, *args)),
            bound_ms=bms, bound_by=by, n_ok=int(ref[2].sum()),
            n_live=int((rowmask.sum(-1) > k).sum()))))
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
