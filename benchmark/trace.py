"""What the traced run records, from the benchmark's own files: a profiler stretch, an
ATen operator count, a count of synchronizing CUDA calls, and wrappers that keep the
kernels' arguments.  The metric readers in `metrics/` turn these records into numbers.
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import inspect
import json
import warnings
from pathlib import Path

import torch

from .reference.plv.ops import lk_kernel as ref_lk

STRETCH = "bench.stretch"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def profile(fn, path: Path) -> dict:
    """Run fn() under torch.profiler (CPU and, where there is a card, CUDA activity) in a
    span that ends after the device has finished, and read the trace back.  Returns
    {"window": (t0, t1) us of the span, "device": [(name, t0, t1)] us of every kernel,
    copy and fill on the device, "cpu": [(name, t0, t1)] us of every host operator}."""
    from torch.profiler import ProfilerActivity, record_function

    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with torch.profiler.profile(activities=acts) as prof:
        with record_function(STRETCH):
            fn()
            if cuda:
                torch.cuda.synchronize()
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    path.unlink()
    window, device, cpu = None, [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        t0 = float(e["ts"])
        span = (e.get("name", ""), t0, t0 + float(e.get("dur", 0.0)))
        cat = e.get("cat", "")
        if cat == "user_annotation" and e.get("name") == STRETCH:
            window = span[1:]
        elif cat in DEVICE_CATS:
            device.append(span)
        elif cat == "cpu_op":
            cpu.append(span)
    return {"window": window, "device": device, "cpu": cpu}


def count_ops(fn) -> int:
    """The ATen operators that fn() dispatches (a torch dispatch-mode count)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return Count.n


def counts(fn) -> tuple[int, int]:
    """(ATen operators, synchronizing CUDA calls) that fn() makes, counted in one pass."""
    box = {}
    syncs = count_syncs(lambda: box.update(ops=count_ops(fn)))
    return box["ops"], syncs


def count_syncs(fn) -> int:
    """The synchronizing CUDA calls that fn() makes, as the sync debug mode reports them
    (0 where there is no card)."""
    if not torch.cuda.is_available():
        fn()
        return 0
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum(1 for w in caught if "synchroniz" in str(w.message))


@contextlib.contextmanager
def kernel_calls(program, calls: dict):
    """Bind the images-in frame's LK and gate/Gram entries (`ops/lk_kernel.pyramidal_lk`
    and `core/step.gram_gate` of `program`, see `program.load`) to wrappers that append
    each call's (arguments, outputs) to calls["lk"] and calls["gram"]; the LK's arguments
    are its ten positional ones.  An entry the program no longer has is left alone, and
    an LK call whose arguments do not bind to the ten is not kept: what is kept is only
    read, by the kernels' plain versions and the roofline counts, never required."""
    lk_kernel = getattr(program.frame, "lk_kernel", None)
    try:
        step = importlib.import_module(program.frame.__package__ + ".step")
    except ImportError:
        step = None
    sig = inspect.signature(ref_lk.pyramidal_lk)  # the entry's signature, whatever is bound

    def keeper(name, fn):
        @functools.wraps(fn)  # so that a wrapper of this wrapper binds the same signature
        def keep(*args, **kwargs):
            out = fn(*args, **kwargs)
            if name == "lk":
                try:
                    bound = sig.bind(*args, **kwargs)
                except TypeError:
                    return out
                bound.apply_defaults()
                args = tuple(bound.arguments.values())
            calls.setdefault(name, []).append((args, out))
            return out
        return keep

    bound = [(mod, attr, name) for mod, attr, name in
             ((lk_kernel, "pyramidal_lk", "lk"), (step, "gram_gate", "gram"))
             if mod is not None and callable(getattr(mod, attr, None))]
    real = [getattr(mod, attr) for mod, attr, _ in bound]
    for (mod, attr, name), fn in zip(bound, real):
        setattr(mod, attr, keeper(name, fn))
    try:
        yield calls
    finally:
        for (mod, attr, _), fn in zip(bound, real):
            setattr(mod, attr, fn)
