"""The system under test, or the control that stands in its place.

`load()` returns the port's modules that the drivers call.  `load("tf32")` and
`load("f32_state")` return the benchmark's frozen plain reference instead, computed in
the precision just below what the configuration states.  "tf32": the images-in frame
with its float32 matrix products on TF32 (the configuration states float32 camera
tensors with TF32 off) and its LK, float32 arithmetic outside any product, on images
rounded to bfloat16.  "f32_state": the per-track filter (float64) with its state rounded
to float32 after every frame (`drivers/feed_camera.round_state_f32`).  The controls are
for the comparison's own readings and test (`benchmark/control.py`,
`tests/test_bench_control.py`); the benchmark's runs never load them.
"""

from __future__ import annotations

import functools
from types import SimpleNamespace

import torch

CONTROLS = ("tf32", "f32_state")


def load(control: str | None = None) -> SimpleNamespace:
    """The modules a driver calls: frame, state, layout, system, options, ekf."""
    if control is None:
        from plviwo_tpu_torch.config import options
        from plviwo_tpu_torch.core import ekf, frame, layout, state, system
        return SimpleNamespace(name="plviwo_tpu_torch", control=None, frame=frame, state=state,
                               layout=layout, system=system, options=options, ekf=ekf)
    if control not in CONTROLS:
        raise ValueError(f"unknown control {control!r}; one of {CONTROLS}")
    from .reference.checks import tf32
    from .reference.plv.config import options
    from .reference.plv.core import ekf, frame, layout, state, system
    from .reference.plv.ops import lk_kernel

    if control == "tf32":
        plain_frame, plain_lk = frame.fused_frame, lk_kernel.lk_pyramid

        def bf16(pyr):
            return tuple(x.to(torch.bfloat16).to(torch.float32) for x in pyr)

        def lk_bf16(prev_pyr, next_pyr, *rest):
            return plain_lk(bf16(prev_pyr), bf16(next_pyr), *rest)

        @functools.wraps(plain_frame)
        def low_frame(*args, **kwargs):
            tf32(True)
            lk_kernel.lk_pyramid = lk_bf16
            try:
                return plain_frame(*args, **kwargs)
            finally:
                lk_kernel.lk_pyramid = plain_lk
                tf32(False)

        # the drivers call the frame through `frame.fused_frame` or the driver module's
        # own name for it; the reference's checks call `fused_frame` of the frame module
        # through `checks.ref_fused_frame`, which stays plain
        system.fused_frame = low_frame
        frame = SimpleNamespace(fused_frame=low_frame, make_track_state=frame.make_track_state,
                                lk_kernel=lk_kernel, ekf=ekf, __package__=frame.__package__)
    return SimpleNamespace(name=f"reference ({control})", control=control, frame=frame,
                           state=state, layout=layout, system=system, options=options, ekf=ekf)


def apply_options(opts, values: dict):
    """Set a configuration's `options` ({"cam.n_pts": 150, ...}) on an option tree."""
    for key, value in values.items():
        *path, leaf = key.split(".")
        node = opts
        for part in path:
            node = getattr(node, part)
        if not hasattr(node, leaf):
            raise KeyError(f"option {key}: no such field")
        setattr(node, leaf, value)
    return opts
