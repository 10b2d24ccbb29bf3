"""Arithmetic on the program's stage spans (`plviwo_tpu_torch/utils/timing.spans`): the
spans a traced run recorded, grouped per frame by their root span, each stage's device
milliseconds summed per frame, and the median over the frames.

The records are read from the port's timing module where the run has loaded it; this
file never imports the port.  A program without the module, a run with a control (no
port loaded), a run that was not traced and a run on the CPU (no device time) read
nothing."""

from __future__ import annotations

import statistics
import sys

MODULE = "plviwo_tpu_torch.utils.timing"
# the filter's stages of an images-in frame: propagation and clone, every row with the
# gate/Gram kernel, compression and the EKF update
FILTER = ("frame.time_update", "frame.rows", "frame.update")


def records(rec):
    """The spans the program recorded during a traced run (`rec` holds its profile), or
    an empty list."""
    mod = sys.modules.get(MODULE)
    read = getattr(mod, "spans", None)
    if not rec.get("profile") or read is None:
        return []
    return list(read())


def per_root(spans, root: str, stages) -> list:
    """Per root span named `root`, in order: the sum of `device_ms` over the spans under
    it (at any depth) whose name is in `stages`; None for a root where one of them has no
    device time.  Roots under which no such stage ran are left out."""
    by_id = {s.id: s for s in spans}
    top = {}

    def root_of(s):
        if s.id not in top:
            top[s.id] = s if s.parent is None or s.parent not in by_id else root_of(
                by_id[s.parent])
        return top[s.id]

    sums = {}
    for s in spans:
        r = root_of(s)
        if r.name != root or s.name not in stages:
            continue
        prev = sums.get(r.id, 0.0)
        sums[r.id] = None if prev is None or s.device_ms is None else prev + s.device_ms
    return [sums[k] for k in sorted(sums)]


def median_ms(rec, root: str, stages):
    """The median over the traced frames of `per_root`, or None where no frame ran the
    stages or one of them has no device time."""
    vals = per_root(records(rec), root, stages)
    if not vals or any(v is None for v in vals):
        return None
    return float(statistics.median(vals))
