"""The median of the driver's own span `VioSystem.frame_timing["cam"]` (host clock, ms)
over the traced run's frames."""

import numpy as np


def read(rec):
    cam = [f["cam"] for f in rec.get("frame_timing") or [] if "cam" in f]
    return float(np.median(cam)) if cam else None
