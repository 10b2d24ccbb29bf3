"""The 95th percentile of every frame latency of the window (ms): from the call that hands
the driver the last input a frame waits for to that call's return with the pose recorded."""

import numpy as np


def read(rec):
    lat = rec.get("latencies_ms")
    if not lat:
        return None
    return float(np.percentile(np.asarray(lat, dtype=np.float64), 95))
