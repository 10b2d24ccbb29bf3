"""ATen operators dispatched per frame (a dispatch-mode count over the counted frames; at
B = 64 a frame batch counts as one frame).  A count, not a time."""


def read(rec):
    if not rec.get("host_ops_frames"):
        return None
    return rec["host_ops"] / rec["host_ops_frames"]
