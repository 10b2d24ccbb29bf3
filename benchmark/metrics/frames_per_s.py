"""Sequence-frames completed in the window over the window's time: every frame batch
launched counts its B frames, and the window closes once the device has finished them."""


def read(rec):
    if not rec.get("frames") or not rec.get("window_s"):
        return None
    return rec["frames"] / rec["window_s"]
