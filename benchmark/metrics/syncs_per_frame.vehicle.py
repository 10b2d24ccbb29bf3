"""Synchronizing CUDA calls per processed frame under torch.cuda.set_sync_debug_mode."""


def read(rec):
    if not rec.get("sync_frames"):
        return None
    return rec["syncs"] / rec["sync_frames"]
