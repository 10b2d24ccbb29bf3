"""Seconds from the process's start to the first timed frame (loading, the kernels' build
where it is the checkout's first run, the traffic's generation, the warm-up)."""


def read(rec):
    return rec.get("setup_s")
