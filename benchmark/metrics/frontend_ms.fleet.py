"""The front-end (`frame.frontend`: `track_frame`) of a fleet frame batch: its device
milliseconds, the median over the traced frames (`_spans`)."""

from ._spans import median_ms


def read(rec):
    return median_ms(rec, "frame", ("frame.frontend",))
