"""The line front-end (`frame.frontend.lines`: the run-length detector, the line slots, their
undistort and histories) of a fleet frame batch: its device milliseconds, the median over
the traced frames (`_spans`)."""

from ._spans import median_ms


def read(rec):
    return median_ms(rec, "frame", ("frame.frontend.lines",))
