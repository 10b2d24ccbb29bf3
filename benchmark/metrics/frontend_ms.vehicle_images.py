"""The front-end (`frame.frontend`) of a vehicle's images-in frame (under the driver's
`image` span): its device milliseconds, the median over the traced frames (`_spans`)."""

from ._spans import median_ms


def read(rec):
    return median_ms(rec, "image", ("frame.frontend",))
