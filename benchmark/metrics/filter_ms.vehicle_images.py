"""The filter of a vehicle's images-in frame (under the driver's `image` span): the device
milliseconds of `_spans.FILTER` (`frame.time_update` + `frame.rows` + `frame.update`), the
median over the traced frames."""

from ._spans import FILTER, median_ms


def read(rec):
    return median_ms(rec, "image", FILTER)
