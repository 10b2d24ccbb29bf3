"""The filter of a fleet frame batch: the device milliseconds of `_spans.FILTER`
(`frame.time_update` + `frame.rows` + `frame.update`), the median over the traced frame
batches."""

from ._spans import FILTER, median_ms


def read(rec):
    return median_ms(rec, "frame", FILTER)
