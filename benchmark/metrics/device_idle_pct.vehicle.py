"""Share of the traced stretch's wall time in which no operation ran on the device (%):
the union of the profiler's device intervals against the stretch's length."""

from ._device import idle_pct


def read(rec):
    return idle_pct(rec.get("profile"))
