"""The per-track driver's camera stage (`track.cam`: the MSCKF and SLAM updates) of a frame;
the device-timed counterpart of `cam_stage_ms.vehicle_kaist`: its device milliseconds, the
median over the traced frames (`_spans`)."""

from ._spans import median_ms


def read(rec):
    return median_ms(rec, "track", ("track.cam",))
