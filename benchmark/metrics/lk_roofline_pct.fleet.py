"""The LK kernel's share of its roofline (%): the frozen bounds of the traced calls
(`_roofline.lk_bound`, from each call's own arguments) over the profiler's device time of
the `lk_pyramid` kernel in the same stretch."""

from ._roofline import kernel_ms, lk_bound, roofline_pct


def read(rec):
    calls = (rec.get("kernel_calls") or {}).get("lk")
    if not calls or not rec.get("profile"):
        return None
    return roofline_pct([lk_bound(*args)[0] for args, _ in calls],
                        kernel_ms(rec["profile"]["device"], ("lk_pyramid",)))
