"""The gate/Gram kernel's share of its roofline (%), the point and line calls together:
the frozen bounds of the traced calls (`_roofline.gram_bound`) over the profiler's device
time of its two kernels (`gate_project_kernel`, `gram_kernel`) in the same stretch."""

from ._roofline import gram_bound, kernel_ms, roofline_pct


def read(rec):
    calls = (rec.get("kernel_calls") or {}).get("gram")
    if not calls or not rec.get("profile"):
        return None
    return roofline_pct([gram_bound(args, out[2])[0] for args, out in calls],
                        kernel_ms(rec["profile"]["device"], ("gate_project_kernel", "gram_kernel")))
