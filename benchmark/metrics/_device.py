"""Arithmetic on the traced stretch's device timeline (`trace.profile`'s record)."""

from __future__ import annotations

NAME = 160  # characters of a device operation's name kept in the breakdown


def busy_intervals(profile) -> list:
    """The union of the device's operation intervals inside the stretch, in us."""
    if not profile or profile.get("window") is None:
        return []
    w0, w1 = profile["window"]
    spans = sorted((max(t0, w0), min(t1, w1)) for _, t0, t1 in profile["device"]
                   if t1 > w0 and t0 < w1)
    out = []
    for t0, t1 in spans:
        if out and t0 <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t1)
        else:
            out.append([t0, t1])
    return out


def busy_s(profile):
    """Seconds in which an operation ran on the device, or None where none did."""
    busy = busy_intervals(profile)
    return sum(t1 - t0 for t0, t1 in busy) / 1e6 if busy else None


def window_s(profile):
    """Length of the traced stretch in seconds, or None."""
    if not profile or profile.get("window") is None:
        return None
    w0, w1 = profile["window"]
    return (w1 - w0) / 1e6


def idle_pct(profile):
    """Share of the stretch's wall time in which no device operation ran (%), or None
    where the device ran nothing (no card, or the profiler saw no device activity)."""
    busy, win = busy_s(profile), window_s(profile)
    if busy is None or not win:
        return None
    return 100.0 * (1.0 - busy / win)


def breakdown(profile, top: int = 10):
    """{"device_ops": [[name, s]] the device operations that took most time,
    "idle_gaps": [[name, s]] the longest idle gaps, each named by the innermost host
    operator running at its middle}, or None where the device ran nothing."""
    busy = busy_intervals(profile)
    if not busy:
        return None
    by_name = {}
    for name, t0, t1 in profile["device"]:
        name = name[:NAME]
        by_name[name] = by_name.get(name, 0.0) + (t1 - t0) / 1e6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    w0, w1 = profile["window"]
    edges = [w0] + [x for t0, t1 in busy for x in (t0, t1)] + [w1]
    gaps = sorted(((edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), key=lambda g: g[0] - g[1])[:top]
    named = []
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        inside = [(t0, name) for name, t0, t1 in profile["cpu"] if t0 <= mid <= t1]
        named.append([max(inside)[1] if inside else "host outside any operator",
                      (g1 - g0) / 1e6])
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": named}
