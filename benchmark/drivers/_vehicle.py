"""The closed loop of the vehicle cells: one driver (`core/system.VioSystem`) at B = 1,
fed event by event, the next event handed in when the call returns.

A frame's latency runs from the call that hands the driver the last input the frame
waits for (the image, or the IMU sample that covers it) to that call's return with the
frame's pose recorded: the calls after which the driver's trajectory has grown.
"""

from __future__ import annotations

import time

import torch

from .. import trace as tr
from ..run import CACHE

FEED = {"gps": "feed_gps_enu", "wheel": "feed_wheel", "image": "feed_image",
        "camera": "feed_camera", "imu": "feed_imu"}


def gps_initialized(system) -> bool:
    """Whether a driver's GPS has found its ENU frame (printed only)."""
    return bool(getattr(getattr(system, "gps", None), "initialized", False))


class Loop:
    """Replays a list of episodes [(events, new_system)] back to back, each from a fresh
    driver, and keeps per frame its latency (ms) and the driver's `frame_timing`.
    `pos` is the number of frames the current episode has recorded.  `after_frame(system)`
    runs after every call that recorded a pose; `on_episode_end` gets (episode index,
    system) when an episode's events run out."""

    def __init__(self, episodes, after_frame=None, on_episode_end=None):
        self.episodes, self.after_frame, self.on_episode_end = episodes, after_frame, on_episode_end
        self.k, self.ei, self.pos = 0, 0, 0
        self.system = episodes[0][1]()
        self.latencies, self.timing, self.frames, self.replays = [], [], 0, 0

    def restart(self, k=0):
        """Start episode k afresh."""
        self.k, self.ei, self.pos = k, 0, 0
        self.system = self.episodes[k][1]()

    def step(self) -> int:
        """Feed one event; returns the frames it recorded."""
        events, _ = self.episodes[self.k]
        kind, args = events[self.ei]
        s = self.system
        n = len(s.traj)
        t0 = time.perf_counter()
        getattr(s, FEED[kind])(*args)
        dt = time.perf_counter() - t0
        grown = len(s.traj) - n
        if grown:
            self.latencies.extend([1e3 * dt] * grown)
            self.timing.append(dict(s.frame_timing))
            self.frames += grown
            self.pos += grown
            if self.after_frame is not None:
                self.after_frame(s)
        self.ei += 1
        if self.ei == len(events):
            if self.on_episode_end is not None:
                self.on_episode_end(self.k, s)
            self.replays += 1
            self.restart((self.k + 1) % len(self.episodes))
        return grown

    def frames_until(self, n_frames=None, deadline=None) -> int:
        """Feed events until n_frames more frames are recorded, or until the host clock
        passes `deadline`; returns the frames recorded.  A whole round of the episodes
        that records no frame is an error."""
        start, r0 = self.frames, self.replays
        while True:
            self.step()
            if n_frames is not None and self.frames - start >= n_frames:
                break
            if deadline is not None and time.perf_counter() >= deadline:
                break
            if self.frames == start and self.replays - r0 > len(self.episodes):
                raise RuntimeError("the driver recorded no frame over a whole round of episodes")
        return self.frames - start

    def to_position(self, position: int):
        """Feed events until the current episode has recorded `position` frames, going on
        into the next episode where this one is already past it.  A position that no
        episode reaches is an error."""
        r = self.replays
        if self.pos > position:
            while self.replays == r:
                self.step()
        while self.pos < position:
            self.step()
            if self.replays - r > len(self.episodes) + 1:
                raise RuntimeError(f"no episode records {position} frames")


def window(ctx, loop: Loop, rec: dict, checked=lambda: True):
    """The measured window: frames until `--seconds` have passed.  With --trace 1 it
    first runs to the episode position `trace_from`, where the clone window and the
    tracks have filled, profiles `trace_frames` frames from there, and counts operators
    and synchronizing calls over the same positions of the next episode.  Fills rec with
    the window's latencies, frames and device memory peak; then runs on, outside the
    window, until `checked()` or for one more round of the episodes at most."""
    w = ctx.workload
    ctx.setup_done()
    t0 = time.perf_counter()
    loop.latencies, loop.timing, loop.frames, loop.replays = [], [], 0, 0
    if ctx.trace:
        first, k = int(w["trace_from"]), int(w["trace_frames"])
        loop.to_position(first)
        ep0 = loop.replays
        rec["profile"] = tr.profile(lambda: rec.update(traced=loop.frames_until(k)),
                                    CACHE / "trace" / f"{ctx.cell}.json")
        loop.to_position(first)
        ep1 = loop.replays
        box = {}
        rec["host_ops"], rec["syncs"] = tr.counts(lambda: box.update(n=loop.frames_until(k)))
        rec["host_ops_frames"] = rec["sync_frames"] = box["n"]
        ctx.say(f"traced: frames {first}-{first + rec['traced'] - 1} of the window's episode "
                f"{ep0} profiled; frames {first}-{first + box['n'] - 1} of its episode {ep1} "
                "counted (episodes numbered from 0)")
    loop.frames_until(deadline=t0 + ctx.seconds)
    if torch.device(ctx.device).type == "cuda":
        torch.cuda.synchronize()
    rec["window_s"] = time.perf_counter() - t0
    rec["latencies_ms"] = list(loop.latencies)
    rec["frame_timing"] = list(loop.timing)
    rec["attempted"] = rec["completed"] = loop.frames
    # after the window, until the check has its frames (a traced window, or a window
    # shorter than an episode, may not have reached them), one round of episodes at most
    r = loop.replays
    while not checked() and loop.replays <= r + len(loop.episodes):
        loop.step()
    rec["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(ctx.device)
                                if torch.device(ctx.device).type == "cuda" else 0)
    ctx.say(f"{ctx.cell}: {loop.frames} frames in {rec['window_s']:.3f} s over "
            f"{loop.replays} finished episodes; p95 over {len(loop.latencies)} samples; "
            f"program {ctx.program.name}")
