"""The port's stage spans (`plviwo_tpu_torch/utils/timing.span`): they record
only under a profiler, change no output, nest as the frame's and the
drivers' stages do, and appear in the profiler's trace on its clock.

CPU only: `device_ms` is None here; the card's numbers come from the
benchmark's traced runs."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke
from plviwo_tpu_torch import examples, profile_step
from plviwo_tpu_torch.config.options import EstimatorOptions
from plviwo_tpu_torch.core import frame
from plviwo_tpu_torch.core.system import VioSystem
from plviwo_tpu_torch.sim.simulator import SimConfig, Simulator
from plviwo_tpu_torch.utils import timing

FRAME_TREE = {"frame": None, "frame.time_update": "frame", "frame.frontend": "frame",
              "frame.frontend.lines": "frame.frontend", "frame.rows": "frame",
              "frame.update": "frame"}
TRACK_TREE = {"track": None, "track.propagate": "track", "track.cam": "track",
              "track.line": "track", "track.wheel": "track", "track.update": "track"}


@pytest.fixture
def fresh_spans():
    timing.spans(clear=True)
    yield
    timing.spans(clear=True)


@pytest.fixture(scope="module")
def frame_inputs():
    """tests/test_torch_fused_frame.py's scene (its simulator settings) as
    `profile_step --frame` builds it, at B = 1: the seeded state and track
    state, and two frames of points, lines, wheel and GPS."""
    frames, state, ts, consts = profile_step._frame_setup(1, 2, "cpu")
    return state, ts, [profile_step._frame_args(f, consts) for f in frames]


def _frames(state, ts, fs):
    """fused_frame over the frames fs from (state, ts); every output."""
    outs = []
    for args, kw in fs:
        state, ts, m = frame.fused_frame(state, ts, *args, **kw, **profile_step.FRAME_KW)
        outs.append((state, ts, m))
    return outs


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _tree(records, root):
    """The spans under each root span named `root`: [{name: record}]."""
    by_id = {r.id: r for r in records}

    def top(r):
        while r.parent is not None:
            r = by_id[r.parent]
        return r

    trees = {}
    for r in records:
        t = top(r)
        if t.name == root:
            trees.setdefault(t.id, {})[r.name] = r
    return list(trees.values())


def _check_tree(tree, want):
    """tree's names are want's keys, each span under the parent want names,
    inside it on the host clock, with no device time on the CPU."""
    assert set(tree) == set(want)
    for name, parent in want.items():
        r = tree[name]
        assert r.t0_ns <= r.t1_ns and r.device_ms is None
        if parent is None:
            continue
        p = tree[parent]
        assert r.parent == p.id, (name, parent)
        assert p.t0_ns <= r.t0_ns and r.t1_ns <= p.t1_ns, name


def test_no_profiler_records_no_span(frame_inputs, fresh_spans):
    assert timing.span("frame") is timing.span("track"), "one shared do-nothing context"
    _frames(*frame_inputs)
    assert timing.spans() == []


def test_fused_frame_is_bit_identical_under_the_profiler(frame_inputs, fresh_spans):
    plain = _frames(*frame_inputs)
    with _cpu_profile():
        traced = _frames(*frame_inputs)
    assert len(timing.spans()) == 2 * len(FRAME_TREE)
    for (s0, t0, m0), (s1, t1, m1) in zip(plain, traced):
        for obj0, obj1 in ((s0, s1), (t0, t1)):
            for name, x in vars(obj0).items():
                if isinstance(x, torch.Tensor):
                    assert torch.equal(x, getattr(obj1, name)), name
        assert m0.keys() == m1.keys()
        assert all(torch.equal(m0[k], m1[k]) for k in m0)


def test_frame_spans_nest_and_land_in_the_trace(frame_inputs, fresh_spans, tmp_path):
    state, ts, fs = frame_inputs
    with _cpu_profile() as prof:
        _frames(state, ts, fs[:1])
    records = timing.spans()
    (tree,) = _tree(records, "frame")
    _check_tree(tree, FRAME_TREE)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        trace = json.load(f)
    base_us = trace["baseTimeNanoseconds"] / 1e3
    notes = {}
    for e in trace["traceEvents"]:
        if e.get("cat") == "user_annotation":
            notes.setdefault(e["name"], []).append(e["ts"] + base_us)
    for r in records:
        (start,) = notes[r.name]
        assert abs(start - r.t0_ns / 1e3) < 5e3, (r.name, start - r.t0_ns / 1e3)


def test_spans_clear():
    with _cpu_profile():
        with timing.span("a"):
            with timing.span("b"):
                pass
    got = timing.spans(clear=True)
    assert [(r.name, r.parent) for r in got] == [("a", None), ("b", got[0].id)]
    assert timing.spans() == []


def _feed_until_frames(system, events, n, feed=examples.feed):
    """Feed events until system has recorded n more poses; returns the rest."""
    n0 = len(system.traj)
    for i, (kind, args) in enumerate(events):
        feed(system, kind, args)
        if len(system.traj) >= n0 + n:
            return events[i + 1:]
    raise AssertionError("the events ran out")


def test_per_track_driver_spans(fresh_spans):
    sim = Simulator(SimConfig(duration=1.5, seed=3, sigma_pix=0.5, n_pts=45))
    o = chip_smoke.run_sim_options(EstimatorOptions(), wheel=True)
    o.cam.use_lines, o.cam.max_lines, o.cam.sigma_pix_line = True, 20, 2.0
    events = examples.track_events(sim, wheel=True, lines=True)
    s = VioSystem(o, device="cpu")
    examples.live_calibrate(s, sim, float(sim.imu_t[0]))
    events = _feed_until_frames(s, events, 4)
    with _cpu_profile():
        _feed_until_frames(s, events, 1)
    (tree,) = _tree(timing.spans(), "track")
    _check_tree(tree, TRACK_TREE)
    assert set(s.frame_timing) == {"propagate", "cam", "line", "wheel", "update", "frame"}
    assert all(v >= 0.0 for v in s.frame_timing.values())


def test_live_driver_spans(fresh_spans):
    sim = Simulator(SimConfig(duration=2.0, seed=3, n_landmarks=350, n_lines=40))
    o = examples.live_options(EstimatorOptions())
    t0 = 1.0
    events = examples.live_events(sim, t0, 4)
    s = VioSystem(o, device="cpu")
    examples.live_calibrate(s, sim, t0)
    events = _feed_until_frames(s, events, 2)
    with _cpu_profile():
        _feed_until_frames(s, events, 1)
    (tree,) = _tree(timing.spans(), "image")
    _check_tree(tree, dict({"image": None}, **{k: v or "image" for k, v in FRAME_TREE.items()}))
    assert set(s.frame_timing) == {"frame", "host", "gps"}
    assert np.isfinite(list(s.frame_timing.values())).all()
