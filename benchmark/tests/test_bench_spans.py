"""The readers of the program's stage spans: spans grouped per frame by their root span,
the three filter stages summed, the median over the frames, and nothing read where the
run was not traced, the program recorded no spans or a stage has no device time."""

import sys
from types import SimpleNamespace

import pytest

from benchmark import run
from benchmark.metrics import _spans


def reader(name):
    return run.load_module(run.BENCH / "metrics" / f"{name}.py", "metrics").read


# a traced run's profile, as `trace.profile` returns it; the span readers only ask that
# there is one
PROFILE = {"window": (0.0, 100.0), "device": [("a", 10.0, 30.0)], "cpu": []}


def _span(sid, parent, name, device_ms):
    return SimpleNamespace(id=sid, parent=parent, name=name, device_ms=device_ms)


def _frame(first, parent, front, lines, time_update, rows, update):
    """A `frame` span (id `first`) and its stages, as `core/frame.fused_frame` nests them."""
    f = first
    return [_span(f, parent, "frame", 1e3),
            _span(f + 1, f, "frame.time_update", time_update),
            _span(f + 2, f, "frame.frontend", front),
            _span(f + 3, f + 2, "frame.frontend.lines", lines),
            _span(f + 4, f, "frame.rows", rows),
            _span(f + 5, f, "frame.update", update)]


FLEET = (_frame(0, None, 10.0, 4.0, 1.0, 2.0, 3.0) + _frame(6, None, 30.0, 5.0, 2.0, 2.0, 2.0)
         + _frame(12, None, 20.0, 6.0, 4.0, 4.0, 4.0))
# the live driver: an image without a frame (a frame it could not serve), then two frames
VEHICLE = ([_span(100, None, "image", 5.0)]
           + [_span(101, None, "image", 50.0)] + _frame(102, 101, 7.0, 1.0, 1.0, 1.0, 1.0)
           + [_span(108, None, "image", 60.0)] + _frame(109, 108, 9.0, 2.0, 2.0, 3.0, 4.0))
TRACKS = [_span(200, None, "track", 80.0), _span(201, 200, "track.cam", 30.0),
          _span(202, 200, "track.line", 5.0), _span(203, None, "track", 90.0),
          _span(204, 203, "track.cam", 40.0)]


@pytest.fixture
def program_spans(monkeypatch):
    """Puts a stand-in for the program's timing module, holding the given spans, where
    the readers look for it."""
    def put(spans):
        monkeypatch.setitem(sys.modules, _spans.MODULE, SimpleNamespace(spans=lambda: spans))
    return put


def test_spans_grouped_per_root_frame():
    assert _spans.per_root(FLEET, "frame", ("frame.frontend",)) == [10.0, 30.0, 20.0]
    assert _spans.per_root(FLEET, "frame", _spans.FILTER) == [6.0, 6.0, 12.0]
    assert _spans.per_root(VEHICLE, "image", ("frame.frontend",)) == [7.0, 9.0]
    assert _spans.per_root(VEHICLE, "frame", ("frame.frontend",)) == [], "frames under images"
    assert _spans.per_root(TRACKS, "track", ("track.cam",)) == [30.0, 40.0]


@pytest.mark.parametrize("name, spans, want", [
    ("frontend_ms.fleet", FLEET, 20.0),
    ("line_frontend_ms.fleet", FLEET, 5.0),
    ("filter_ms.fleet", FLEET, 6.0),
    ("frontend_ms.vehicle_images", VEHICLE, 8.0),
    ("filter_ms.vehicle_images", VEHICLE, 6.0),
    ("cam_update_ms.vehicle_kaist", TRACKS, 35.0),
])
def test_span_readers_take_the_median_per_frame(program_spans, name, spans, want):
    program_spans(spans)
    assert reader(name)({"profile": PROFILE}) == pytest.approx(want)
    assert reader(name)({}) is None, "an untraced run reads nothing"


def test_span_readers_read_nothing_without_device_time(program_spans, monkeypatch):
    program_spans([])
    assert reader("frontend_ms.fleet")({"profile": PROFILE}) is None
    program_spans(_frame(0, None, None, 1.0, 1.0, None, 1.0))  # as on the CPU, two stages
    assert reader("frontend_ms.fleet")({"profile": PROFILE}) is None
    assert reader("line_frontend_ms.fleet")({"profile": PROFILE}) == 1.0
    assert reader("filter_ms.fleet")({"profile": PROFILE}) is None, "time_update read, rows not"
    monkeypatch.setitem(sys.modules, _spans.MODULE, SimpleNamespace())  # a module without spans
    assert reader("cam_update_ms.vehicle_kaist")({"profile": PROFILE}) is None
    monkeypatch.delitem(sys.modules, _spans.MODULE)
    assert reader("filter_ms.vehicle_images")({"profile": PROFILE}) is None
