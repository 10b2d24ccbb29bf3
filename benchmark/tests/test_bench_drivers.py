"""A CPU pass of each driver's control flow at a tiny size (the program runs its plain
paths there), and the run's `correct` coming out false with the timed path broken
underneath: a step that returns its state unchanged, half of the batch left out, and an
answer altered where it is produced (a kernel's output, the frame's state or tracks, a
recorded pose); and the run coming out not correct, without hanging, where the program
stops calling its frame through the name the check binds."""

import dataclasses

import pytest
import torch

from benchmark import run
from benchmark.tests.conftest import TINY

import plviwo_tpu_torch.core.ekf as ekf
import plviwo_tpu_torch.core.frame as frame
import plviwo_tpu_torch.core.step as step
import plviwo_tpu_torch.core.system as system
import plviwo_tpu_torch.ops.lk_kernel as lk_kernel

SPEC = run.read_json(run.ROOT / "BENCHMARK.json")


def run_tiny(cell, trace=False, seconds=1.0):
    rec = run.run_cell(cell, 2**31 + 77, seconds, trace, "cpu", TINY[cell])
    out = run.result(rec, run.cell_metrics(SPEC, cell, trace), trace, {"platform": "cpu"})
    return rec, out


@pytest.mark.parametrize("cell", sorted(TINY))
def test_cell_runs_correct_on_the_cpu(cell):
    rec, out = run_tiny(cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert "setup_s" in out["metrics"]
    assert all(v["value"] > 0 for v in out["metrics"].values())
    assert list(out)[-1] == "checks"


def test_traced_run_reads_its_counts():
    rec, out = run_tiny("vehicle_kaist", trace=True)
    assert out["correct"]
    assert out["metrics"]["host_ops_per_frame.vehicle"]["value"] > 100
    assert "device_idle_pct.vehicle" not in out["metrics"], "no device trace on the CPU"


def _frame_fault(monkeypatch, make):
    """Bind the images-in frame, as both the fleet and the live driver call it, to make(real)."""
    real = frame.fused_frame
    monkeypatch.setattr(frame, "fused_frame", make(real))
    monkeypatch.setattr(system, "fused_frame", make(real))


def state_unchanged(monkeypatch):
    def make(real):
        return lambda state, ts, *a, **k: (state,) + tuple(real(state, ts, *a, **k)[1:])
    _frame_fault(monkeypatch, make)


def half_batch(monkeypatch):
    def make(real):
        def fault(state, ts, *a, **k):
            new, ts2, m = real(state, ts, *a, **k)
            keep = torch.arange(state.batch) >= state.batch // 2
            return frame._select(keep, state, new), ts2, m
        return fault
    _frame_fault(monkeypatch, make)


def gram_altered(monkeypatch):
    real = step.gram_gate

    def fault(*a):
        G, c, ok, chi2 = real(*a)
        return G + 1e-3 * torch.eye(G.shape[-1], dtype=G.dtype), c, ok, chi2
    monkeypatch.setattr(step, "gram_gate", fault)


def lk_altered(monkeypatch):
    real = lk_kernel.pyramidal_lk
    monkeypatch.setattr(lk_kernel, "pyramidal_lk",
                        lambda *a, **k: (lambda uv, ok: (uv + 2.0, ok))(*real(*a, **k)))


def pose_altered(monkeypatch):
    real = system.VioSystem._record_pose
    monkeypatch.setattr(system.VioSystem, "_record_pose",
                        lambda self, t, q, p: real(self, t, q, p + 1e-3))


def update_skipped(monkeypatch):
    monkeypatch.setattr(ekf, "update", lambda state, *a: state)


def position_altered(monkeypatch):
    def make(real):
        def fault(*a, **k):
            new, ts2, m = real(*a, **k)
            return new.replace(p=new.p + 1e-3), ts2, m
        return fault
    _frame_fault(monkeypatch, make)


def tracks_altered(monkeypatch):
    def make(real):
        def fault(*a, **k):
            new, ts2, m = real(*a, **k)
            return new, dataclasses.replace(ts2, uv=ts2.uv + 2.0), m
        return fault
    _frame_fault(monkeypatch, make)


FAULTS = [("fleet_plwg", state_unchanged), ("fleet_plwg", half_batch),
          ("fleet_plwg", gram_altered), ("fleet_plwg", lk_altered),
          ("fleet_plwg", position_altered), ("fleet_plwg", tracks_altered),
          ("vehicle_images", state_unchanged), ("vehicle_images", gram_altered),
          ("vehicle_images", lk_altered), ("vehicle_images", position_altered),
          ("vehicle_images", tracks_altered),
          ("vehicle_kaist", update_skipped), ("vehicle_kaist", pose_altered)]


@pytest.mark.parametrize("cell,fault", FAULTS, ids=[f"{c}-{f.__name__}" for c, f in FAULTS])
def test_a_broken_path_is_not_correct(monkeypatch, cell, fault):
    fault(monkeypatch)
    rec, out = run_tiny(cell)
    assert not out["correct"], out["checks"]


def test_a_frame_the_check_never_sees_is_not_correct(monkeypatch):
    """The live driver's frame called by another name than the one the check binds: the
    frames to check never fill, the run ends one episode after the window and reads not
    correct."""
    real_frame, real_process = frame.fused_frame, system.VioSystem._process_pending_images

    def process(self):
        bound = system.fused_frame
        system.fused_frame = real_frame
        try:
            return real_process(self)
        finally:
            system.fused_frame = bound
    monkeypatch.setattr(system.VioSystem, "_process_pending_images", process)
    rec, out = run_tiny("vehicle_images")
    assert not out["correct"], out["checks"]
    assert out["attempted"] > 0
