"""The readers' arithmetic: a rate over all work and all time, percentiles over every
sample, the device's idle share from a union of intervals, and the frozen roofline
counts against hand counts at small shapes."""

import numpy as np
import pytest
import torch

from benchmark import run
from benchmark.metrics import _device, _roofline


def reader(name):
    return run.load_module(run.BENCH / "metrics" / f"{name}.py", "metrics").read


def test_rate_is_all_frames_over_all_time():
    assert reader("frames_per_s")({"frames": 64 * 10, "window_s": 2.0}) == 320.0


@pytest.mark.parametrize("q", [50, 95])
def test_percentiles_over_every_sample(q):
    rng = np.random.default_rng(0)
    lat = list(rng.lognormal(4.8, 0.3, size=337))
    want = float(np.percentile(lat, q))
    assert reader(f"frame_p{q}_ms")({"latencies_ms": lat}) == pytest.approx(want, rel=0, abs=0)
    chunks = [float(np.percentile(lat[i:i + 50], q)) for i in range(0, 337, 50)]
    assert want != pytest.approx(float(np.median(chunks)), rel=1e-6)


PROFILE = {"window": (0.0, 100.0),
           "device": [("a", 10.0, 30.0), ("b", 20.0, 40.0), ("c", 50.0, 60.0), ("a", 95.0, 120.0)],
           "cpu": [("aten::item", 55.0, 99.0), ("aten::add", 70.0, 90.0)]}


def test_idle_share_is_the_union_of_device_intervals():
    assert _device.busy_s(PROFILE) == pytest.approx(45e-6)  # [10,40] + [50,60] + [95,100]
    assert _device.window_s(PROFILE) == pytest.approx(100e-6)
    assert reader("device_idle_pct.fleet")({"profile": PROFILE}) == pytest.approx(55.0)
    assert reader("device_idle_pct.vehicle")({"profile": dict(PROFILE, device=[])}) is None


def test_breakdown_orders_ops_and_names_gaps():
    bd = _device.breakdown(PROFILE)
    assert bd["device_ops"][0] == ["a", pytest.approx(45e-6)]
    # gaps: [0,10], [40,50], [60,95]; the longest is named by the innermost host op at 77.5
    assert bd["idle_gaps"][0] == ["aten::add", pytest.approx(35e-6)]
    assert [g[1] for g in bd["idle_gaps"]] == pytest.approx([35e-6, 10e-6, 10e-6])


def test_gram_work_against_a_hand_count():
    # one sequence, two features of M = 6 rows, D = 3, k = 3: feature 0 has 6 valid rows
    # (live: n >= k + 2) and is accepted, feature 1 has 2 (not live)
    rowmask = torch.tensor([[[True] * 6, [True, True] + [False] * 4]])
    ok = torch.tensor([[True, False]])
    n_bytes, ops = _roofline.gram_work(rowmask, ok, 3, 3)
    # valid rows x (D + k + 2) floats, mask bytes, cov in, M + 1 gates, G out, c out, flags
    assert n_bytes == 8 * 8 * 4 + 12 + 36 + 7 * 4 + 36 + 12 + 2 * 5
    n, p, D, k = 6, 3, 3, 3
    per_feature = (2 * n * (k + D + 1) + k * 4 * n * (k + D + 1) + p * D * D * 2
                   + p * (p + 1) * D + p**3 / 3 + p * p)
    assert ops == per_feature + p * (D + 1) * (D + 2)
    ms, by = _roofline.gram_bound((torch.zeros(1, 2, 6, 3), torch.zeros(1, 2, 6, 3), None,
                                   rowmask), ok)
    assert by == "bytes" and ms == pytest.approx(1e3 * n_bytes / _roofline.PEAK_BYTES)


def test_lk_bound_counts_each_valid_window_once():
    # one valid feature in the middle of a 32 x 32 image, one level, W = 3, no drift:
    # the template's tap region (W + 3)^2 in prev and the target patch (W + 4)^2 in next
    img = torch.rand(1, 32, 32)
    uv = torch.tensor([[[16.0, 16.0], [3.0, 3.0]]])
    valid = torch.tensor([[True, False]])
    ms, by = _roofline.lk_bound((img,), (img,), uv, valid, 1, 1, 2, 0.08, 0, 0)
    n_bytes = 4 * (6 * 6 + 7 * 7) + 1 * (9 + 17)
    W = 3
    ops = (W + 2) ** 2 * 9 + W * W * 10 + 2 * (W * W * 14 + 10) + W * W * 11
    assert by == "bytes"
    assert ms == pytest.approx(1e3 * max(n_bytes / _roofline.PEAK_BYTES, ops / _roofline.PEAK_F32))


def test_roofline_share_sums_bounds_over_kernel_time():
    dev = [("void lk_pyramid_kernel<3>(...)", 0.0, 40.0), ("other", 0.0, 1e6),
           ("void lk_pyramid_kernel<3>(...)", 100.0, 160.0)]
    assert _roofline.kernel_ms(dev, ("lk_pyramid",)) == pytest.approx(0.1)
    assert _roofline.roofline_pct([0.01, 0.005], 0.1) == pytest.approx(15.0)
    assert _roofline.roofline_pct([0.01], 0.0) is None


def test_counts_per_frame():
    assert reader("host_ops_per_frame.fleet")({"host_ops": 3000, "host_ops_frames": 3}) == 1000
    assert reader("syncs_per_frame.vehicle")({"syncs": 7, "sync_frames": 2}) == 3.5
    assert reader("cam_stage_ms.vehicle_kaist")(
        {"frame_timing": [{"cam": 1.0}, {"cam": 3.0}, {"cam": 2.0}]}) == 2.0
