"""The traffic generators: the same seed gives the same inputs, another seed others."""

import numpy as np
import torch

from benchmark.gen import scenarios
from benchmark.gen.simulator import SimConfig, Simulator

BIG = 2**31 + 12345  # the driver's seeds exceed 32 signed bits


def test_sub_seeds_are_deterministic_and_take_large_seeds():
    assert scenarios.sub_seeds(BIG, 3) == scenarios.sub_seeds(BIG, 3)
    assert scenarios.sub_seeds(BIG, 3) != scenarios.sub_seeds(BIG + 1, 3)
    assert all(0 <= s < 2**32 for s in scenarios.sub_seeds(2**40, 4))


def test_wheel_samples_equal_the_simulators_one_by_one():
    a, b = Simulator(SimConfig(duration=3.0, seed=7)), Simulator(SimConfig(duration=3.0, seed=7))
    ts = a.wheel_times()[:40]
    one = np.array([a.wheel_sample(t) for t in ts])
    np.testing.assert_allclose(scenarios.wheel_samples(b, ts), one, rtol=0, atol=1e-12)


def _events_equal(x, y):
    assert len(x) == len(y)
    for (k1, a1), (k2, a2) in zip(x, y):
        assert k1 == k2
        for u, v in zip(a1, a2):
            np.testing.assert_array_equal(np.asarray(u), np.asarray(v))


def test_track_events_from_the_seed():
    sim = {"duration": 1.5, "n_pts": 150}
    ev = [scenarios.track_events(scenarios.simulator(sim, s)) for s in (BIG, BIG, BIG + 1)]
    _events_equal(ev[0], ev[1])
    cams = [[a for k, a in e if k == "camera"] for e in ev]
    assert not np.array_equal(cams[0][0][2], cams[2][0][2])
    assert {k for k, _ in ev[0]} == {"camera", "wheel", "imu"}


def test_track_events_with_gps_fixes_in_the_enu_frame():
    sim = {"duration": 2.5, "n_pts": 150}
    enu = scenarios.enu_frame(0.4, [40.0, -20.0, 1.0])
    ev = [scenarios.track_events(scenarios.simulator(sim, s), enu=enu) for s in (BIG, BIG)]
    _events_equal(ev[0], ev[1])
    fixes = [a for k, a in ev[0] if k == "gps"]
    assert len(fixes) == 2 and np.linalg.norm(fixes[0][1]) > 20.0, "in the offset frame"
    imu_t = [a[0] for k, a in ev[0] if k == "imu"]
    first = next(i for i, (k, _) in enumerate(ev[0]) if k == "gps")
    assert fixes[0][0] <= next(a[0] for k, a in ev[0][first:] if k == "imu")
    assert fixes[0][0] > imu_t[0]


def test_live_events_from_the_seed():
    sim = {"duration": 2.0, "width": 160, "height": 120}
    enu = scenarios.enu_frame(0.4, [40.0, -20.0, 1.0])
    ev = [scenarios.live_events(scenarios.simulator(sim, s), 1.0, 4, enu) for s in (5, 5)]
    _events_equal(ev[0], ev[1])
    assert [k for k, _ in ev[0]].count("image") == 4 and ev[0][-1][0] == "imu"


def test_fleet_episode_from_the_seed():
    def episode(seed):
        sim = scenarios.simulator({"duration": 2.0, "width": 160, "height": 120}, seed)
        gen = torch.Generator().manual_seed(scenarios.sub_seeds(seed, 2)[1])
        return scenarios.fleet_episode(sim, 3, 4, 1.0, 0.1, gen, 2e-3, 4)

    a, b, c = episode(BIG), episode(BIG), episode(BIG + 1)
    for fa, fb in zip(a, b):
        assert torch.equal(fa["img"], fb["img"]) and torch.equal(fa["gps"][1], fb["gps"][1])
    assert not torch.equal(a[0]["img"], c[0]["img"])
    img = a[0]["img"]
    assert img.shape == (3, 120, 160) and img.dtype == torch.float32
    assert not torch.equal(img[0], img[1]), "each sequence has its own pixel noise"
    assert float(img.min()) >= 0.0 and float(img.max()) <= 1.0
