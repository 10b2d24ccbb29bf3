"""Shared fixtures of the benchmark's own tests (CPU; the card's tests carry `cuda`)."""

import pytest
import torch

# tiny sizes of each cell for a CPU pass of its driver
TINY_CAM = {"width": 320, "height": 140,
            "intrinsics": [204.2, 202.9, 152.1, 65.9, -0.05614303, 0.13952563, -0.00121559,
                           -0.00097281]}
TINY = {
    "fleet_plwg": {"workload": {"batch": 2, "episode_frames": 5, "warm_frames": 2,
                                "check_frames": 2, "trace_from": 2, "trace_frames": 1},
                   "config": {"sim": TINY_CAM}},
    "vehicle_images": {"workload": {"episode_frames": 6, "warm_frames": 2, "check_frames": 2,
                                    "sim_duration": 3.0, "trace_from": 2, "trace_frames": 2},
                       "config": {"sim": TINY_CAM}},
    "vehicle_kaist": {"workload": {"vehicles": 1, "warm_frames": 3, "trace_from": 2,
                                   "trace_frames": 2},
                      "config": {"sim": {"duration": 1.5}}},
}


@pytest.fixture
def card():
    """The CUDA device; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return "cuda"
