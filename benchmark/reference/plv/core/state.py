"""Filter state container (port of plviwo_tpu/core/state.py), batch-first.

Every field carries a leading sequence axis B: `q` is (B, 4), `cov` is
(B, D, D), `time` is (B,).  Floating fields are float64, masks bool,
`slam_id` int32.  The layout (`core.layout.StateLayout`, the port's copy of
the JAX package's plain dataclass) fixes D and the block offsets.

Entry points that make tensors (`make_state`, `FilterState.from_numpy`)
put them on the card unless the caller asks for another device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import lie
from .layout import StateLayout

F64 = torch.float64
CUDA = torch.device("cuda")


def checked_device(device) -> torch.device:
    """`device` as a torch.device; raises for a CUDA device where there is
    no card (callers pass device="cpu" to run on the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device}: no CUDA card here; pass device='cpu'")
    return device

# Unbatched rank of each array field, as the JAX FilterState holds it.
_RANK = {
    "time": 0, "q": 1, "p": 1, "v": 1, "bg": 1, "ba": 1,
    "q_fej": 1, "p_fej": 1, "v_fej": 1, "bg_fej": 1, "ba_fej": 1,
    "clone_q": 2, "clone_p": 2, "clone_q_fej": 2, "clone_p_fej": 2,
    "clone_t": 1, "clone_valid": 1, "clone_keyframe": 1,
    "cam_dt": 1, "cam_q": 2, "cam_p": 2, "cam_k": 2,
    "wheel_dt": 0, "wheel_q": 1, "wheel_p": 1, "wheel_k": 1,
    "gps_dt": 1, "gps_p": 2, "wtoe_th": 0, "wtoe_p": 1,
    "slam_p": 2, "slam_p_fej": 2, "slam_valid": 1, "slam_id": 1,
    "cov": 2,
}
_BOOL = ("clone_valid", "clone_keyframe", "slam_valid")
FIELDS = tuple(_RANK)  # the tensor fields, in the JAX FilterState's order


@dataclasses.dataclass
class FilterState:
    time: torch.Tensor
    q: torch.Tensor  # q_GtoI JPL
    p: torch.Tensor  # p_IinG
    v: torch.Tensor
    bg: torch.Tensor
    ba: torch.Tensor
    q_fej: torch.Tensor
    p_fej: torch.Tensor
    v_fej: torch.Tensor
    bg_fej: torch.Tensor
    ba_fej: torch.Tensor
    clone_q: torch.Tensor  # (B,C,4)
    clone_p: torch.Tensor  # (B,C,3)
    clone_q_fej: torch.Tensor
    clone_p_fej: torch.Tensor
    clone_t: torch.Tensor  # (B,C), +inf when invalid
    clone_valid: torch.Tensor  # (B,C) bool
    clone_keyframe: torch.Tensor  # (B,C) bool
    cam_dt: torch.Tensor
    cam_q: torch.Tensor  # (B,ncam,4) q_ItoC
    cam_p: torch.Tensor  # (B,ncam,3) p_IinC
    cam_k: torch.Tensor  # (B,ncam,8)
    wheel_dt: torch.Tensor
    wheel_q: torch.Tensor
    wheel_p: torch.Tensor
    wheel_k: torch.Tensor
    gps_dt: torch.Tensor
    gps_p: torch.Tensor
    wtoe_th: torch.Tensor
    wtoe_p: torch.Tensor
    slam_p: torch.Tensor
    slam_p_fej: torch.Tensor
    slam_valid: torch.Tensor
    slam_id: torch.Tensor
    cov: torch.Tensor  # (B,D,D)
    layout: StateLayout

    def replace(self, **kw) -> "FilterState":
        return dataclasses.replace(self, **kw)

    @property
    def batch(self) -> int:
        return self.cov.shape[0]

    @classmethod
    def from_numpy(cls, arrays, layout: StateLayout, device=CUDA) -> "FilterState":
        """Build a batch-first state from the JAX FilterState's fields.

        arrays: one dict {field: numpy array} of an unbatched JAX state
        (gives B = 1), or a list of such dicts (stacked to B = len(list))."""
        device = checked_device(device)
        if isinstance(arrays, dict):
            arrays = [arrays]
        items = {n: np.stack([np.asarray(a[n]) for a in arrays]) for n in _RANK}
        out = {}
        for n, a in items.items():
            if a.ndim != _RANK[n] + 1:
                raise ValueError(f"field {n}: rank {a.ndim}, want {_RANK[n] + 1}")
            if n in _BOOL:
                dt = torch.bool
            elif n == "slam_id":
                dt = torch.int32
            else:
                dt = F64
            out[n] = torch.tensor(a, device=device).to(dt)
        return cls(layout=layout, **out)

    def to_numpy(self, b: int = 0) -> dict:
        """Fields of sequence b as numpy arrays, without the B axis (the
        shapes of the JAX FilterState)."""
        return {n: getattr(self, n)[b].detach().cpu().numpy() for n in _RANK}


def make_state(layout: StateLayout, priors: dict | None = None, batch: int = 1,
               device=CUDA) -> FilterState:
    """Fresh state with identity orientation and a diagonal prior covariance
    (port of plviwo_tpu.core.state.make_state), repeated over B sequences."""
    C, ncam, ngps, S = layout.n_clones, layout.n_cams, layout.n_gps, layout.max_slam
    pr = {k: 0.0 for k in ("imu_th", "imu_p", "imu_v", "imu_bg", "imu_ba",
                           "cam_dt", "cam_ext", "cam_int", "wheel_dt",
                           "wheel_ext", "wheel_int", "gps_dt", "gps_ext")}
    if priors:
        pr.update(priors)

    diag = np.zeros(layout.dim)
    diag[layout.IMU_TH:layout.IMU_TH + 3] = pr["imu_th"] ** 2
    diag[layout.IMU_P:layout.IMU_P + 3] = pr["imu_p"] ** 2
    diag[layout.IMU_V:layout.IMU_V + 3] = pr["imu_v"] ** 2
    diag[layout.IMU_BG:layout.IMU_BG + 3] = pr["imu_bg"] ** 2
    diag[layout.IMU_BA:layout.IMU_BA + 3] = pr["imu_ba"] ** 2
    for i in range(ncam):
        diag[layout.cam_dt(i)] = pr["cam_dt"] ** 2
        diag[layout.cam_ext(i):layout.cam_ext(i) + 6] = pr["cam_ext"] ** 2
        diag[layout.cam_int(i):layout.cam_int(i) + 8] = pr["cam_int"] ** 2
    if layout.use_wheel:
        diag[layout.wheel_dt] = pr["wheel_dt"] ** 2
        diag[layout.wheel_ext:layout.wheel_ext + 6] = pr["wheel_ext"] ** 2
        diag[layout.wheel_int:layout.wheel_int + 3] = pr["wheel_int"] ** 2
    for i in range(ngps):
        diag[layout.gps_dt(i)] = pr["gps_dt"] ** 2
        diag[layout.gps_ext(i):layout.gps_ext(i) + 3] = pr["gps_ext"] ** 2

    qid = np.array([0.0, 0.0, 0.0, 1.0])
    z3 = np.zeros(3)
    one = {
        "time": np.array(-np.inf),
        "q": qid, "p": z3, "v": z3, "bg": z3, "ba": z3,
        "q_fej": qid, "p_fej": z3, "v_fej": z3, "bg_fej": z3, "ba_fej": z3,
        "clone_q": np.tile(qid, (C, 1)), "clone_p": np.zeros((C, 3)),
        "clone_q_fej": np.tile(qid, (C, 1)), "clone_p_fej": np.zeros((C, 3)),
        "clone_t": np.full(C, np.inf),
        "clone_valid": np.zeros(C, dtype=bool),
        "clone_keyframe": np.zeros(C, dtype=bool),
        "cam_dt": np.zeros(ncam), "cam_q": np.tile(qid, (ncam, 1)),
        "cam_p": np.zeros((ncam, 3)),
        "cam_k": np.tile(np.array([1.0, 1.0, 0, 0, 0, 0, 0, 0]), (ncam, 1)),
        "wheel_dt": np.array(0.0), "wheel_q": qid, "wheel_p": z3,
        "wheel_k": np.array([1.0, 1.0, 1.0]),
        "gps_dt": np.zeros(ngps), "gps_p": np.zeros((ngps, 3)),
        "wtoe_th": np.array(0.0), "wtoe_p": z3,
        "slam_p": np.zeros((S, 3)), "slam_p_fej": np.zeros((S, 3)),
        "slam_valid": np.zeros(S, dtype=bool),
        "slam_id": np.full(S, -1, dtype=np.int32),
        "cov": np.diag(diag),
    }
    return FilterState.from_numpy([one] * batch, layout, device)


def rot_gtoi(state: FilterState):
    """(B,3,3) R_GtoI of the IMU orientation."""
    return lie.quat_2_rot(state.q)


def oldest_clone_slot(state: FilterState):
    """(B,) slot of the oldest valid, non-keyframe clone (+inf-masked argmin,
    first index among ties)."""
    t = torch.where(state.clone_valid & ~state.clone_keyframe, state.clone_t, torch.inf)
    return torch.argmin(t, dim=-1)


def newest_clone_slot(state: FilterState):
    """(B,) slot of the newest valid clone (first index among ties)."""
    t = torch.where(state.clone_valid, state.clone_t, -torch.inf)
    return torch.argmax(t, dim=-1)


def free_clone_slot(state: FilterState):
    """(B,) slot of the first invalid clone."""
    return torch.argmin(state.clone_valid.to(torch.int8), dim=-1)


def num_clones(state: FilterState):
    """(B,) number of valid clones."""
    return torch.sum(state.clone_valid, dim=-1)
