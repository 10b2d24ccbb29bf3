"""Filter checkpoint and resume (port of plviwo_tpu/utils/checkpoint.py).

The reference has none (SURVEY.md 5.4: recovery = rerun the bag).  The
whole live driver serializes to one pickle: the filter state and every
host-side field of `VioSystem` (feature and line databases, buffers,
pending frames, updater bookkeeping, the host mirrors of the clone ring and
the SLAM slots, the ZUPT bias mirror, the images-in tracker state, the
stats and counters), so a replay can stop and go on as if it had never
stopped.  Tensors go through numpy; on load they return to the device the
caller names (the card unless `device="cpu"`), the ones that lived on the
system's device there, the others on the CPU.  The C++ feature store
(`native.py`) cannot be pickled: load builds a new one and feeds it the
saved tracks' camera-0 observations, which is what it held.  Objects the
caller keeps beside the system (a tracker, the driver's own counters) ride
along as `extra`.
"""

from __future__ import annotations

import contextvars
import io
import pickle

import numpy as np
import torch

from ..core.state import CUDA, checked_device

# fields rebuilt by the new system rather than restored
_REBUILT = ("device", "fdb_native", "viz")
_LOAD_DEVICE = contextvars.ContextVar("load_device")


def _tensor(arr, dtype: str, on_device: bool):
    t = torch.from_numpy(arr).to(getattr(torch, dtype))
    return t.to(_LOAD_DEVICE.get()) if on_device else t


def _device():
    return _LOAD_DEVICE.get()


class _Pickler(pickle.Pickler):
    """Tensors as numpy arrays (their dtype and whether they lived on the
    system's device kept), the system's device as the load device."""

    def __init__(self, f, device):
        super().__init__(f, protocol=pickle.HIGHEST_PROTOCOL)
        self.device = device

    def reducer_override(self, obj):
        if isinstance(obj, torch.Tensor):
            return _tensor, (obj.detach().cpu().numpy(), str(obj.dtype).split(".")[1],
                             obj.device == self.device)
        if isinstance(obj, torch.device) and obj == self.device:
            return _device, ()
        return NotImplemented


def save_checkpoint(path: str, system, extra=None):
    """Snapshot a VioSystem to `path` (pickle), with `extra`, any picklable
    objects the caller keeps beside it (their tensors too go through
    numpy)."""
    fields = {k: v for k, v in vars(system).items() if k not in _REBUILT}
    buf = io.BytesIO()
    _Pickler(buf, system.device).dump({"opts": system.opts, "fields": fields,
                                       "extra": extra})
    with open(path, "wb") as f:
        f.write(buf.getvalue())


def load_checkpoint(path: str, device=CUDA, extra: bool = False):
    """Restore a VioSystem from `path` onto `device` (the card unless the
    caller passes "cpu").  With extra=True returns (system, extra)."""
    from ..core.system import VioSystem

    dev = checked_device(device)
    token = _LOAD_DEVICE.set(dev)
    try:
        with open(path, "rb") as f:
            blob = pickle.load(f)
    finally:
        _LOAD_DEVICE.reset(token)
    system = VioSystem(blob["opts"], device=dev)
    vars(system).update(blob["fields"])
    if system.fdb_native is not None:
        # the C++ store held the camera-0 observations of the Python store's tracks
        for fid, tr in system.fdb.tracks.items():
            for i, t in enumerate(tr.times):
                if tr.cam_of(i) == 0:
                    system.fdb_native.update_batch(np.array([fid]), t, tr.uvs[i][None],
                                                   tr.uvns[i][None])
    return (system, blob["extra"]) if extra else system
