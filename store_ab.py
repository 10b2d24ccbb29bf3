"""A/B of the per-track driver's MSCKF candidate store: the C++ store
(`plviwo_tpu_torch/native.py`, which `VioSystem` takes wherever the library
builds) against the Python `FeatureDatabase` selection, on chip_smoke.py's
per-track phases 16-26 (ZUPT, phase 25, reads no store and is left out).

Run from the repository root on a CUDA card:
  python3 store_ab.py
Each phase runs four times, in turns native, python, python, native; a
python run builds its systems as where the library cannot build
(`native.available` reads False while it runs).  Each run keeps the phase's
own gates.  Prints one JSON line per phase: per store and run, for each
system the phase drives, the RMSE or ATE, the frame latency p50 / p90
(`frame_timing["frame"]`, host clock), syncs a frame and the store taken;
then the card's name and power limit.  Imports no JAX.
"""

from __future__ import annotations

import contextlib
import io
import json
import sys

import chip_smoke as cs

PHASES = {  # name: (chip_smoke phase, takes the device)
    "mono": (cs.phase_track_mono, True),  # 16
    "kaist": (cs.phase_track_kaist, True),  # 17
    "run_sim": (cs.phase_track_stereo, False),  # 18
    "orders": (cs.phase_track_orders, True),  # 19
    "lines": (cs.phase_track_lines, True),  # 20
    "kaist_lines": (cs.phase_track_kaist_lines, True),  # 21
    "slam": (cs.phase_track_slam, True),  # 22
    "cpi": (cs.phase_cpi, True),  # 23
    "auto_init": (cs.phase_auto_init, True),  # 24
    "host_tracker": (cs.phase_host_tracker, True),  # 26
}
KEYS = ("rmse", "ate", "ate_rmse_m", "p50_ms", "p90_ms", "syncs_per_frame", "feature_store")


def readings(out, path=""):
    """{system: its readings} from a phase's result: every dict in it that
    holds a latency or an accuracy, by its path of keys."""
    if not isinstance(out, dict):
        return {}
    got = {k: out[k] for k in KEYS if k in out and not isinstance(out[k], dict)}
    found = {path or "-": got} if got else {}
    for k, v in out.items():
        if isinstance(v, dict) and k not in ("stages", "launches", "lk"):
            found.update(readings(v, f"{path}.{k}" if path else str(k)))
    return found


def run(name, store, dev):
    from plviwo_tpu_torch import native

    fn, takes_dev = PHASES[name]
    real = native.available
    if store == "python":
        native.available = lambda: False
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            out = fn(dev) if takes_dev else fn()
        failed = None
    except AssertionError as e:
        out, failed = {}, str(e)
    finally:
        native.available = real
    return {"store": store, "failed": failed, "systems": readings(out)}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("store_ab: torch.cuda is not available; this script needs a CUDA card",
              file=sys.stderr)
        return 2
    from plviwo_tpu_torch import native

    if not native.available():
        print("store_ab: the native library does not build here", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    for name in PHASES:
        runs = [run(name, store, dev) for store in ("native", "python", "python", "native")]
        print(json.dumps({"phase": name, "runs": runs}))
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
