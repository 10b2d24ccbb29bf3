"""The comparisons that decide `correct`: the program's outputs against the frozen plain
reference (`reference/plv`), which imports nothing of the program.

- `frame_gaps`: one images-in frame.  The reference runs `fused_frame` from the same
  inputs and the same pre-frame state (the program's, copied into the reference's own
  classes), with TF32 off, and the gaps are read between the two outputs.
- `call_gaps`: the two kernels' outputs in a kept frame against their plain versions
  (`reference/plv/ops`) on the same arguments, TF32 off, for whatever calls were seen.
- `aggregate` / `compared`: a run's numbers from its frames' gaps, and those with a limit.
- `start_gap` / `state_gap`: the state a run starts from, built by each side alike.
- `pose_gaps`: the program's recorded poses against the reference's.
- `position_rmse`: a trajectory's accuracy against the simulator's truth (printed only).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .plv.core import frame as ref_frame
from .plv.ops import klt as ref_klt
from .plv.ops import msckf_kernel as ref_gram
from .plv.core import layout as ref_layout
from .plv.core import state as ref_state

_CLASSES = {"FilterState": ref_state.FilterState, "TrackState": ref_frame.TrackState,
            "StateLayout": ref_layout.StateLayout}


def to_ref(x):
    """A copy of x in the reference's own classes: program dataclasses become the
    reference's, tensors are cloned, containers are copied element by element."""
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if dataclasses.is_dataclass(x) and type(x).__name__ in _CLASSES:
        cls = _CLASSES[type(x).__name__]
        return cls(**{f.name: to_ref(getattr(x, f.name)) for f in dataclasses.fields(cls)})
    if isinstance(x, tuple):
        return tuple(to_ref(v) for v in x)
    if isinstance(x, list):
        return [to_ref(v) for v in x]
    if isinstance(x, dict):
        return {k: to_ref(v) for k, v in x.items()}
    return x


def tf32(on: bool):
    """Set TF32 for float32 matrix products and convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def ref_fused_frame(args, kwargs):
    """The reference's `fused_frame` on copies of a call's arguments, TF32 off."""
    tf32(False)
    with torch.no_grad():
        return ref_frame.fused_frame(*to_ref(args), **to_ref(kwargs))


def _quat_angle(q1, q2):
    """Angle (rad) between unit quaternions of the same convention, per row (the chord
    form, exact near 0 where an arccosine of the dot product is not)."""
    chord = torch.minimum(torch.linalg.vector_norm(q1 - q2, dim=-1),
                          torch.linalg.vector_norm(q1 + q2, dim=-1))
    return 4.0 * torch.asin((chord / 2.0).clamp(max=1.0))


def frame_gaps(prog, ref) -> dict:
    """Gaps between the program's `fused_frame` output (state, ts, metrics) and the
    reference's from the same inputs:
    - track_valid_mismatch: share of point slots tracked on one side only (front-end, LK);
    - track_uv_gap_px: largest |uv| gap of a slot whose track goes on on both sides (valid,
      with the same observation count, 2 or more): where the LK's accept flag flips at its
      threshold, one side refills the slot with a new corner, another feature;
    - accepted_gap: |accepted rows' features, points + lines, summed over the batch|
      between the two, over the reference's (the gate);
    - pos_gap_m: largest |p| gap over the sequences (m);
    - pos_gap_sigma: largest p gap over the sequences in the reference's posterior
      position covariance (the Mahalanobis length);
    - att_gap_rad: largest attitude gap (rad);
    - cov_gap_rel: largest |cov| gap over the largest |cov| of the reference."""
    sp, tp, mp = prog
    sr, tr, mr = ref
    f64 = torch.float64
    valid_p, valid_r = tp.valid.cpu(), tr.valid.cpu()
    n_obs = tr.n_obs.cpu()
    both = valid_p & valid_r & (tp.n_obs.cpu() == n_obs) & (n_obs >= 2)
    uv_gap = torch.linalg.vector_norm(tp.uv.cpu().to(f64) - tr.uv.cpu().to(f64), dim=-1)[both]
    acc = ("accepted", "lines_accepted")
    acc_p = sum(int(mp[k].sum()) for k in acc if k in mp)
    acc_r = sum(int(mr[k].sum()) for k in acc if k in mr)
    dpv = (sp.p.cpu() - sr.p.cpu())[..., None]
    dp = torch.linalg.vector_norm(dpv[..., 0], dim=-1)
    cov_r = sr.cov.cpu()
    P = cov_r[:, 3:6, 3:6]  # the position block (StateLayout.IMU_P)
    sigma = torch.sqrt((dpv.transpose(-1, -2) @ torch.linalg.solve(P, dpv))[:, 0, 0].clamp(min=0))
    return {
        "track_valid_mismatch": float((valid_p != valid_r).to(f64).mean()),
        "track_uv_gap_px": float(uv_gap.max()) if uv_gap.numel() else 0.0,
        "accepted_gap": abs(acc_p - acc_r) / max(acc_r, 1),
        "pos_gap_m": float(dp.max()),
        "pos_gap_sigma": float(sigma.max()),
        "att_gap_rad": float(_quat_angle(sp.q.cpu(), sr.q.cpu()).max()),
        "cov_gap_rel": float((sp.cov.cpu() - cov_r).abs().max() / cov_r.abs().max()),
    }


def _fro(a, b) -> float:
    """||a - b|| over ||b|| (Frobenius, 0 where both are 0; infinite where the shapes
    differ)."""
    if a.shape != b.shape:
        return float("inf")
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    scale, gap = float(torch.linalg.vector_norm(b)), float(torch.linalg.vector_norm(a - b))
    return gap / scale if scale > 0 else (0.0 if gap == 0 else float("inf"))


def _plain(fn, args):
    """fn on copies of args in the reference's classes, or None where the plain version
    cannot take them (a later program may call its entry otherwise)."""
    try:
        return fn(*to_ref(args))
    except (TypeError, ValueError, IndexError):
        return None


def call_gaps(calls: dict) -> dict:
    """Gaps between the kernel calls one frame made through its bound entries
    (`trace.kernel_calls`' record) and the kernels' plain versions on the same arguments,
    TF32 off, for whatever calls were seen (no call of a kind gives no number of it):
    - gram_G_gap / gram_c_gap: largest ||G - G_ref|| / ||G_ref|| and ||c - c_ref|| /
      ||c_ref|| over the frame's gate/Gram calls;
    - gram_ok_mismatch: largest share of features accepted on one side only;
    - lk_uv_gap_px: largest |uv| gap of a feature both LKs accept;
    - lk_ok_mismatch: largest share of features accepted by one LK only;
    - calls_not_compared: calls whose arguments the plain version could not take."""
    tf32(False)
    out, skipped = {}, 0

    def worst(name, value):
        out[name] = max(out.get(name, 0.0), value)

    with torch.no_grad():
        for args, res in calls.get("gram", []):
            ref = _plain(ref_gram.gram_gate_plain, args)
            if ref is None:
                skipped += 1
                continue
            (G, c, ok), (Gr, cr, okr) = res[:3], ref[:3]
            worst("gram_G_gap", _fro(G, Gr))
            worst("gram_c_gap", _fro(c, cr))
            worst("gram_ok_mismatch", _mismatch(ok, okr))
        for args, res in calls.get("lk", []):
            ref = _plain(ref_klt.pyramidal_lk_conv_full, args)
            if ref is None:
                skipped += 1
                continue
            (uv, ok), (uvr, okr) = res[:2], ref[:2]
            if uv.shape != uvr.shape or ok.shape != okr.shape:
                worst("lk_uv_gap_px", float("inf"))
                continue
            ok, okr = ok.cpu(), okr.cpu()
            d = torch.linalg.vector_norm(uv.cpu().double() - uvr.cpu().double(), dim=-1)[ok & okr]
            worst("lk_uv_gap_px", float(d.max()) if d.numel() else 0.0)
            worst("lk_ok_mismatch", _mismatch(ok, okr))
    if skipped:
        out["calls_not_compared"] = float(skipped)
    return out


def _mismatch(a, b) -> float:
    """Share of entries that differ (1 where the shapes do)."""
    if a.shape != b.shape:
        return 1.0
    return float((a.cpu() != b.cpu()).double().mean())


MEDIAN = ("pos_gap_sigma", "pos_gap_m", "att_gap_rad")


def aggregate(per_frame: list) -> dict:
    """The numbers of a run from its checked frames' gaps: each gap's largest over the
    frames, and for the state gaps (MEDIAN) also their median over the frames, as
    `<name>_med`: a frame's state gap is its rounding times the filter's conditioning at
    that frame, which differs a hundredfold from frame to frame."""
    out = {}
    for gaps in per_frame:
        for k, v in gaps.items():
            out[k] = max(out.get(k, 0.0), v)
    for k in MEDIAN:
        vals = [g[k] for g in per_frame if k in g]
        if vals:
            out[k + "_med"] = float(np.median(vals))
    return out


def compared(numbers: dict, limits: dict, say) -> dict:
    """{name: (value, limit)} of the numbers that have a limit.  A kernel gap that no
    call gave is left out and said; any other number with a limit and no value reads
    infinite."""
    out = {}
    for k, lim in limits.items():
        if k in numbers:
            out[k] = (numbers[k], lim)
        elif k.startswith(("gram_", "lk_")):
            say(f"not compared: {k} (no call of that kernel was seen through its entry)")
        else:
            out[k] = (float("inf"), lim)
    return out


def start_gap(state, arrays, layout_kwargs, device) -> float:
    """Largest |field| gap between a program's starting FilterState and the reference's,
    built from the same arrays (a list of per-sequence dicts)."""
    return state_gap(state, ref_state.FilterState.from_numpy(
        arrays, ref_layout.StateLayout(**layout_kwargs), device))


def state_gap(state, ref) -> float:
    """Largest |field| gap between two FilterStates (inf where a shape or type differs)."""
    gap = 0.0
    for name in ref_state.FIELDS:
        a, b = getattr(state, name), getattr(ref, name)
        if a.shape != b.shape or a.dtype != b.dtype:
            return float("inf")
        if a.numel() == 0:
            continue
        a, b = a.to(torch.float64).cpu(), b.to(torch.float64).cpu()
        d = torch.where(a == b, 0.0, (a - b).abs())  # equal infinities are no gap
        gap = max(gap, float(torch.nan_to_num(d, nan=float("inf")).max()))
    return gap


def position_rmse(traj, truth) -> float:
    """RMSE (m) of a recorded trajectory [(t, q, p)] against truth(t) -> p."""
    if not traj:
        return float("nan")
    err = [np.linalg.norm(np.asarray(p) - truth(t)) for t, _, p in traj]
    return float(np.sqrt(np.mean(np.square(err))))


def pose_gaps(traj_prog, traj_ref) -> dict:
    """Gaps between two recorded trajectories [(t, q, p)]: frames recorded by the program
    and not by the reference (or the other way), the largest time, position (m) and
    attitude (rad) gaps over the frames both recorded."""
    n = min(len(traj_prog), len(traj_ref))
    if n == 0:
        return {"frames_missing": float(max(len(traj_prog), len(traj_ref)) or 1),
                "pose_t_gap_s": float("inf"), "pose_gap_m": float("inf"),
                "pose_att_gap_rad": float("inf")}
    tp = np.array([t for t, _, _ in traj_prog[:n]])
    tr = np.array([t for t, _, _ in traj_ref[:n]])
    pp = np.array([p for _, _, p in traj_prog[:n]])
    pr = np.array([p for _, _, p in traj_ref[:n]])
    qp = torch.as_tensor(np.array([q for _, q, _ in traj_prog[:n]]))
    qr = torch.as_tensor(np.array([q for _, q, _ in traj_ref[:n]]))
    return {"frames_missing": float(abs(len(traj_prog) - len(traj_ref))),
            "pose_t_gap_s": float(np.abs(tp - tr).max()),
            "pose_gap_m": float(np.linalg.norm(pp - pr, axis=1).max()),
            "pose_att_gap_rad": float(_quat_angle(qp, qr).max())}
