"""Trajectory error metrics (port of plviwo_tpu/eval/metrics.py; reference:
ov_eval ResultTrajectory / Statistics, calc/ResultTrajectory.h:82-149):
ATE, ATE-2D, RPE over segment lengths, NEES from est/std/gt triplets.
Numpy on the host; rotations go through the port's `ops.lie` in float64 on
the CPU."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import lie
from .align import align_trajectory


@dataclasses.dataclass
class Stats:
    rmse: float
    mean: float
    median: float
    std: float
    max: float
    n: int

    @classmethod
    def from_values(cls, v):
        v = np.asarray(v, dtype=np.float64)
        if len(v) == 0:
            return cls(np.nan, np.nan, np.nan, np.nan, np.nan, 0)
        return cls(
            rmse=float(np.sqrt(np.mean(v**2))),
            mean=float(np.mean(v)), median=float(np.median(v)),
            std=float(np.std(v)), max=float(np.max(v)), n=len(v),
        )

    def as_dict(self):
        return dataclasses.asdict(self)


def associate(t_est, t_gt, tol=0.02):
    """Index pairs (i_est, i_gt) of timestamps matching within tol."""
    i_gt = np.searchsorted(t_gt, t_est)
    pairs = []
    for i, te in enumerate(t_est):
        for j in (i_gt[i] - 1, i_gt[i]):
            if 0 <= j < len(t_gt) and abs(t_gt[j] - te) <= tol:
                pairs.append((i, j))
                break
    return np.asarray(pairs, dtype=np.int64).reshape(-1, 2)


def _quat_to_rot_np(q):
    return lie.quat_2_rot(torch.as_tensor(np.asarray(q, dtype=np.float64))).numpy()


def _log_so3_np(R):
    return lie.log_so3(torch.as_tensor(np.asarray(R, dtype=np.float64))).numpy()


def ate(t_est, p_est, q_est, t_gt, p_gt, q_gt, method="posyaw", tol=0.02):
    """Absolute trajectory error after alignment.

    q_* are JPL q_GtoI.  Returns dict with position and orientation Stats
    plus the alignment used.
    """
    pairs = associate(t_est, t_gt, tol)
    if len(pairs) < 3:
        return {"error": "too few associations", "n": len(pairs)}
    pe = np.asarray(p_est)[pairs[:, 0]]
    pg = np.asarray(p_gt)[pairs[:, 1]]
    s, R, t = align_trajectory(pe, pg, method)
    pe_al = (s * (R @ pe.T)).T + t
    perr = np.linalg.norm(pe_al - pg, axis=1)

    oerr = []
    if q_est is not None and q_gt is not None:
        qe = np.asarray(q_est)[pairs[:, 0]]
        qg = np.asarray(q_gt)[pairs[:, 1]]
        R_est = _quat_to_rot_np(qe)  # R_GtoI est
        R_gt = _quat_to_rot_np(qg)
        # alignment rotates the world frame: R_est' = R_est R_align^T
        Rg_al = np.einsum("nij,jk->nik", R_est, R.T)
        dR = np.einsum("nij,nkj->nik", Rg_al, R_gt)  # R_est R_gt^T
        oerr = np.linalg.norm(_log_so3_np(dR), axis=1)

    return {
        "pos": Stats.from_values(perr).as_dict(),
        "pos_2d": Stats.from_values(
            np.linalg.norm((pe_al - pg)[:, :2], axis=1)).as_dict(),
        "ori_deg": Stats.from_values(np.degrees(oerr)).as_dict() if len(oerr) else None,
        "align": {"method": method, "scale": s, "yaw": float(np.arctan2(R[1, 0], R[0, 0]))},
        "n": int(len(pairs)),
    }


def rpe(t_est, p_est, q_est, t_gt, p_gt, q_gt, segment_lengths=(8, 16, 24, 32, 48),
        tol=0.02):
    """Relative pose error over distance segments (reference: calculate_rpe)."""
    pairs = associate(t_est, t_gt, tol)
    if len(pairs) < 3:
        return {"error": "too few associations"}
    pe = np.asarray(p_est)[pairs[:, 0]]
    pg = np.asarray(p_gt)[pairs[:, 1]]
    qe = np.asarray(q_est)[pairs[:, 0]] if q_est is not None else None
    qg = np.asarray(q_gt)[pairs[:, 1]] if q_gt is not None else None
    # cumulative gt distance
    dist = np.concatenate([[0.0], np.cumsum(np.linalg.norm(np.diff(pg, axis=0), axis=1))])
    out = {}
    for L in segment_lengths:
        errs_p, errs_o = [], []
        for i in range(len(pg)):
            j = int(np.searchsorted(dist, dist[i] + L))
            if j >= len(pg):
                break
            # relative transforms
            if qe is None:
                continue
            R0e, R1e = _quat_to_rot_np(qe[i]), _quat_to_rot_np(qe[j])
            R0g, R1g = _quat_to_rot_np(qg[i]), _quat_to_rot_np(qg[j])
            dpe = R0e @ (pe[j] - pe[i])
            dpg = R0g @ (pg[j] - pg[i])
            errs_p.append(np.linalg.norm(dpe - dpg))
            dd = (R1e @ R0e.T) @ (R1g @ R0g.T).T
            errs_o.append(np.linalg.norm(_log_so3_np(dd)))
        out[str(L)] = {
            "pos": Stats.from_values(errs_p).as_dict(),
            "ori_deg": Stats.from_values(np.degrees(errs_o)).as_dict(),
        }
    return out


def nees(p_est, q_est, p_std, q_std, p_gt, q_gt):
    """Normalized estimation error squared from est/std/gt triplets
    (reference: ResultSimulation / error_simulation NEES).

    p_std/q_std: per-axis 1-sigma stds of the position / orientation error.
    A consistent filter has mean NEES ~= dof (3 for each block).
    """
    perr = np.asarray(p_est) - np.asarray(p_gt)
    nees_p = np.sum((perr / np.maximum(np.asarray(p_std), 1e-12)) ** 2, axis=1)
    R_est = _quat_to_rot_np(np.asarray(q_est))
    R_gt = _quat_to_rot_np(np.asarray(q_gt))
    th = _log_so3_np(np.einsum("nij,nkj->nik", R_est, R_gt))
    nees_q = np.sum((th / np.maximum(np.asarray(q_std), 1e-12)) ** 2, axis=1)
    return {
        "pos_nees": Stats.from_values(nees_p).as_dict(),
        "ori_nees": Stats.from_values(nees_q).as_dict(),
    }
