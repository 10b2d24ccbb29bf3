"""Trajectory alignment (port of plviwo_tpu/eval/align.py, numpy; reference:
ov_eval AlignTrajectory/AlignUtils, alignment/AlignTrajectory.h:59-115):
posyaw / se3 / sim3 Umeyama."""

from __future__ import annotations

import numpy as np


def umeyama(p_est, p_gt, with_scale=False, yaw_only=False):
    """Best-fit transform p_gt ~= s * R @ p_est + t.

    Returns (s, R, t).
    """
    p_est = np.asarray(p_est, dtype=np.float64)
    p_gt = np.asarray(p_gt, dtype=np.float64)
    mu_e = p_est.mean(0)
    mu_g = p_gt.mean(0)
    de = p_est - mu_e
    dg = p_gt - mu_g

    if yaw_only:
        a = float(np.sum(de[:, 0] * dg[:, 0] + de[:, 1] * dg[:, 1]))
        b = float(np.sum(de[:, 0] * dg[:, 1] - de[:, 1] * dg[:, 0]))
        yaw = np.arctan2(b, a)
        c, s_ = np.cos(yaw), np.sin(yaw)
        R = np.array([[c, -s_, 0], [s_, c, 0], [0, 0, 1.0]])
        s = 1.0
    else:
        C = dg.T @ de / len(p_est)
        U, D, Vt = np.linalg.svd(C)
        S = np.eye(3)
        if np.linalg.det(U) * np.linalg.det(Vt) < 0:
            S[2, 2] = -1
        R = U @ S @ Vt
        if with_scale:
            var_e = np.mean(np.sum(de**2, axis=1))
            s = float(np.trace(np.diag(D) @ S) / var_e)
        else:
            s = 1.0
    t = mu_g - s * R @ mu_e
    return s, R, t


def align_trajectory(p_est, p_gt, method="posyaw"):
    """method in {none, posyaw, se3, sim3}. Returns (s, R, t)."""
    if method == "none":
        return 1.0, np.eye(3), np.zeros(3)
    if method == "posyaw":
        return umeyama(p_est, p_gt, with_scale=False, yaw_only=True)
    if method == "se3":
        return umeyama(p_est, p_gt, with_scale=False)
    if method == "sim3":
        return umeyama(p_est, p_gt, with_scale=True)
    raise ValueError(f"unknown alignment method {method}")
