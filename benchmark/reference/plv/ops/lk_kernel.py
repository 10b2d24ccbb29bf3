"""Pyramidal LK by its plain version (the shifted-MAC form of `ops/klt`)."""

from __future__ import annotations

from . import klt


def lk_pyramid(prev_pyr, next_pyr, uv_prev, valid, levels: int, half: int = 7,
               iters: int = 10, max_err: float = 0.08, drift: int = 5,
               drift_fine: int = 2):
    """(uv (B,N,2), ok (B,N), err (B,N), det (B,N)) of the plain LK."""
    return klt.pyramidal_lk_conv_full(prev_pyr, next_pyr, uv_prev, valid, levels, half, iters,
                                      max_err, drift, drift_fine)


def pyramidal_lk(prev_pyr, next_pyr, uv_prev, valid, levels: int, half: int = 7,
                 iters: int = 10, max_err: float = 0.08, drift: int = 5,
                 drift_fine: int = 2):
    """(uv_next (B,N,2), ok (B,N)) of the plain LK."""
    return lk_pyramid(prev_pyr, next_pyr, uv_prev, valid, levels, half, iters, max_err,
                      drift, drift_fine)[:2]
