"""Line-segment detection (port of plviwo_tpu/ops/line_detect.py).

Two detectors share the anchors, the strongest gradient pixel of each grid
cell ordered by decreasing cell magnitude (ties by cell index):

`detect_segments_runlen`, the frame's default detector, batch-first: for
each of 8 lattice directions (mod pi) a pixel supports the direction iff
its gradient magnitude passes and its level-line direction agrees; the
support is dilated 3x3, and the run length of consecutive support along the
direction is computed for every pixel at once by pointer doubling
(ceil(log2(LINE_STEPS)) rounds of shifted, masked adds, with a lateral
dilation for off-lattice lines) and read at the anchors.  That part runs
through `ops/line_kernel.line_runlen`: on a card the hand kernel
`csrc/line_runlen.cu`, on the CPU its plain version `runlen_reaches`.  An
anchor's line direction comes from the smoothed structure tensor, snapped
to the nearest lattice ray, and its reach fore and aft along that ray gives
the segment's endpoints.

`detect_segments`, the EDLines-style anchor walk the host line tracker
runs, one image: every anchor marches both ways along its level line (both
directions in one (2A, 2) loop of `WALK_STEPS` steps), re-centering each step
on the edge by a quadratic fit of the magnitude across the walk, and stops
where the magnitude fades, the direction bends or the image ends.  Each
step samples in two gathers (`image.bilinear_sample`): the magnitude at
the three re-centering points, then magnitude and gradient at the
re-centered one.  Nothing is read to the host.

`merge_segments` is the host's greedy collinear clustering of the
candidates (numpy, a copy of the JAX package's).

Images are float32.  Shifts are pad-and-slice with an explicit fill, as
the JAX package writes them (no `torch.roll`: the fill matters).  The
support masks and run lengths, float32 0/1 sums in the JAX package, are
int16 in `runlen_reaches` (uint8 in the kernel): the same integers, since a
run never exceeds 2^n_doubling = 128 steps.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..utils import graphs
from . import line_kernel
from .image import bilinear_sample, gauss_blur, gradients

F32 = torch.float32
I16 = torch.int16
# the settings the JAX frame detects with: anchor grid cells per side,
# anchors kept, the longest run in steps; and the detector's own defaults: a
# pixel supports a direction above MAG_THRESH gradient magnitude and within
# ANG_TOL radians of it
LINE_GRID, LINE_ANCHORS, LINE_STEPS = 16, 192, 96
MAG_THRESH, ANG_TOL = 0.02, 0.55
# the anchor walk's defaults (the host line tracker's): anchors, steps each way;
# the merge's collinearity: direction within MERGE_ANG_TOL rad, midpoint within
# MERGE_DIST_TOL px of the kept line
WALK_ANCHORS, WALK_STEPS = 256, 160
MERGE_ANG_TOL, MERGE_DIST_TOL = 0.08, 3.0

# direction k covers the angle bucket k pi / 8 (mod pi), as (dx, dy) steps
_DIRS8 = np.array([
    [1, 0], [2, 1], [1, 1], [1, 2], [0, 1], [-1, 2], [-1, 1], [-2, 1]
], dtype=np.int32)
_UNIT8 = [tuple(float(np.float32(v)) for v in d / np.hypot(*d)) for d in _DIRS8.astype(np.float64)]
# the step lengths |d| as float32: 1 (k = 0, 4), sqrt 2 (k = 2, 6), sqrt 5 (odd k)
_SQRT2, _SQRT5 = float(np.float32(np.sqrt(2.0))), float(np.float32(np.sqrt(5.0)))
# the run-length doubling rounds: a run reaches 2^N_DOUBLING >= LINE_STEPS steps
N_DOUBLING = int(np.ceil(np.log2(LINE_STEPS)))


def _drift(step: int) -> int:
    """The lateral drift, in px, that the doubling round of `step` steps
    follows for off-lattice lines."""
    return int(math.ceil(0.22 * step))


def _shift2d(x, dy: int, dx: int, fill=0):
    """x (..., H, W) shifted so out[p] = x[p + (dy, dx)], `fill` outside."""
    H, W = x.shape[-2:]
    py0, py1 = max(dy, 0), max(-dy, 0)
    px0, px1 = max(dx, 0), max(-dx, 0)
    p = F.pad(x, (px1, px0, py1, py0), value=fill)
    return p[..., py1 + dy:py1 + dy + H, px1 + dx:px1 + dx + W]


def _lat_dilate(r, width: int, ly: int, lx: int):
    """max over lateral offsets in [-width, width] along (ly, lx) by doubling
    (offsets 1, 2, 4, ... cover +-(2^k - 1) >= width)."""
    acc = r
    off = 1
    while off <= width:
        acc = torch.maximum(acc, torch.maximum(_shift2d(acc, off * ly, off * lx),
                                               _shift2d(acc, -off * ly, -off * lx)))
        off *= 2
    return acc


def _flat_gather(x, idx):
    """x (B, H, W) at flat pixel indices idx (B, A)."""
    return torch.gather(x.reshape(x.shape[0], -1), 1, idx)


def _cell_anchors(mag, n: int):
    """The strongest gradient pixel of each of LINE_GRID x LINE_GRID cells of
    mag (B, H, W), the first among ties as jnp.argmax, the n strongest cells
    first (a stable sort, as JAX's).  Returns (u, v) int64 and the cell
    magnitude, each (B, n)."""
    B, H, W = mag.shape
    g = LINE_GRID
    ch, cw = H // g, W // g
    m = mag[:, :ch * g, :cw * g].reshape(B, g, ch, g, cw)
    m = m.transpose(2, 3).reshape(B, g * g, ch * cw)
    cell_mag, cell_best = torch.max(m, dim=-1)
    cells = torch.arange(g * g, device=mag.device)
    au = (cells % g) * cw + cell_best % cw
    av = (cells // g) * ch + cell_best // cw
    order = torch.argsort(-cell_mag, dim=-1, stable=True)[:, :n]
    return torch.gather(au, 1, order), torch.gather(av, 1, order), torch.gather(cell_mag, 1, order)


def runlen_reaches(dlx, dly, mag, at):
    """The run lengths, in steps, of consecutive support fore and aft along
    each of the 8 lattice directions at the anchors: the plain version of
    the kernel `ops/line_kernel.line_runlen`.  dlx, dly (the unit level-line
    direction) and mag (B, H, W) float32; at (B, A) flat pixel indices.
    Returns (reach_f, reach_b), each (B, A, 8) int16."""
    cos_tol = float(np.cos(ANG_TOL))
    reach_f, reach_b = [], []  # per direction: run lengths in steps at the anchors
    for k in range(8):
        sx, sy = int(_DIRS8[k][0]), int(_DIRS8[k][1])
        norm = float(np.hypot(sx, sy))
        ux, uy = sx / norm, sy / norm
        sup = ((torch.abs(dlx * ux + dly * uy) > cos_tol) & (mag > MAG_THRESH)).to(I16)
        # 3x3 dilation: an off-lattice line staircases by <= 1 px per step
        sup = torch.maximum(torch.maximum(_shift2d(sup, -1, 0), sup), _shift2d(sup, 1, 0))
        sup = torch.maximum(torch.maximum(_shift2d(sup, 0, -1), sup), _shift2d(sup, 0, 1))
        # lateral drift axis: the ray's minor axis
        ly, lx = (0, 1) if abs(sx) <= abs(sy) else (1, 0)
        r_f = r_b = sup
        step = 1
        for _ in range(N_DOUBLING):
            # r'(p) = r(p) + [r(p) >= step] * max_lat r(p + step d + lat)
            drift = _drift(step)
            cont_f = _lat_dilate(r_f, drift, ly, lx)
            cont_b = _lat_dilate(r_b, drift, ly, lx)
            r_f = r_f + torch.where(r_f >= step, _shift2d(cont_f, step * sy, step * sx), 0)
            r_b = r_b + torch.where(r_b >= step, _shift2d(cont_b, -step * sy, -step * sx), 0)
            step *= 2
        reach_f.append(_flat_gather(r_f, at))
        reach_b.append(_flat_gather(r_b, at))
    return torch.stack(reach_f, -1), torch.stack(reach_b, -1)


def detect_segments_runlen(img):
    """Candidate segments of B images (B, H, W) from per-pixel run-length
    fields.  Returns (segs (B, A, 4) [x1 y1 x2 y2], length (B, A),
    valid (B, A)) with A = LINE_ANCHORS, anchors in decreasing cell
    magnitude (ties by cell index)."""
    B, H, W = img.shape
    img_s = gauss_blur(gauss_blur(img))
    gx, gy = gradients(img_s)
    mag = torch.sqrt(gx * gx + gy * gy)
    inv = 1.0 / torch.clamp(mag, min=1e-9)
    # unit level-line direction (perpendicular to the gradient)
    dlx, dly = -gy * inv, gx * inv

    # smoothed structure tensor: a sign-stable line orientation
    jxx = gauss_blur(gauss_blur(gx * gx))
    jxy = gauss_blur(gauss_blur(gx * gy))
    jyy = gauss_blur(gauss_blur(gy * gy))

    au, av, amag = _cell_anchors(mag, LINE_ANCHORS)
    at = av * W + au  # (B, A) flat pixel of each anchor

    # the run lengths at the anchors: the hand kernel on a card, run outside
    # any CUDA graph and looked up by its module name at every call
    reach_f, reach_b = graphs.call(lambda: line_kernel.line_runlen, dlx, dly, mag, at)

    # true local line direction: perpendicular to the structure tensor's
    # dominant eigenvector
    axx, axy, ayy = (_flat_gather(j, at) for j in (jxx, jxy, jyy))
    theta_g = 0.5 * torch.atan2(2.0 * axy, axx - ayy)
    dax, day = -torch.sin(theta_g), torch.cos(theta_g)

    # snap to the nearest lattice ray by |cos|
    dots = torch.stack([dax * ux + day * uy for ux, uy in _UNIT8], dim=-1)  # (B, A, 8)
    k = torch.argmax(torch.abs(dots), dim=-1, keepdim=True)
    step_len = torch.where(k[..., 0] % 2 == 1, _SQRT5,
                           torch.where(k[..., 0] % 4 == 2, _SQRT2, 1.0)).to(F32)
    sdot = torch.gather(dots, -1, k)[..., 0]
    # orient along the snapped +d; stretch the along-ray run back to the
    # line's own axis (the run covers the true extent * cos(snap error))
    sgn = torch.sign(sdot)
    dax, day = dax * sgn, day * sgn
    stretch = step_len / torch.clamp(torch.abs(sdot), min=0.8)

    # reach in steps; -1 drops the dilation halo at each end
    n_f = torch.clamp(torch.gather(reach_f, -1, k)[..., 0].to(F32) - 1.0, min=0.0)
    n_b = torch.clamp(torch.gather(reach_b, -1, k)[..., 0].to(F32) - 1.0, min=0.0)

    ax, ay = au.to(F32), av.to(F32)
    ef, eb = n_f * stretch, n_b * stretch
    segs = torch.stack([torch.clamp(ax - eb * dax, 2, W - 3), torch.clamp(ay - eb * day, 2, H - 3),
                        torch.clamp(ax + ef * dax, 2, W - 3), torch.clamp(ay + ef * day, 2, H - 3)],
                       dim=-1)
    length = (n_f + n_b) * stretch
    valid = (amag > MAG_THRESH) & (length >= 2.0)
    return segs, length, valid


def detect_segments(img):
    """Candidate segments of one image (H, W) from anchor walks of
    WALK_STEPS steps each way from the strongest pixels of LINE_GRID x
    LINE_GRID cells, alive while the magnitude passes MAG_THRESH and the
    direction stays within ANG_TOL.  Returns (segs (A, 4) [x1 y1 x2 y2],
    length (A,), valid (A,)) on the image's device, A = WALK_ANCHORS."""
    H, W = img.shape
    # blur first: rendered and real edges have staircase jogs that rotate the
    # raw gradient; a smoothed field keeps the level-line direction stable
    img_s = gauss_blur(gauss_blur(img[None]))
    gx, gy = gradients(img_s)
    mag = torch.sqrt(gx * gx + gy * gy)
    au, av, amag = _cell_anchors(mag, WALK_ANCHORS)
    anchors = torch.stack([au[0], av[0]], -1).to(F32)  # (A, 2)
    fields = torch.cat([mag, gx, gy])  # (3, H, W): one gather samples all three

    # the level-line direction at each anchor (perpendicular to the gradient)
    agx, agy = bilinear_sample(fields[1:], anchors)
    norm = torch.sqrt(agx * agx + agy * agy)
    norm = torch.where(norm < 1e-9, 1.0, norm)
    dline = torch.stack([-agy / norm, agx / norm], -1)
    # both directions at once: rows [0, A) walk along dline, [A, 2A) against it
    step = torch.cat([dline, -dline])
    normal = torch.stack([-step[:, 1], step[:, 0]], -1)
    across = torch.stack([-normal, torch.zeros_like(normal), normal])  # (3, 2A, 2)
    sx, sy = step.unbind(-1)
    step_norm = torch.clamp(torch.sqrt(sx * sx + sy * sy), min=1e-9)
    cos_tol = float(np.float32(np.cos(ANG_TOL)))
    lo = torch.full((2,), 2.0, dtype=F32, device=img.device)  # in bounds: lo < (x, y) < hi
    hi = torch.tensor([W - 3.0, H - 3.0], dtype=F32).to(img.device, non_blocking=True)

    pos = anchors.repeat(2, 1)  # the last position that passed, per walk
    alive = torch.ones(2 * WALK_ANCHORS, dtype=torch.bool, device=img.device)
    for _ in range(WALK_STEPS):
        nxt = pos + step
        # re-center on the edge: a quadratic fit of the magnitude across the
        # walk (EDLines-style), so direction error does not march it off the line
        m_m, m_0, m_p = bilinear_sample(mag, nxt + across)[0]
        denom = m_m - 2.0 * m_0 + m_p
        off = torch.where(torch.abs(denom) > 1e-9, 0.5 * (m_m - m_p) / denom, 0.0)
        nxt = nxt + torch.clamp(off, -0.75, 0.75)[:, None] * normal
        mg, gxn, gyn = bilinear_sample(fields, nxt)
        nn = torch.sqrt(gxn * gxn + gyn * gyn)
        nn = torch.where(nn < 1e-9, 1.0, nn)
        # direction agreement (sign-invariant)
        cosang = torch.abs((-gyn / nn * sx + gxn / nn * sy) / step_norm)
        inb = torch.all((nxt > lo) & (nxt < hi), dim=-1)
        alive = alive & (mg > MAG_THRESH) & (cosang > cos_tol) & inb
        pos = torch.where(alive[:, None], nxt, pos)
    p_fwd, p_bwd = pos[:WALK_ANCHORS], pos[WALK_ANCHORS:]
    d = p_fwd - p_bwd
    length = torch.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1])
    valid = (amag[0] > MAG_THRESH) & (length >= 2.0)
    return torch.cat([p_bwd, p_fwd], -1), length, valid


def merge_segments(segs, lengths, valid, min_length=25.0, extend: bool = True):
    """Greedy collinear clustering of the candidates on the host (reference
    `MergeLines`, TrackLSD.cpp:450-622): longest first, a candidate within
    MERGE_ANG_TOL of a kept segment's direction, within MERGE_DIST_TOL of
    its line and within 10 px of its span joins it; with extend the kept
    segment grows to the cluster's span along its own direction, otherwise
    the longest is kept as it is.  segs (A, 4), lengths (A,) (float32, as
    the detector returns them: the order is argsort's on them), valid (A,)
    as numpy arrays.  Returns (K, 4) float64."""
    segs = np.asarray(segs, dtype=np.float64)
    lengths = np.asarray(lengths)
    valid = np.asarray(valid) & (lengths >= min_length)
    order = np.argsort(-lengths)
    kept: list[int] = []
    geo: dict[int, list] = {}  # per kept index: anchor point, unit direction, [t_min, t_max]
    for i in order:
        if not valid[i]:
            continue
        x1, y1, x2, y2 = segs[i]
        d = np.array([x2 - x1, y2 - y1])
        L = np.linalg.norm(d)
        if L < 1e-6:
            continue
        d = d / L
        merged = False
        for j in kept:
            a_j, dj, span = geo[j]
            if abs(d @ dj) < np.cos(MERGE_ANG_TOL):
                continue
            mid = np.array([(x1 + x2) / 2, (y1 + y2) / 2]) - a_j
            nj = np.array([-dj[1], dj[0]])
            if abs(mid @ nj) > MERGE_DIST_TOL:
                continue
            # collinear: longitudinal overlap or closeness to the span
            t1 = (np.array([x1, y1]) - a_j) @ dj
            t2 = (np.array([x2, y2]) - a_j) @ dj
            lo, hi = min(t1, t2), max(t1, t2)
            if hi < span[0] - 10.0 or lo > span[1] + 10.0:
                continue
            if extend:
                span[0] = min(span[0], lo)
                span[1] = max(span[1], hi)
            merged = True
            break
        if not merged:
            kept.append(i)
            geo[i] = [segs[i, :2].copy(), d, [0.0, L]]
    if not kept:
        return np.zeros((0, 4))
    out = np.zeros((len(kept), 4))
    for r, j in enumerate(kept):
        a, dj, span = geo[j]
        p1 = a + span[0] * dj
        p2 = a + span[1] * dj
        out[r] = [p1[0], p1[1], p2[0], p2[1]]
    return out
