"""Fiducial square-tag detection (port of plviwo_tpu/ops/aruco.py), the
`TrackAruco` substrate, batch-first.

The reference delegates marker detection to `cv::aruco::detectMarkers` and
feeds each tag's 4 corners into the feature database with stable ids
`tag_id + n * max_tag_id` (TrackAruco.cpp:120-150).  The JAX package
rebuilt the detector as tensor programs, and this is its port:

- a deterministic binary tag family (6 x 6 cells: a black border and 4 x 4
  code bits, a minimum pairwise Hamming distance under all 4 rotations) and
  its rendering, in numpy, copied;
- detection: the image correlated with a rotation x scale bank of
  zero-mean border templates (`F.conv2d`, cross-correlation with "same"
  zero padding, as JAX's `lax.conv_general_dilated`; a large template in
  blocks of taps), normalized by the
  local standard deviation (box means of the image and its square, zero
  padded) to an NCC score volume (B, S, A, H, W);
- peak extraction: `max_det` rounds of a flat argmax over each sequence's
  volume, parabolic subpixel, subscale and subangle refinements, and a
  window around each peak set to -inf across all channels; every round
  stays on the device;
- decoding: the 6 x 6 cell grid sampled at each candidate's pose,
  thresholded halfway between the border's black and the quiet zone's
  white, matched against every code under the 4 rotations;
- corners: the canonical TL, TR, BR, BL border corners at the decoded pose,
  refined by a gradient saddle fit (cv::cornerSubPix semantics).

The bank's convolutions run in float32: cuDNN's TF32 (on by default for
convolutions) would put about 1e-3 relative error in the score, which moves
parabolic peaks and threshold decisions, so the call turns TF32 off for
itself.  Images are (B, H, W) float32 in [0, 1].
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..core.state import CUDA, checked_device
from .image import bilinear_sample_batch, gradients

F32 = torch.float32

# canonical corner order (tag-local cell coords, x right / y down, the outer
# black-border corners at +-3 cells): TL, TR, BR, BL, the reference's aruco
# corner convention
_CORNERS = np.array([[-3.0, -3.0], [3.0, -3.0], [3.0, 3.0], [-3.0, 3.0]])


# ---------------------------------------------------------------------------
# tag family (numpy, copied)
# ---------------------------------------------------------------------------

def _rot_bits(bits4):
    """Rotate a flat 16-bit (4x4) code 90 deg clockwise."""
    return np.rot90(bits4.reshape(4, 4), -1).reshape(-1)


def tag_family(n_tags: int = 16, min_dist: int = 4, seed: int = 7):
    """Deterministic 4x4-bit code family.

    Greedy sampling guaranteeing: (a) pairwise Hamming distance >= min_dist
    under every relative rotation, (b) distance of each code to every
    rotation of itself >= min_dist (so orientation is unambiguous).
    min_dist 4 matches the ArUco DICT_4X4 class: decode tolerates one bit
    error (min_bits 15) while a wrong id needs >= 3 flips.
    Returns (n_tags, 16) uint8.
    """
    rng = np.random.default_rng(seed)
    codes = []
    trials = 0
    while len(codes) < n_tags and trials < 100000:
        trials += 1
        c = rng.integers(0, 2, 16).astype(np.uint8)
        rots = [c]
        for _ in range(3):
            rots.append(_rot_bits(rots[-1]))
        # self-rotation ambiguity
        if min(int(np.sum(c != r)) for r in rots[1:]) < min_dist:
            continue
        ok = True
        for other in codes:
            for r in rots:
                if int(np.sum(other != r)) < min_dist:
                    ok = False
                    break
            if not ok:
                break
        if ok:
            codes.append(c)
    if len(codes) < n_tags:
        raise RuntimeError("tag family generation failed")
    return np.stack(codes)


def tag_bitmap(code16, cell: int = 8, quiet: bool = True):
    """Render one tag to a numpy image patch (float, 0=black 1=white).

    Layout (cells): 1-cell white quiet zone (optional), 1-cell black border,
    4x4 code bits (1=white), total 8x8 (or 6x6 without quiet) cells.
    """
    n = 8 if quiet else 6
    img = np.ones((n * cell, n * cell)) if quiet else np.zeros((n * cell, n * cell))
    o = 1 if quiet else 0
    # black border square spans cells [o, o+6)
    img[o * cell:(o + 6) * cell, o * cell:(o + 6) * cell] = 0.0
    bits = np.asarray(code16).reshape(4, 4)
    for i in range(4):       # y (row)
        for j in range(4):   # x (col)
            if bits[i, j]:
                y0 = (o + 1 + i) * cell
                x0 = (o + 1 + j) * cell
                img[y0:y0 + cell, x0:x0 + cell] = 1.0
    return img


# ---------------------------------------------------------------------------
# template bank (numpy, copied)
# ---------------------------------------------------------------------------

def _border_template(size: int, s: float, theta: float):
    """(size, size) zero-mean unit-norm border template at cell scale s and
    in-plane rotation theta.  Border ring (black) weighted against the quiet
    ring (white) so flat regions score zero."""
    ax = np.arange(size) - (size - 1) / 2.0
    X, Y = np.meshgrid(ax, ax)
    ct, st = np.cos(theta), np.sin(theta)
    #  tag-local coords (cells): inverse rotation
    u = (ct * X + st * Y) / s
    v = (-st * X + ct * Y) / s
    m = np.maximum(np.abs(u), np.abs(v))
    border = (m > 2.0) & (m <= 3.0)
    quiet = (m > 3.0) & (m <= 4.0)
    t = np.zeros((size, size))
    nb, nq = border.sum(), quiet.sum()
    if nb == 0 or nq == 0:
        return t
    t[border] = -1.0
    t[quiet] = float(nb) / float(nq)   # zero total sum
    t /= np.linalg.norm(t) + 1e-12
    return t


def template_bank(scales=(4.0, 5.5, 7.5), n_angles: int = 12):
    """Per-scale stacks of rotated border templates.

    The border is 4-fold symmetric so angles tile [0, 90) deg.  Returns a
    list of ((n_angles, K, K) float32 array, K, float32 angles) per scale:
    a convolution per scale keeps each kernel as small as its support."""
    bank = []
    for s in scales:
        K = int(np.ceil(8.0 * s * 1.45 / 2.0)) * 2 + 1
        angles = np.arange(n_angles) * (np.pi / 2) / n_angles
        T = np.stack([_border_template(K, s, a) for a in angles])
        bank.append((T.astype(np.float32), K, angles.astype(np.float32)))
    return bank


def _codes_rot4(codes_np):
    """(T, 16) -> (T, 4, 16): all four rotations of each code."""
    out = []
    for c in codes_np:
        rots = [c]
        for _ in range(3):
            rots.append(_rot_bits(rots[-1]))
        out.append(np.stack(rots))
    return np.stack(out)


# ---------------------------------------------------------------------------
# detection (torch, batch-first)
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _fp32_convolutions():
    """cuDNN convolutions in float32 (no TF32) for the block."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def _box_mean(x, K: int):
    """Zero-padded "same" K x K mean of (B,1,H,W), separably."""
    r = K // 2
    x = F.avg_pool2d(x, (K, 1), stride=1, padding=(r, 0), count_include_pad=True)
    return F.avg_pool2d(x, (1, K), stride=1, padding=(0, r), count_include_pad=True)


def _correlate(x, T, block: int = 33):
    """Cross-correlation of (B,1,H,W) with the (A,K,K) templates, "same" size
    with zero padding: (B,A,H,W).  The templates are cut into blocks of at
    most `block` taps a side, each block correlated with its offset window of
    the padded image and the results summed: the same correlation, and
    oneDNN on the CPU takes a slow path for kernels much larger (about 5 s
    for one 65-tap bank at 320 x 240, 0.02 s in blocks)."""
    H, W = x.shape[-2:]
    K = T.shape[-1]
    r = K // 2
    xp = F.pad(x, (r, r, r, r))
    n = -(-K // block)
    bs = -(-K // n)
    out = None
    for by in range(0, K, bs):
        for bx in range(0, K, bs):
            Tb = T[:, by:by + bs, bx:bx + bs]
            kh, kw = Tb.shape[-2:]
            term = F.conv2d(xp[..., by:by + H + kh - 1, bx:bx + W + kw - 1], Tb[:, None])
            out = term if out is None else out + term
    return out


def ncc_stack(img, bank_T):
    """NCC scores of (B,H,W) against the bank (a list of (A,K,K) tensors,
    one per scale): (B,S,A,H,W)."""
    x = img[:, None]
    outs = []
    with _fp32_convolutions():
        for T in bank_T:
            K = T.shape[-1]
            num = _correlate(x, T)
            mean = _box_mean(x, K)
            mean2 = _box_mean(x * x, K)
            std = torch.sqrt(torch.clamp(mean2 - mean * mean, min=1e-8))
            outs.append(num / (std * K))
    return torch.stack(outs, dim=1)


def _parabolic(fm, f0, fp):
    """Subsample offset of a parabola through (-1, fm), (0, f0), (1, fp)."""
    denom = fm - 2.0 * f0 + fp
    big = torch.abs(denom) > 1e-9
    return torch.where(big, 0.5 * (fm - fp) / torch.where(big, denom, 1.0), 0.0)


def _find_peaks(scores, scales, max_det: int, n_angles: int):
    """Cross-channel NMS peak extraction with subpixel, subscale and
    subangle refinement.

    scores (B,S,A,H,W); scales (S,) f32 tensor.  Returns a dict of (B,
    max_det) tensors: x, y (subpixel), s (cell px), theta, score.  No host
    read: each round's argmax, gathers and suppression stay on the device."""
    B, S, A, H, W = scores.shape
    dev = scores.device
    sc = scores.clone()
    flat = sc.view(B, S * A * H * W)
    bidx = torch.arange(B, device=dev)
    ys = torch.arange(H, device=dev)[:, None]
    xs = torch.arange(W, device=dev)[None, :]
    sidx = torch.arange(S, device=dev)
    aidx = torch.arange(A, device=dev)
    astep = (math.pi / 2) / n_angles
    outs = {k: [] for k in ("x", "y", "s", "theta", "score")}
    for _ in range(max_det):
        best = torch.argmax(flat, dim=1)
        si, rem = best // (A * H * W), best % (A * H * W)
        ai, rem = rem // (H * W), rem % (H * W)
        yi, xi = rem // W, rem % W
        val = sc[bidx, si, ai, yi, xi]
        # subpixel x/y on the winning channel
        xi_c = torch.clamp(xi, 1, W - 2)
        yi_c = torch.clamp(yi, 1, H - 2)
        ch = sc[bidx, si, ai]  # (B,H,W)
        dx = _parabolic(ch[bidx, yi_c, xi_c - 1], ch[bidx, yi_c, xi_c], ch[bidx, yi_c, xi_c + 1])
        dy = _parabolic(ch[bidx, yi_c - 1, xi_c], ch[bidx, yi_c, xi_c], ch[bidx, yi_c + 1, xi_c])
        # subscale: a parabola over the scale channels at the peak pixel
        svals = sc[bidx[:, None], sidx, ai[:, None], yi_c[:, None], xi_c[:, None]]  # (B,S)
        si_c = torch.clamp(si, 1, S - 2)
        sv = svals.gather(1, torch.stack([si_c - 1, si_c, si_c + 1], 1))
        ds = _parabolic(sv[:, 0], sv[:, 1], sv[:, 2])
        ds = torch.where((si > 0) & (si < S - 1), ds, 0.0)
        step = torch.where(si_c < S - 1, scales[(si_c + 1).clamp(max=S - 1)] - scales[si_c],
                           scales[si_c] - scales[si_c - 1])
        s_ref = scales[si] + ds * step
        # subangle (periodic neighbors)
        avals = sc[bidx[:, None], si[:, None], aidx, yi_c[:, None], xi_c[:, None]]  # (B,A)
        av = avals.gather(1, torch.stack([(ai - 1) % A, ai, (ai + 1) % A], 1))
        da = _parabolic(av[:, 0], av[:, 1], av[:, 2])
        theta = ai * astep + da * astep
        outs["x"].append(xi.to(scores.dtype) + dx)
        outs["y"].append(yi.to(scores.dtype) + dy)
        outs["s"].append(s_ref)
        outs["theta"].append(theta)
        outs["score"].append(val)
        # suppress a window around the peak across ALL channels
        rad = (4.0 * scales[si]).to(torch.int64)[:, None, None]
        mask = ((ys - yi[:, None, None]).abs() <= rad) & ((xs - xi[:, None, None]).abs() <= rad)
        sc.masked_fill_(mask[:, None, None], -math.inf)
    return {k: torch.stack(v, dim=1) for k, v in outs.items()}


def _rotation(theta):
    """(..., 2, 2) rotations [[c, -s], [s, c]]."""
    ct, st = torch.cos(theta), torch.sin(theta)
    return torch.stack([torch.stack([ct, -st], -1), torch.stack([st, ct], -1)], -2)


def _decode(img, x, y, s, theta, codes4):
    """Decode the candidates: sample each one's 6 x 6 cell grid and 4 quiet
    zone cells, threshold, match the 16 interior bits against every code x
    rotation.

    img (B,H,W); x, y, s, theta (B,D); codes4 (T,4,16) int.  Returns
    (tag_id, rot, n_match, black_ok), each (B,D)."""
    dt = img.dtype
    dev = img.device
    R = _rotation(theta)  # (B,D,2,2)
    ij = torch.arange(6, dtype=dt, device=dev) - 2.5
    gv, gu = torch.meshgrid(ij, ij, indexing="ij")  # gu: x, gv: y of each cell center
    cells = torch.stack([gu, gv], -1).reshape(-1, 2)  # (36,2) tag-local
    qcells = torch.tensor([[0.0, -3.5], [3.5, 0.0], [0.0, 3.5], [-3.5, 0.0]], dtype=dt,
                          device=dev)
    centre = torch.stack([x, y], -1)[..., None, :]  # (B,D,1,2)
    pts = torch.cat([cells, qcells])  # (40,2)
    pix = centre + s[..., None, None] * torch.einsum("kj,bdij->bdki", pts, R)
    samp = bilinear_sample_batch(img[:, None], pix)[:, 0]  # (B,D,40)
    vals = samp[..., :36].reshape(x.shape + (6, 6))
    white = torch.mean(samp[..., 36:], dim=-1)
    m = torch.maximum(gu.abs(), gv.abs())
    border_mask = (m > 2.0).to(dt)
    black = torch.sum(vals * border_mask, dim=(-2, -1)) / torch.sum(border_mask)
    thr = 0.5 * (black + white)
    bits = (vals[..., 1:5, 1:5] > thr[..., None, None]).to(torch.int32).reshape(x.shape + (16,))
    match = torch.sum(bits[..., None, None, :] == codes4, dim=-1)  # (B,D,T,4)
    flat = torch.argmax(match.reshape(x.shape + (-1,)), dim=-1)
    tag_id, rot = flat // 4, flat % 4
    n_match = torch.gather(match.reshape(x.shape + (-1,)), -1, flat[..., None])[..., 0]
    return tag_id, rot, n_match, (white - black) > 0.15


def refine_corners(img, corners, win: int = 5, iters: int = 4):
    """Gradient saddle-point corner refinement (cv::cornerSubPix semantics).

    At a true corner c, every window pixel p satisfies grad I(p) . (p - c) =
    0 (points on an edge have their gradient orthogonal to the offset; flat
    points have none).  Solves the weighted least squares for c and
    iterates, all corners at once.  img (B,H,W); corners (B, ..., 2) pixel
    coords.  Returns the refined (B, ..., 2)."""
    B = img.shape[0]
    dt = img.dtype
    gx, gy = gradients(img)
    grads = torch.stack([gx, gy], dim=1)
    ax = torch.arange(-win, win + 1, dtype=dt, device=img.device)
    DY, DX = torch.meshgrid(ax, ax, indexing="ij")
    w = torch.exp(-(DX**2 + DY**2) / (2.0 * (0.6 * win) ** 2))
    c = corners.reshape(B, -1, 2)
    for _ in range(iters):
        px = c[..., 0, None, None] + DX  # (B,M,2w+1,2w+1)
        py = c[..., 1, None, None] + DY
        ggx, ggy = bilinear_sample_batch(grads, torch.stack([px, py], -1)).unbind(1)
        a = torch.sum(w * ggx * ggx, dim=(-2, -1))
        b = torch.sum(w * ggx * ggy, dim=(-2, -1))
        d = torch.sum(w * ggy * ggy, dim=(-2, -1))
        bx = torch.sum(w * (ggx * ggx * px + ggx * ggy * py), dim=(-2, -1))
        by = torch.sum(w * (ggx * ggy * px + ggy * ggy * py), dim=(-2, -1))
        det = a * d - b * b
        ok = det > 1e-9
        det_s = torch.where(ok, det, 1.0)
        c_new = torch.stack([(d * bx - b * by) / det_s, (a * by - b * bx) / det_s], -1)
        # trust region: reject divergent steps (flat or degenerate windows)
        step_ok = ok & (torch.linalg.vector_norm(c_new - c, dim=-1) < 2.0 * win)
        c = torch.where(step_ok[..., None], c_new, c)
    return c.reshape(corners.shape)


def _detect_core(img, codes4, bank_T, scales, max_det: int, n_angles: int,
                 score_thresh: float, min_bits: int):
    scores = ncc_stack(img, bank_T)
    peaks = _find_peaks(scores, scales, max_det, n_angles)
    tag_id, rot, n_match, black_ok = _decode(img, peaks["x"], peaks["y"], peaks["s"],
                                             peaks["theta"], codes4)
    valid = (peaks["score"] > score_thresh) & (n_match >= min_bits) & black_ok
    # corners at theta_full = theta + rot * 90 deg, canonical order preserved:
    # rotating the sample grid by theta_full maps canonical corner c to R c
    theta_full = peaks["theta"] + rot.to(img.dtype) * (math.pi / 2)
    Rm = _rotation(theta_full)
    local = torch.as_tensor(_CORNERS, dtype=img.dtype, device=img.device)
    cpix = (torch.stack([peaks["x"], peaks["y"]], -1)[..., None, :]
            + peaks["s"][..., None, None] * torch.einsum("bdij,cj->bdci", Rm, local))
    # the bank quantizes scale and angle to ~2 px corner error; the
    # gradient saddle fit recovers the true border corners
    cpix = refine_corners(img, cpix)
    return {"tag_id": tag_id, "corners": cpix, "valid": valid, "score": peaks["score"],
            "n_match": n_match, "x": peaks["x"], "y": peaks["y"], "s": peaks["s"],
            "theta": theta_full}


class TagDetector:
    """Detector facade holding the template bank and the code table on its
    device."""

    def __init__(self, codes=None, scales=(4.0, 5.5, 7.5), n_angles: int = 12,
                 max_det: int = 8, score_thresh: float = 0.18, min_bits: int = 15,
                 device=CUDA):
        self.device = checked_device(device)
        dev = self.device
        self.codes = tag_family() if codes is None else np.asarray(codes)
        self.codes4 = torch.as_tensor(_codes_rot4(self.codes).astype(np.int32), device=dev)
        self.scales = tuple(float(s) for s in scales)
        self.n_angles = n_angles
        self.max_det = max_det
        self.score_thresh = score_thresh
        self.min_bits = min_bits
        self.bank_T = [torch.as_tensor(T, device=dev)
                       for (T, K, a) in template_bank(scales, n_angles)]
        self._scales = torch.tensor(self.scales, dtype=F32, device=dev)

    def detect_batch(self, img):
        """img (B,H,W) float32 tensor in [0, 1] on the detector's device ->
        dict of (B, max_det) detection tensors, corners (B, max_det, 4, 2)
        in the canonical TL, TR, BR, BL order."""
        return _detect_core(img, self.codes4, self.bank_T, self._scales, self.max_det,
                            self.n_angles, self.score_thresh, self.min_bits)

    def detect(self, img):
        """One (H, W) image in [0, 1] (numpy or tensor) -> dict of (max_det,)
        detection tensors on the device, corners (max_det, 4, 2)."""
        x = torch.as_tensor(np.asarray(img, dtype=np.float32) if not torch.is_tensor(img)
                            else img).to(self.device, F32, non_blocking=True)[None]
        return {k: v[0] for k, v in self.detect_batch(x).items()}
