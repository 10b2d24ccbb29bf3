"""KLT front-end (port of plviwo_tpu/ops/klt.py), batch-first.

- `detect_grid`: Shi-Tomasi response -> per-grid-cell argmax with
  occupancy suppression -> the strongest cells first;
- `pyramidal_lk`: the gather form of inverse-compositional pyramidal LK,
  which the host KLT trackers run (`update/tracker.py`) and the images-in
  frame under `cam.fused_lk_conv=False`.
  JAX computes it in XLA outside any kernel, so plain torch is its port on
  the card too;
- `pyramidal_lk_conv`: the gather-free inverse-compositional pyramidal LK
  (patches + separable triangle taps).  It is the PLAIN VERSION of the
  hand kernel `csrc/lk_pyramid.cu` (`ops/lk_kernel.pyramidal_lk`), which is
  held to it;
- `ransac_fundamental`: batched eight-point hypotheses with inlier voting.

Every function takes a leading sequence axis B.  Ties break as in JAX:
`torch.argmax` and `torch.argsort(stable=True)` take the first index.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .image import bilinear_sample_batch, gradients, shi_tomasi_score

F32 = torch.float32


def _take(x, idx):
    """x (B,M) gathered at idx (B,...) along the second axis."""
    return torch.gather(x, 1, idx.reshape(idx.shape[0], -1)).reshape(idx.shape)


# ---------------------------------------------------------------------------
# detection
# ---------------------------------------------------------------------------

def detect_grid(img, occupied_uv, occupied_valid, grid_x: int, grid_y: int,
                n_max: int, min_score: float = 1e-4, min_px_dist: float = 8.0):
    """Grid-bucketed corner detection with occupancy suppression.

    img (B,H,W) f32; occupied_uv (B,M,2) existing features (masked by
    occupied_valid (B,M)), which new detections keep min_px_dist away from.
    Returns uv (B,n_max,2) and valid (B,n_max): the best corner per cell,
    strongest cells first."""
    B, H, W = img.shape
    dev = img.device
    score = shi_tomasi_score(img)
    yy = torch.arange(H, device=dev)[:, None]
    xx = torch.arange(W, device=dev)[None, :]
    b = 8
    score = torch.where((xx < b) | (xx >= W - b) | (yy < b) | (yy >= H - b), -1.0, score)

    # occupancy: truncation toward zero, as astype(int32), then a max-scatter
    ou = torch.clamp(occupied_uv[..., 0].to(torch.int64), 0, W - 1)
    ov = torch.clamp(occupied_uv[..., 1].to(torch.int64), 0, H - 1)
    occ = torch.zeros((B, H * W), dtype=F32, device=dev)
    occ = occ.scatter_reduce(1, ov * W + ou, occupied_valid.to(F32), "amax")
    # separable square dilation; the values are >= 0, so max_pool2d's -inf
    # padding equals JAX's zero-initialized reduce_window
    k = int(min_px_dist)
    occ = F.max_pool2d(occ.view(B, 1, H, W), (2 * k + 1, 1), stride=1, padding=(k, 0))
    occ = F.max_pool2d(occ, (1, 2 * k + 1), stride=1, padding=(0, k))[:, 0]
    score = torch.where(occ > 0, -1.0, score)

    ch, cw = H // grid_y, W // grid_x
    G = grid_y * grid_x
    sc = score[:, :ch * grid_y, :cw * grid_x].reshape(B, grid_y, ch, grid_x, cw)
    sc = sc.permute(0, 1, 3, 2, 4).reshape(B, G, ch * cw)
    cell_best = torch.argmax(sc, dim=-1)
    cell_score = torch.amax(sc, dim=-1)
    g = torch.arange(G, device=dev)
    u = ((g % grid_x) * cw + cell_best % cw).to(F32)
    v = ((g // grid_x) * ch + cell_best // cw).to(F32)

    # subpixel refinement: 1-D quadratic fit of the score along each axis
    ui = torch.clamp(u.to(torch.int64), 1, W - 2)
    vi = torch.clamp(v.to(torch.int64), 1, H - 2)
    flat = score.reshape(B, H * W)

    def at(y, x):
        return _take(flat, y * W + x)

    def refine(sc_m, sc_0, sc_p):
        denom = sc_m - 2.0 * sc_0 + sc_p
        off = torch.where(torch.abs(denom) > 1e-9, 0.5 * (sc_m - sc_p) / denom, 0.0)
        return torch.clamp(off, -0.5, 0.5)

    s0 = at(vi, ui)
    u = u + refine(at(vi, ui - 1), s0, at(vi, ui + 1))
    v = v + refine(at(vi - 1, ui), s0, at(vi + 1, ui))

    order = torch.argsort(-cell_score, dim=-1, stable=True)[:, :n_max]
    uv = torch.stack([_take(u, order), _take(v, order)], dim=-1)
    return uv, _take(cell_score, order) > min_score


# ---------------------------------------------------------------------------
# pyramidal Lucas-Kanade, the gather form
# ---------------------------------------------------------------------------

def _lk_level(img_prev, img_next, uv_prev, uv_guess, half: int, iters: int):
    """One pyramid level of inverse-compositional LK for all features.

    img_prev, img_next (B,H,W); uv_prev (B,N,2) template centers in
    img_prev; uv_guess (B,N,2) the estimates in img_next.  The template and
    its gradients are one bilinear gather of the W x W window around each
    center, and every iteration gathers the window at the current estimate
    anew (no patch, no drift budget).  Returns (uv, err, good, inb)."""
    W = 2 * half + 1
    r = torch.arange(-half, half + 1, dtype=uv_prev.dtype, device=uv_prev.device)
    offs = torch.stack([r.repeat(W), r.repeat_interleave(W)], dim=-1)  # (W^2,2), x fastest
    gx, gy = gradients(img_prev)
    fields = torch.stack([img_prev, gx, gy], dim=1)
    T, Gx, Gy = bilinear_sample_batch(fields, uv_prev[..., None, :] + offs).unbind(1)
    # 2x2 normal matrix (inverse compositional: the template's gradients)
    a = torch.sum(Gx * Gx, dim=-1)
    b_ = torch.sum(Gx * Gy, dim=-1)
    c = torch.sum(Gy * Gy, dim=-1)
    det = a * c - b_ * b_
    good = det > 1e-6
    bad = det < 1e-8
    det_s = torch.where(bad, 1.0, det)
    nxt = img_next[:, None]

    def window(uv):
        return bilinear_sample_batch(nxt, uv[..., None, :] + offs)[:, 0]

    uv = uv_guess
    for _ in range(iters):
        e = window(uv) - T
        bx = torch.sum(Gx * e, dim=-1)
        by = torch.sum(Gy * e, dim=-1)
        dx = torch.where(bad, 0.0, (c * bx - b_ * by) / det_s)
        dy = torch.where(bad, 0.0, (-b_ * bx + a * by) / det_s)
        uv = uv - torch.stack([dx, dy], dim=-1)
    err = torch.mean(torch.abs(window(uv) - T), dim=-1)
    H, Wd = img_next.shape[-2:]
    inb = ((uv[..., 0] > half) & (uv[..., 0] < Wd - half - 1)
           & (uv[..., 1] > half) & (uv[..., 1] < H - half - 1))
    return uv, err, good, inb


def pyramidal_lk(prev_pyr, next_pyr, uv_prev, valid, levels: int, half: int = 7,
                 iters: int = 10, max_err: float = 0.08):
    """Track features from prev to next through the pyramid, coarse to fine
    (the gather form; the JAX host tracker's LK).

    prev_pyr/next_pyr: sequences of (B, H/2^l, W/2^l) f32 images; uv_prev
    (B,N,2) f32; valid (B,N).  Returns (uv_next (B,N,2), ok (B,N)).  No host
    read."""
    uv = uv_prev / 2.0 ** (levels - 1)
    ok = valid
    for l in range(levels - 1, -1, -1):
        uv, err, good, inb = _lk_level(prev_pyr[l], next_pyr[l], uv_prev / 2.0**l, uv,
                                       half, iters)
        # a degenerate template at a coarse level leaves the estimate as it
        # is; only the finest level's conditioning kills the track
        ok = ok & inb & (good if l == 0 else True)
        if l > 0:
            uv = uv * 2.0
    return uv, ok & (err < max_err)


# ---------------------------------------------------------------------------
# gather-free pyramidal Lucas-Kanade (the plain version of the LK kernel)
# ---------------------------------------------------------------------------

def _patch_sample(P, u_y, u_x, out_h: int, out_w: int, D: int):
    """Separable triangle-tap window sample from per-feature patches.

    P (B,N,PS,PS); u_y, u_x (B,N) window start offsets inside the patch.
    Returns (B,N,out_h,out_w) sampled at rows u_y + r, cols u_x + c, with
    the KS = 2D+3 taps of the JAX package (exact bilinear wherever
    0 <= u <= PS - out - 1)."""
    KS = 2 * D + 3
    taps = torch.arange(KS, dtype=P.dtype, device=P.device)
    wy = torch.clamp(1.0 - torch.abs(u_y[..., None] - taps), min=0.0)  # (B,N,KS)
    wx = torch.clamp(1.0 - torch.abs(u_x[..., None] - taps), min=0.0)
    B, N, PS, _ = P.shape
    A = torch.zeros((B, N, out_h, PS), dtype=P.dtype, device=P.device)
    for j in range(KS):
        A = A + P[:, :, j:j + out_h, :] * wy[..., j, None, None]
    out = torch.zeros((B, N, out_h, out_w), dtype=P.dtype, device=P.device)
    for i in range(KS):
        out = out + A[..., i:i + out_w] * wx[..., i, None, None]
    return out


def _extract_patches(img, oy, ox, PS: int):
    """img (B,H,W), integer origins (B,N) -> patches (B,N,PS,PS)."""
    B, H, W = img.shape
    r = torch.arange(PS, device=img.device)
    idx = (oy[..., None, None] + r[:, None]) * W + (ox[..., None, None] + r)
    return _take(img.reshape(B, H * W), idx)


def _origin(x, off: int, hi: int):
    """Integer patch origin floor(x) - off, clipped to [0, hi]."""
    return torch.clamp(torch.floor(x).to(torch.int64) - off, 0, hi)


def _lk_level_conv(img_prev, img_next, uv_prev, uv_guess, half: int,
                   iters: int, drift: int = 5):
    """One pyramid level of IC-LK.  Returns (uv, err, good, inb, det)."""
    W = 2 * half + 1
    D = drift
    PS = W + 2 * D + 4  # extended (W+2) window + KS - 1 taps
    H, Wd = img_next.shape[-2:]
    f32 = img_prev.dtype

    # template patch: origin so the extended window starts near u = D + 1
    oxp = _origin(uv_prev[..., 0], half + 1 + D + 1, Wd - PS)
    oyp = _origin(uv_prev[..., 1], half + 1 + D + 1, H - PS)
    Pp = _extract_patches(img_prev, oyp, oxp, PS)
    uty = uv_prev[..., 1] - oyp.to(f32) - (half + 1)
    utx = uv_prev[..., 0] - oxp.to(f32) - (half + 1)
    T_ext = _patch_sample(Pp, uty, utx, W + 2, W + 2, D)
    T = T_ext[..., 1:-1, 1:-1]
    Gx = 0.5 * (T_ext[..., 1:-1, 2:] - T_ext[..., 1:-1, :-2])
    Gy = 0.5 * (T_ext[..., 2:, 1:-1] - T_ext[..., :-2, 1:-1])
    a = torch.sum(Gx * Gx, dim=(-2, -1))
    b_ = torch.sum(Gx * Gy, dim=(-2, -1))
    c = torch.sum(Gy * Gy, dim=(-2, -1))
    det = a * c - b_ * b_
    bad = det < 1e-8
    det_s = torch.where(bad, 1.0, det)

    # target patch: fixed integer origin from the initial guess; iterations
    # move only the continuous offset within the patch
    oxg = _origin(uv_guess[..., 0], half + D + 1, Wd - PS)
    oyg = _origin(uv_guess[..., 1], half + D + 1, H - PS)
    Pn = _extract_patches(img_next, oyg, oxg, PS)
    og = torch.stack([oxg, oyg], dim=-1).to(f32)

    uv = uv_guess
    for _ in range(iters):
        u = uv - og - half
        e = _patch_sample(Pn, u[..., 1], u[..., 0], W, W, D) - T
        bx = torch.sum(Gx * e, dim=(-2, -1))
        by = torch.sum(Gy * e, dim=(-2, -1))
        dx = torch.where(bad, 0.0, (c * bx - b_ * by) / det_s)
        dy = torch.where(bad, 0.0, (-b_ * bx + a * by) / det_s)
        uv = uv - torch.stack([dx, dy], dim=-1)

    u = uv - og - half
    in_patch = ((u[..., 0] >= 0.0) & (u[..., 0] <= PS - W - 1)
                & (u[..., 1] >= 0.0) & (u[..., 1] <= PS - W - 1))
    I = _patch_sample(Pn, u[..., 1], u[..., 0], W, W, D)
    err = torch.mean(torch.abs(I - T), dim=(-2, -1))
    inb = ((uv[..., 0] > half) & (uv[..., 0] < Wd - half - 1)
           & (uv[..., 1] > half) & (uv[..., 1] < H - half - 1)) & in_patch
    return uv, err, det > 1e-6, inb, det


def pyramidal_lk_conv_full(prev_pyr, next_pyr, uv_prev, valid, levels: int,
                           half: int = 7, iters: int = 10, max_err: float = 0.08,
                           drift: int = 5, drift_fine: int = 2):
    """`pyramidal_lk_conv` that also returns the finest level's mean |I-T|
    error and template determinant: (uv, ok, err, det)."""
    uv = uv_prev / 2.0 ** (levels - 1)
    ok = valid
    for l in range(levels - 1, -1, -1):
        D = drift if l == levels - 1 else drift_fine
        uv, err, good, inb, det = _lk_level_conv(prev_pyr[l], next_pyr[l],
                                                 uv_prev / 2.0**l, uv, half, iters, D)
        # a degenerate template at a coarse level leaves the estimate as it
        # is; only the finest level's conditioning kills the track
        ok = ok & inb & (good if l == 0 else True)
        if l > 0:
            uv = uv * 2.0
    return uv, ok & (err < max_err), err, det


def pyramidal_lk_conv(prev_pyr, next_pyr, uv_prev, valid, levels: int,
                      half: int = 7, iters: int = 10, max_err: float = 0.08,
                      drift: int = 5, drift_fine: int = 2):
    """Track features from prev to next through the pyramid, coarse to fine.

    prev_pyr/next_pyr: tuples of (B, H/2^l, W/2^l) f32 images; uv_prev
    (B,N,2) f32; valid (B,N).  Returns (uv_next (B,N,2), ok (B,N)).
    Features whose per-level motion exceeds the drift budget (D = drift at
    the coarsest level, drift_fine below) are marked failed."""
    return pyramidal_lk_conv_full(prev_pyr, next_pyr, uv_prev, valid, levels, half,
                                  iters, max_err, drift, drift_fine)[:2]


# ---------------------------------------------------------------------------
# RANSAC fundamental-matrix gate
# ---------------------------------------------------------------------------

def _eight_point(x1, x2):
    """F (...,3,3) from 8 normalized correspondences x1, x2 (...,8,2).

    The nullspace of the 8x9 system A is its vector of signed 8x8 minors
    (no eigensolver: `torch.linalg.eigh` waits for the device on CUDA).
    It is the direction of JAX's smallest eigenvector of A^T A, scaled to
    unit norm as that one is; its sign does not matter (`_epi_dist` takes
    |.|)."""
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    A = torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1,
                     torch.ones_like(u1)], dim=-1)  # (...,8,9)
    i = torch.arange(8, device=A.device)
    j = torch.arange(9, device=A.device)[:, None]
    cols = i + (i >= j).to(i.dtype)  # (9,8): the columns of each minor
    minors = A[..., cols].movedim(-3, -2)  # (...,9,8,8)
    f = torch.linalg.det(minors) * (1 - 2 * (j[:, 0] % 2)).to(A.dtype)
    f = f / torch.linalg.vector_norm(f, dim=-1, keepdim=True)
    return f.reshape(f.shape[:-1] + (3, 3))


def _epi_dist(F, x1, x2):
    """Symmetric epipolar distance: F (B,H,3,3), x1, x2 (B,N,2) -> (B,H,N)."""
    ones = torch.ones_like(x1[..., :1])
    p1 = torch.cat([x1, ones], dim=-1)
    p2 = torch.cat([x2, ones], dim=-1)
    l2 = torch.einsum("bnk,bhjk->bhnj", p1, F)  # lines in image 2
    l1 = torch.einsum("bnk,bhkj->bhnj", p2, F)
    num = torch.abs(torch.sum(p2[:, None] * l2, dim=-1))
    d2 = num / torch.sqrt(l2[..., 0] ** 2 + l2[..., 1] ** 2 + 1e-12)
    d1 = num / torch.sqrt(l1[..., 0] ** 2 + l1[..., 1] ** 2 + 1e-12)
    return torch.maximum(d1, d2)


def _i64(c: int) -> int:
    """A 64-bit constant as the int64 with the same bits."""
    return c - (1 << 64) if c >= 1 << 63 else c


_GOLDEN, _MIX1, _MIX2 = (_i64(0x9E3779B97F4A7C15), _i64(0xBF58476D1CE4E5B9),
                         _i64(0x94D049BB133111EB))


def _srl(x, s: int):
    """Logical right shift of int64 x by s bits."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def splitmix64(x):
    """splitmix64's output function on int64 tensors (arithmetic wraps mod
    2^64): a bijection of the 64-bit words that mixes every input bit."""
    x = x + _GOLDEN
    x = (x ^ _srl(x, 30)) * _MIX1
    x = (x ^ _srl(x, 27)) * _MIX2
    return x ^ _srl(x, 31)


def draw_hypotheses(key, counter, n_hyp: int, n: int):
    """The RANSAC draws: (r0, s) (B, n_hyp) int64 in [0, n).

    key, counter: (B,) int64, each sequence's key and frame counter.  A
    stateless counter hash: draw i of stream z (0: r0, 1: s) of sequence b
    is the top 63 bits of splitmix64(splitmix64(splitmix64(key[b]) ^
    counter[b]) ^ (z n_hyp + i)) mod n, so it depends on that sequence's key
    and counter only, never on the batch, and the same inputs give the same
    draws.  JAX draws them from its threefry PRNG, which this does not
    reproduce; the parity tests replace this function with one that replays
    JAX's draws."""
    base = splitmix64(splitmix64(key) ^ counter)
    j = torch.arange(2 * n_hyp, device=key.device)
    r = torch.remainder(_srl(splitmix64(base[:, None] ^ j), 1), n)
    return r[:, :n_hyp], r[:, n_hyp:]


def ransac_fundamental(x1, x2, valid, key, counter, n_hyp: int = 64,
                       thresh: float = 2e-3):
    """Batched-hypothesis RANSAC on the fundamental matrix.

    x1, x2 (B,N,2) undistorted normalized correspondences; valid (B,N);
    key, counter (B,) int64, the hypotheses' key and frame counter per
    sequence (`draw_hypotheses`).  Returns the inlier mask (B,N) of the
    best hypothesis, or `valid` where no hypothesis has 8 inliers."""
    B, N = valid.shape
    # 8 distinct valid correspondences per hypothesis: an arithmetic
    # progression in compacted (valid-first) index space
    n_valid = torch.clamp(torch.sum(valid, dim=-1), min=9)[:, None]
    order = torch.argsort((~valid).to(torch.int32), dim=-1, stable=True)
    r0, s = draw_hypotheses(key, counter, n_hyp, N)
    r0 = r0.to(n_valid.device) % n_valid
    smax = torch.clamp((n_valid - 1) // 8, min=1)
    s = 1 + s.to(n_valid.device) % smax
    pos = (r0[..., None] + s[..., None] * torch.arange(8, device=valid.device)) % n_valid[..., None]
    idx = _take(order, pos)  # (B,n_hyp,8)
    X1 = torch.stack([_take(x1[..., 0], idx), _take(x1[..., 1], idx)], dim=-1)
    X2 = torch.stack([_take(x2[..., 0], idx), _take(x2[..., 1], idx)], dim=-1)
    inl = (_epi_dist(_eight_point(X1, X2), x1, x2) < thresh) & valid[:, None]
    scores = torch.sum(inl, dim=-1)
    best = torch.argmax(scores, dim=-1)
    pick = torch.gather(inl, 1, best[:, None, None].expand(B, 1, N))[:, 0]
    ok = torch.gather(scores, 1, best[:, None])[:, 0] >= 8
    return torch.where(ok[:, None], pick, valid)
