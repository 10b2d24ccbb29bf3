"""The port's image front-end (L0/L1 ops) against the JAX package, on the CPU.

`plviwo_tpu_torch.ops.{cam,image,klt}` (batch-first) against
`plviwo_tpu.ops.{cam,image,klt}` and the Pallas LK kernel in interpret
mode, on the same numpy inputs.  The CUDA LK kernel is held to the port's
plain version in tests/test_torch_cuda.py (card only, jax-free).

Tolerances: `undistort` 1e-10 (float64 Newton, another autodiff for the
2x2 Jacobian); image ops 1e-6 abs (float32, the same multiply-adds);
`detect_grid` equal `valid`, uv 1e-4 px (the subpixel fit divides score
differences of ~1e-9); plain LK the bounds of tests/test_lk_kernel.py
(median |duv| < 1e-3 px, max < 0.05 px, >= 80% of the features accepted
by both); RANSAC an equal inlier mask with JAX's draws replayed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plviwo_tpu.ops import cam as jcam
from plviwo_tpu.ops import image as jimg
from plviwo_tpu.ops import klt as jklt
from plviwo_tpu.ops.lk_kernel import pyramidal_lk_pallas
from plviwo_tpu_torch.ops import cam as tcam
from plviwo_tpu_torch.ops import image as timg
from plviwo_tpu_torch.ops import klt as tklt
from plviwo_tpu_torch.ops import lk_kernel
from tests.test_lk_kernel import _scene

torch.set_num_threads(1)
K_RADTAN = (300.0, 310.0, 320.0, 240.0, -0.05, 0.01, 0.0005, -0.0002)
K_EQUI = (280.0, 285.0, 318.0, 242.0, 0.02, -0.01, 0.003, -0.001)


def _t(a):
    """numpy -> torch with a leading batch axis of 1."""
    return torch.as_tensor(np.asarray(a))[None]


def _image(seed, H=96, W=128):
    """A smooth random image in [0, 1] (float32)."""
    from scipy.signal import convolve2d

    rng = np.random.default_rng(seed)
    base = rng.uniform(0.0, 1.0, size=(H, W))
    return np.clip(convolve2d(base, np.ones((3, 3)) / 9.0, mode="same"), 0, 1).astype(np.float32)


@pytest.mark.parametrize("model,k", [(tcam.RADTAN, K_RADTAN), (tcam.EQUI, K_EQUI)])
def test_undistort_matches_jax(model, k):
    rng = np.random.default_rng(3 + model)
    uv = np.stack([rng.uniform(5, 635, 200), rng.uniform(5, 475, 200)], -1)
    want = np.asarray(jcam.undistort(jnp.asarray(uv), jnp.asarray(k), model))
    got = tcam.undistort(_t(uv), torch.tensor(k, dtype=torch.float64)[None, None], model)
    np.testing.assert_allclose(got[0].numpy(), want, rtol=0, atol=1e-10)
    # the Newton solve inverts the distortion
    back = tcam.distort(got, torch.tensor(k, dtype=torch.float64), model)
    np.testing.assert_allclose(back[0].numpy(), uv, atol=1e-6)


IMAGE_OPS = {
    "pyr_down": lambda m, x: m.pyr_down(x),
    "build_pyramid": lambda m, x: m.build_pyramid(x, 3),
    "gradients": lambda m, x: m.gradients(x),
    "shi_tomasi_score": lambda m, x: m.shi_tomasi_score(x),
    "hist_equalize_quantile": lambda m, x: m.hist_equalize_quantile(x),
    "gauss_blur": lambda m, x: m.gauss_blur(x),
}


@pytest.mark.parametrize("name", sorted(IMAGE_OPS))
def test_image_op_matches_jax(name):
    fn = IMAGE_OPS[name]
    imgs = [_image(s) for s in (0, 1)]
    want = [fn(jimg, jnp.asarray(im)) for im in imgs]
    got = fn(timg, torch.as_tensor(np.stack(imgs)))  # B = 2 in one call
    flat_w = [jax.tree.leaves(w) for w in want]
    flat_g = got if isinstance(got, (list, tuple)) else [got]
    for b in range(2):
        assert len(flat_w[b]) == len(flat_g)
        for w, g in zip(flat_w[b], flat_g):
            assert g.dtype == torch.float32
            np.testing.assert_allclose(g[b].numpy(), np.asarray(w), rtol=0, atol=1e-6)


def test_detect_grid_matches_jax():
    img = _image(4, 240, 320)
    rng = np.random.default_rng(4)
    occ = np.stack([rng.uniform(0, 320, 150), rng.uniform(0, 240, 150)], -1).astype(np.float32)
    occ_valid = rng.uniform(size=150) < 0.8
    # all 192 cells: the occupied ones come last, suppressed (tied scores)
    uv_j, ok_j = jklt.detect_grid(jnp.asarray(img), jnp.asarray(occ), jnp.asarray(occ_valid),
                                  16, 12, 192, min_px_dist=10.0)
    uv_t, ok_t = tklt.detect_grid(_t(img), _t(occ), _t(occ_valid), 16, 12, 192,
                                  min_px_dist=10.0)
    np.testing.assert_array_equal(ok_t[0].numpy(), np.asarray(ok_j))
    assert 40 < int(ok_j.sum()) < 192
    np.testing.assert_allclose(uv_t[0].numpy(), np.asarray(uv_j), rtol=0, atol=1e-4)


def _assert_lk_close(uv_a, ok_a, uv_b, ok_b, n):
    okb = ok_a & ok_b
    assert okb.sum() >= 0.8 * n, (okb.sum(), n)
    d = np.linalg.norm(uv_a - uv_b, axis=-1)[okb]
    assert float(np.median(d)) < 1e-3, float(np.median(d))
    assert float(d.max()) < 0.05, float(d.max())


@pytest.mark.parametrize("seed,n,levels", [(0, 64, 3), (2, 100, 2)])
def test_plain_lk_matches_jax(seed, n, levels):
    """The kernel's plain version against JAX's Pallas kernel (interpret
    mode) and its XLA conv formulation, on tests/test_lk_kernel.py's scene
    (N = 100 is not a multiple of the Pallas lane block)."""
    img0, img1, uv = _scene(seed, n=n)
    pyr0 = tuple(jimg.build_pyramid(img0, levels))
    pyr1 = tuple(jimg.build_pyramid(img1, levels))
    valid = jnp.ones(n, bool)
    uv_p, ok_p = pyramidal_lk_pallas(pyr0, pyr1, uv, valid, levels, iters=6, interpret=True)
    uv_c, ok_c = jklt.pyramidal_lk_conv(pyr0, pyr1, uv, valid, levels, iters=6)
    before = lk_kernel.lk_pyramid.launches
    uv_t, ok_t = lk_kernel.pyramidal_lk(tuple(_t(p) for p in pyr0), tuple(_t(p) for p in pyr1),
                                        _t(uv), _t(valid), levels, iters=6)
    assert lk_kernel.lk_pyramid.launches == before  # CPU tensors: the plain version
    assert uv_t.shape == (1, n, 2) and ok_t.dtype == torch.bool
    for uv_j, ok_j in ((uv_p, ok_p), (uv_c, ok_c)):
        _assert_lk_close(uv_t[0].numpy(), ok_t[0].numpy(), np.asarray(uv_j), np.asarray(ok_j), n)
    flow = (uv_t[0].numpy() - np.asarray(uv))[ok_t[0].numpy()]
    np.testing.assert_allclose(np.median(flow, axis=0), [-2.3, 1.4], atol=0.1)


def test_plain_lk_batch_matches_per_sequence():
    """A B = 3 batch of different scenes against per-sequence calls of the
    port and of JAX's conv formulation."""
    scenes = [_scene(s, shift=(1.0 + s, -0.5 * s)) for s in range(3)]
    pyrs = [[jimg.build_pyramid(im, 3) for im in s[:2]] for s in scenes]
    batch = [tuple(torch.as_tensor(np.stack([np.asarray(p[i][l]) for p in pyrs]))
                   for l in range(3)) for i in range(2)]
    uv = torch.as_tensor(np.stack([np.asarray(s[2]) for s in scenes]))
    valid = torch.ones(uv.shape[:2], dtype=torch.bool)
    uv_b, ok_b = tklt.pyramidal_lk_conv(batch[0], batch[1], uv, valid, 3, iters=6)
    for s in range(3):
        uv_s, ok_s = tklt.pyramidal_lk_conv(tuple(p[s:s + 1] for p in batch[0]),
                                            tuple(p[s:s + 1] for p in batch[1]),
                                            uv[s:s + 1], valid[s:s + 1], 3, iters=6)
        np.testing.assert_array_equal(ok_b[s].numpy(), ok_s[0].numpy())
        np.testing.assert_allclose(uv_b[s].numpy(), uv_s[0].numpy(), rtol=0, atol=1e-5)
        uv_j, ok_j = jklt.pyramidal_lk_conv(tuple(pyrs[s][0]), tuple(pyrs[s][1]),
                                            jnp.asarray(uv[s].numpy()), jnp.ones(64, bool), 3,
                                            iters=6)
        _assert_lk_close(uv_b[s].numpy(), ok_b[s].numpy(), np.asarray(uv_j), np.asarray(ok_j), 64)
        flow = (uv_b[s] - uv[s]).numpy()[ok_b[s].numpy()]
        np.testing.assert_allclose(np.median(flow, axis=0), [-(1.0 + s), 0.5 * s], atol=0.15)


def test_ransac_matches_jax_with_replayed_draws(monkeypatch):
    rng = np.random.default_rng(7)
    n = 80
    # correspondences of a rigid motion seen by a normalized camera, plus
    # outliers and invalid entries
    P = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(4, 9, n)], -1)
    th = 0.05
    R = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0], [-np.sin(th), 0, np.cos(th)]])
    P2 = P @ R.T + np.array([0.3, 0.02, 0.1])
    x1 = P[:, :2] / P[:, 2:] + 2e-4 * rng.normal(size=(n, 2))
    x2 = P2[:, :2] / P2[:, 2:] + 2e-4 * rng.normal(size=(n, 2))
    x2[:10] += rng.uniform(-0.05, 0.05, size=(10, 2))
    valid = rng.uniform(size=n) < 0.9
    key = jax.random.PRNGKey(11)
    want = np.asarray(jklt.ransac_fundamental(jnp.asarray(x1), jnp.asarray(x2),
                                              jnp.asarray(valid), key))
    k1, k2 = jax.random.split(key)

    def replay(key, counter, n_hyp, n_pts):
        draw = [np.asarray(jax.random.randint(k, (n_hyp, 1), 0, n_pts))[:, 0] for k in (k1, k2)]
        return tuple(torch.as_tensor(d)[None].long() for d in draw)

    monkeypatch.setattr(tklt, "draw_hypotheses", replay)
    got = tklt.ransac_fundamental(_t(x1), _t(x2), _t(valid), torch.tensor([11]), torch.tensor([0]))
    np.testing.assert_array_equal(got[0].numpy(), want)
    assert 40 < int(want.sum()) < int(valid.sum())  # the outliers are gated out


def test_ransac_draws_come_from_the_generator():
    """Without a replay the draws come from the port's generator, a
    stateless hash of each sequence's key and frame counter: the same key
    and counter give the same draws and inlier mask, sequence b of a batch
    draws as it would alone, and another counter or key draws anew."""
    key, counter = torch.tensor([5, 6, 7]), torch.tensor([0, 3, 9])
    r0, s = tklt.draw_hypotheses(key, counter, 64, 40)
    for b in range(3):
        alone = tklt.draw_hypotheses(key[b:b + 1], counter[b:b + 1], 64, 40)
        assert torch.equal(alone[0][0], r0[b]) and torch.equal(alone[1][0], s[b])
    assert r0.shape == s.shape == (3, 64) and int(r0.min()) >= 0 and int(r0.max()) < 40
    assert not torch.equal(tklt.draw_hypotheses(key, counter + 1, 64, 40)[0], r0)
    assert not torch.equal(r0[0], r0[1])
    rng = np.random.default_rng(8)
    x1 = _t(rng.normal(scale=0.3, size=(2, 40, 2))[0])
    x2 = x1 + 0.01
    valid = torch.ones((1, 40), dtype=torch.bool)
    masks = [tklt.ransac_fundamental(x1, x2, valid, key[:1], counter[:1]) for _ in range(2)]
    assert torch.equal(masks[0], masks[1])


def test_splitmix64_matches_the_reference():
    """The hash's int64 arithmetic wraps as 64-bit words do (reference:
    splitmix64 on Python integers; its first output from seed 0 is
    0xE220A8397B1DCDAF)."""
    mask = (1 << 64) - 1

    def ref(x):
        z = (x + 0x9E3779B97F4A7C15) & mask
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & mask
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & mask
        return z ^ (z >> 31)

    xs = [0, 1, 12345, (1 << 63) - 1, -1, -(1 << 63), 987654321987]
    got = tklt.splitmix64(torch.tensor(xs, dtype=torch.int64)).tolist()
    assert [g & mask for g in got] == [ref(x & mask) for x in xs]
    assert ref(0) == 0xE220A8397B1DCDAF
