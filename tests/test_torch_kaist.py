"""The port's KAIST replay path against the JAX package, on the CPU.

The PNG codec (`data/png.py`) against Pillow, the YAML parser and
`load_options` (`config/yaml_io.py`) against PyYAML and the JAX package's
loader, the native library (`native.py`: the C++ feature store and CSV
parser) against JAX's ctypes wrapper and the Python store and parser,
`KaistDataset`, the synthetic fixture, the TUM / timing files, and
`run_kaist` on the CPU.

Tolerances: everything compared here is exact.  The PNG reader equals
Pillow's decode (`convert("L")` for RGB) pixel for pixel on Pillow-written
files, which mix all five row filters, and Pillow reads the writer's files
back equal; other formats raise naming the format.  The YAML parser, with
PyYAML hidden, equals `yaml.safe_load` on every file under configs/kaist/
and on tests/test_kaist_e2e.py's layered config; `load_options` equals
JAX's field by field, the precedence case of tests/test_kaist_e2e.py
included.  The C++ store's exports equal JAX's wrapper's on the same
library and a Python selection over `update/feature_db.FeatureDatabase`;
`load_csv` equals the Python parse.  `KaistDataset` equals JAX's on
tests/test_kaist.py's mini dataset and on the small fixture (images read
by the port's codec against Pillow's).  The port's small fixture
(tests/test_kaist_e2e.py::kaist_fixture_small's settings) writes JAX's CSV
bytes and pixels.  `run_kaist --device cpu` over it exits 0 with JAX's
summary keys plus the device.  The slow test holds the port alone to
tests/test_kaist_e2e.py::test_run_kaist_e2e's gates.
"""

import contextlib
import dataclasses
import filecmp
import io
import json
import os
import sys
import threading

import numpy as np
import pytest
import yaml
from PIL import Image

from plviwo_tpu import native as j_native
from plviwo_tpu.config.options import Options as JOptions
from plviwo_tpu.config.yaml_io import load_options as j_load_options
from plviwo_tpu.data.kaist import KaistDataset as JKaistDataset
from plviwo_tpu.eval import loader as j_loader
from plviwo_tpu.sim.kaist_fixture import generate_kaist_fixture as j_generate
from plviwo_tpu.sim.simulator import SimConfig as JSimConfig
from plviwo_tpu.sim.simulator import Simulator as JSimulator
from plviwo_tpu_torch import native, run_kaist
from plviwo_tpu_torch.config.options import Options
from plviwo_tpu_torch.config.yaml_io import YamlError, load_options, parse_yaml
from plviwo_tpu_torch.data import kaist, png
from plviwo_tpu_torch.eval import loader
from plviwo_tpu_torch.ops import lk_kernel
from plviwo_tpu_torch.sim.kaist_fixture import (enu_to_geodetic, generate_kaist_fixture,
                                                write_fixture_config)
from plviwo_tpu_torch.sim.simulator import SimConfig, Simulator
from plviwo_tpu_torch.update.feature_db import FeatureDatabase
from plviwo_tpu_torch.update.gps import geodetic_to_enu
from tests.test_kaist import _make_mini_dataset
from tests.test_kaist_e2e import _write_config

CONFIGS = os.path.join(os.path.dirname(__file__), "..", "configs", "kaist")
# tests/test_kaist_e2e.py::kaist_fixture_small
SMALL_SIM = dict(duration=7.0, n_landmarks=150, n_lines=20, width=320, height=240, seed=5)
SMALL_FIXTURE = dict(t_start=1.0, duration=4.0, cam_hz=3.0)
CSVS = ("sensor_data/xsens_imu.csv", "sensor_data/encoder.csv", "sensor_data/vrs_gps.csv",
        "sensor_data/data_stamp.csv", "calibration/EncoderParameter.txt", "global_pose.csv")
JAX_RUN_KAIST_KEYS = {"frames", "clones", "updates", "wall_s", "fps", "ate_rmse_m"}


# --- the PNG codec ------------------------------------------------------------

def _gray(shape, seed):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[:shape[0], :shape[1]]
    img = (np.sin(x / 7.0) + np.cos(y / 5.0)) * 60 + 128 + rng.normal(0, 8, shape)
    return img.clip(0, 255).astype(np.uint8)


@pytest.mark.parametrize("shape", [(1, 1), (48, 64), (120, 97)])
def test_png_reads_what_pillow_writes(tmp_path, shape):
    g = _gray(shape, 0)
    path = str(tmp_path / "g.png")
    Image.fromarray(g).save(path)
    assert np.array_equal(png.read_gray(path), g)
    rgb = np.stack([g, np.roll(g, 3, axis=-1), 255 - g], axis=-1)
    rgb[0, 0] = [255, 255, 255]
    Image.fromarray(rgb).save(path)
    assert np.array_equal(png.read_gray(path), np.asarray(Image.open(path).convert("L")))


def test_png_rgb_luma_is_pillows(tmp_path):
    rgb = np.random.default_rng(1).integers(0, 256, (64, 64, 3), dtype=np.uint8)
    path = str(tmp_path / "c.png")
    Image.fromarray(rgb).save(path)
    assert np.array_equal(png.read_gray(path), np.asarray(Image.open(path).convert("L")))


def test_png_writes_what_pillow_reads(tmp_path):
    g = _gray((37, 53), 2)
    path = str(tmp_path / "w.png")
    png.write_gray(path, g)
    im = Image.open(path)
    assert im.mode == "L" and np.array_equal(np.asarray(im), g)
    assert np.array_equal(png.read_gray(path), g)
    with pytest.raises(ValueError, match="uint8"):
        png.write_gray(path, g.astype(np.float32))


@pytest.mark.parametrize("mode,what", [("P", "palette"), ("RGBA", "RGBA"),
                                       ("LA", "grayscale\\+alpha"), ("I;16", "16-bit")])
def test_png_refuses_other_formats(tmp_path, mode, what):
    path = str(tmp_path / "x.png")
    Image.fromarray(_gray((8, 8), 3)).convert(mode).save(path)
    with pytest.raises(ValueError, match=what):
        png.read_gray(path)
    (tmp_path / "n.png").write_bytes(b"not a png")
    with pytest.raises(ValueError, match="not a PNG"):
        png.read_gray(str(tmp_path / "n.png"))


# --- YAML and the options ------------------------------------------------------

def _config_files(tmp_path):
    master = write_fixture_config(str(tmp_path), SimConfig(**SMALL_SIM))
    return ([os.path.join(CONFIGS, f) for f in sorted(os.listdir(CONFIGS))]
            + [os.path.join(tmp_path, f) for f in sorted(os.listdir(tmp_path))]), master


def test_yaml_parser_matches_pyyaml(tmp_path, monkeypatch):
    files, _ = _config_files(tmp_path)
    want = {f: yaml.safe_load(open(f)) for f in files}
    monkeypatch.setitem(sys.modules, "yaml", None)  # the parser does without PyYAML
    for f in files:
        with open(f) as fh:
            assert parse_yaml(fh.read(), f) == want[f], f
    text = ("a: 1\nb: [1, [2, 3], [], -.5e+3]\nc:\n- x\n- 1e-4\n- 0x1F\n- 010\n- yes\n- ~\n"
            "- 'q # r'\n-\nd:\ne: [1,\n  2,]  # comment\nf: 1_000\n")
    assert parse_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize("text", ["x: {a: 1}\n", "x: 12:30\n", "a:\n  b: 1\n c: 2\n",
                                  "a: &x 1\n", "a: [1, 2\n", "---\na: 1\n", "- a: 1\n",
                                  "a: 1\n\tb: 2\n", "just text\n"])
def test_yaml_parser_raises_on_what_it_cannot_parse(text):
    with pytest.raises(YamlError):
        parse_yaml(text)


def _precedence(opts):
    """tests/test_kaist_e2e.py::test_config_precedence_yaml_wins's driver defaults."""
    opts.est.cam.sigma_pix, opts.est.cam.max_msckf, opts.est.clone_freq = 9.9, 7, 11
    return opts


def test_load_options_matches_jax(tmp_path):
    _, master = _config_files(tmp_path)
    for path in (os.path.join(CONFIGS, "config.yaml"), master):
        assert dataclasses.asdict(load_options(path)) == dataclasses.asdict(j_load_options(path))
        got = load_options(path, base=_precedence(Options()))
        want = j_load_options(path, base=_precedence(JOptions()))
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    est = load_options(master, base=_precedence(Options())).est
    assert (est.cam.sigma_pix, est.cam.max_msckf, est.clone_freq) == (1.5, 40, 11)
    assert est.cam.intrinsics == [list(SimConfig().intrinsics)]
    bad = tmp_path / "bad.yaml"
    bad.write_text("est:\n  cam:\n    n_ptz: 3\n")
    for fn in (load_options, j_load_options):
        with pytest.raises(ValueError, match="n_ptz"):
            fn(str(bad))


# --- the native library ----------------------------------------------------------

@pytest.fixture
def jax_native_on_port_build(monkeypatch):
    """JAX's ctypes wrapper loading the port's build of native/*.cpp."""
    monkeypatch.setattr(j_native, "_LIB_PATH", str(native.build()))
    monkeypatch.setattr(j_native, "_lib", None)


def _python_export(db, clone_t, marg_t, t_frame, min_track, F, O):
    """The MSCKF candidates of a Python store, selected as the per-track
    driver's Python branch selects them."""
    t_lo, t_hi = clone_t[0], clone_t[-1]

    def usable(ti):
        return ti in clone_t or t_lo < ti < t_hi

    cands = []
    for fid, tr in db.tracks.items():
        n = sum(1 for ti in tr.times if usable(ti))
        if n >= min_track and (tr.times[-1] < t_frame or any(ti in marg_t for ti in tr.times)):
            cands.append((n, fid))
    cands = sorted(cands, reverse=True)[:F]
    uv, t, valid = np.zeros((F, O, 2)), np.zeros((F, O)), np.zeros((F, O), dtype=bool)
    for i, (_, fid) in enumerate(cands):
        tr = db.tracks[fid]
        obs = [(ti, u) for ti, u in zip(tr.times, tr.uvs) if usable(ti)][:O]
        for j, (ti, u) in enumerate(obs):
            uv[i, j], t[i, j], valid[i, j] = u, ti, True
    return [fid for _, fid in cands], uv, t, valid


def test_native_store_matches_jax_and_python(jax_native_on_port_build):
    assert native.available() and j_native.available()
    rng = np.random.default_rng(7)
    stores = (native.NativeFeatureDatabase(), j_native.NativeFeatureDatabase())
    py = FeatureDatabase()
    times = [round(0.1 * k, 1) for k in range(30)]
    for k, t in enumerate(times):
        ids = np.sort(rng.choice(60, size=25, replace=False)) + (k // 10) * 20
        uvs, uvns = rng.uniform(0, 640, (25, 2)), rng.normal(0, 0.5, (25, 2))
        for s in stores:
            s.update_batch(ids, t, uvs, uvns)
        for fid, uv, uvn in zip(ids, uvs, uvns):
            py.update(int(fid), t, uv, uvn)
        if k % 7 == 6:
            gone = rng.choice(100, size=5, replace=False)
            for s in stores + (py,):
                s.remove(gone)
        if k % 9 == 8:
            for s in stores + (py,):
                s.cleanup(t - 0.45)
        assert len(stores[0]) == len(stores[1]) == len(py)
        clone_t = np.array([ti for ti in times[:k + 1] if ti >= t - 0.8])
        if len(clone_t) < 3:
            continue
        slots = np.arange(len(clone_t), dtype=np.int32)[::-1]
        marg = [float(clone_t[0])]
        outs = [s.export_msckf(clone_t, slots, marg, t, 3, 12, 8) for s in stores]
        for a, b in zip(*outs):
            assert np.array_equal(a, b)
        n, fids, uv, uvn, s0, s1, lam, obs_t, valid = outs[0]
        want_fids, want_uv, want_t, want_valid = _python_export(py, list(clone_t), marg, t, 3,
                                                                12, 8)
        assert n == len(want_fids) and fids[:n].tolist() == want_fids
        assert np.array_equal(valid, want_valid) and np.array_equal(uv, want_uv)
        assert np.array_equal(obs_t, want_t)
        # the bounding clones and the weight of every observation
        at = np.searchsorted(clone_t, obs_t[valid])
        assert np.array_equal(s1[valid], slots[at])
        exact = clone_t[at] == obs_t[valid]
        assert np.array_equal(s0[valid][exact], slots[at][exact]) and not lam[valid][exact].any()
    assert len(py) > 0


def test_native_csv_matches_python_parse(tmp_path, monkeypatch):
    path = tmp_path / "x.csv"
    rng = np.random.default_rng(3)
    rows = rng.normal(0, 1e3, (50, 5))
    lines = ["# header,a,b", "t,x,y,z,w", ""]
    lines += [(",".join if i % 2 else " \t ".join)(f"{v:.9g}" for v in r)
              for i, r in enumerate(rows)]
    lines.insert(20, "1,2,oops,4,5")
    path.write_text("\n".join(lines) + "\n")
    for ncols in (None, 4):
        got = native.load_csv(str(path), ncols or 0)
        monkeypatch.setattr(native, "load_csv", lambda *a: None)
        want = kaist._load_csv(str(path), ncols)  # the Python parse
        monkeypatch.undo()
        assert got.shape == (50, ncols or 5) and np.array_equal(got, want)
    assert native.load_csv(str(tmp_path / "missing.csv")) is None


def test_native_builds_once_when_processes_race(tmp_path, monkeypatch):
    """Workers that build at once each end with one whole library."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    paths, errors = [], []

    def build():
        try:
            paths.append(native.build())
        except RuntimeError as e:
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert not errors and len(paths) == 4 and len(set(paths)) == 1
    assert os.listdir(tmp_path) == [paths[0].name]  # no temporary left behind
    assert native.build() == paths[0]


# --- the dataset, its fixture, the files and the driver ----------------------------

def _same_dataset(port, ref):
    for name in ("has_imu", "has_encoder", "gps_file", "has_images", "has_stereo",
                 "resolution"):
        assert getattr(port, name) == getattr(ref, name), name
    np.testing.assert_array_equal(port.wheel_intr, ref.wheel_intr)
    for name in ("imu", "wheel", "gps", "ground_truth", "image_times"):
        for a, b in zip(getattr(port, name)(), getattr(ref, name)()):
            np.testing.assert_array_equal(a, b, err_msg=name)
    got, want = list(port.stream()), list(ref.stream())
    assert [e[:2] for e in got] == [e[:2] for e in want]
    for (_, _, a), (_, _, b) in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a, dtype=float), np.asarray(b, dtype=float))


def test_kaist_dataset_matches_jax_on_mini_dataset(tmp_path):
    _make_mini_dataset(tmp_path)
    _same_dataset(kaist.KaistDataset(str(tmp_path)), JKaistDataset(str(tmp_path)))


@pytest.fixture(scope="module")
def small_fixtures(tmp_path_factory):
    """tests/test_kaist_e2e.py::kaist_fixture_small written by each package."""
    roots = [str(tmp_path_factory.mktemp(n)) for n in ("port_fixture", "jax_fixture")]
    man = generate_kaist_fixture(roots[0], Simulator(SimConfig(**SMALL_SIM)), **SMALL_FIXTURE)
    j_man = j_generate(roots[1], JSimulator(JSimConfig(**SMALL_SIM)), **SMALL_FIXTURE)
    return roots, man, j_man


def test_fixture_matches_jax(small_fixtures):
    (root, j_root), man, j_man = small_fixtures
    assert man == j_man and man["images"] == 12
    for f in CSVS:
        assert filecmp.cmp(os.path.join(root, f), os.path.join(j_root, f), shallow=False), f
    left = "sensor_data/stereo/left"
    names = sorted(os.listdir(os.path.join(root, left)))
    assert names == sorted(os.listdir(os.path.join(j_root, left))) and len(names) == 12
    for n in names:
        a = np.asarray(Image.open(os.path.join(root, left, n)))
        assert np.array_equal(a, np.asarray(Image.open(os.path.join(j_root, left, n)))), n


def test_kaist_dataset_matches_jax_on_fixture(small_fixtures):
    (_, j_root), _, _ = small_fixtures
    port, ref = kaist.KaistDataset(j_root), JKaistDataset(j_root)
    _same_dataset(port, ref)
    for t in port.image_times()[::5]:
        got, want = port.image(t), ref.image(t)  # Pillow's PNGs through the port's reader
        assert got.dtype == want.dtype == np.float32 and np.array_equal(got, want)


def test_fixture_config_is_the_e2e_tests(tmp_path):
    """write_fixture_config writes tests/test_kaist_e2e.py::_write_config's files."""
    cfg = SimConfig(**SMALL_SIM)
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    write_fixture_config(str(tmp_path / "a"), cfg)
    _write_config(str(tmp_path / "b"), cfg)
    names = sorted(os.listdir(tmp_path / "a"))
    assert names == sorted(os.listdir(tmp_path / "b")) and len(names) == 4
    for n in names:
        assert filecmp.cmp(tmp_path / "a" / n, tmp_path / "b" / n, shallow=False), n


def test_enu_geodetic_roundtrip():
    datum = (36.37, 127.36, 70.0)
    rng = np.random.default_rng(0)
    for _ in range(20):
        p = rng.uniform(-500, 500, 3)
        assert np.linalg.norm(geodetic_to_enu(*enu_to_geodetic(p, datum), datum) - p) < 1e-3


def test_tum_and_timing_files_match_jax(tmp_path):
    rng = np.random.default_rng(4)
    t, p, q = rng.uniform(0, 10, 5), rng.normal(0, 5, (5, 3)), rng.normal(0, 1, (5, 4))
    loader.save_tum(tmp_path / "a.txt", t, p, q)
    j_loader.save_tum(tmp_path / "b.txt", t, p, q)
    assert filecmp.cmp(tmp_path / "a.txt", tmp_path / "b.txt", shallow=False)
    for a, b in zip(loader.load_tum(tmp_path / "a.txt"), j_loader.load_tum(tmp_path / "a.txt")):
        np.testing.assert_array_equal(a, b)
    rows = rng.uniform(0, 100, (4, 3))
    loader.save_timing(tmp_path / "c.csv", ["t", "total", "lk"], rows)
    j_loader.save_timing(tmp_path / "d.csv", ["t", "total", "lk"], rows)
    assert filecmp.cmp(tmp_path / "c.csv", tmp_path / "d.csv", shallow=False)
    names, got = loader.load_timing(tmp_path / "c.csv")
    j_names, want = j_loader.load_timing(tmp_path / "c.csv")
    assert names == j_names == ["t", "total", "lk"] and np.array_equal(got, want)


def _run_kaist(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = run_kaist.main(argv)
    return rc, json.loads(buf.getvalue().strip().splitlines()[-1])


def test_run_kaist_on_the_cpu(small_fixtures, tmp_path):
    (root, _), _, _ = small_fixtures
    master = write_fixture_config(str(tmp_path), SimConfig(**SMALL_SIM))
    out = str(tmp_path / "traj.txt")
    launches = lk_kernel.lk_pyramid.launches
    rc, summary = _run_kaist(["--device", "cpu", "--root", root, "--config", master, "--wheel",
                              "--lines", "--out", out])
    assert rc == 0, summary
    assert set(summary) == JAX_RUN_KAIST_KEYS | {"device", "feature_store", "frame_ms"}
    assert summary["device"] == "cpu" and summary["feature_store"] == "native"
    assert summary["frames"] == 12 and summary["clones"] > 5 and summary["ate_rmse_m"] < 0.5
    assert set(summary["frame_ms"]) == {"decode", "point_tracker", "line_tracker", "filter"}
    t, _, _ = loader.load_tum(out)
    assert len(t) == summary["clones"]
    assert lk_kernel.lk_pyramid.launches == launches  # the CPU runs the plain LK
    rc, err = _run_kaist(["--device", "cpu", "--root", str(tmp_path)])
    assert rc == 2 and "xsens_imu.csv" in err["error"]


def test_run_kaist_needs_a_card_unless_asked_for_the_cpu(small_fixtures):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    (root, _), _, _ = small_fixtures
    with pytest.raises(RuntimeError, match="no CUDA card"):
        run_kaist.main(["--root", root])


@pytest.mark.slow
def test_run_kaist_e2e(tmp_path):
    """tests/test_kaist_e2e.py::test_run_kaist_e2e's fixture, config and gates
    through the port: wheel + lines mono VIWO from its own images."""
    sim = Simulator(SimConfig(duration=16.0, n_landmarks=350, n_lines=40, width=640,
                              height=480, seed=5))
    root = str(tmp_path / "fixture")
    generate_kaist_fixture(root, sim, t_start=1.0, duration=12.0, cam_hz=8.0)
    master = write_fixture_config(str(tmp_path), sim.cfg)
    out = str(tmp_path / "traj.txt")
    rc, summary = _run_kaist(["--device", "cpu", "--root", root, "--config", master, "--wheel",
                              "--lines", "--out", out])
    assert rc == 0, summary
    assert summary["frames"] >= 90 and summary["clones"] > 50 and summary["updates"] > 30
    ate = summary.get("ate_rmse_m")
    assert ate is not None and np.isfinite(ate) and ate < 1.0, summary
    assert os.path.exists(out)


@pytest.mark.slow
def test_trackers_carry_few_points_at_3hz(tmp_path):
    """Large motion between frames: over a 3 Hz, 320 x 240 fixture (the small
    fixture's rate and size, 350 landmarks) both KLT trackers carry few
    points from frame to frame, and the port's, on the gather LK as JAX's,
    carries as many as JAX's frame pair by frame pair (tolerance 0 points;
    measured 23 over 11 frame pairs, 4 pairs carrying none, in both).
    Prints both counts; holds both to losing most points."""
    from plviwo_tpu.update.tracker import KltTracker as JKltTracker
    from plviwo_tpu_torch.update.tracker import KltTracker

    sim = Simulator(SimConfig(duration=7.0, n_landmarks=350, n_lines=40, width=320,
                              height=240, seed=5))
    root = str(tmp_path / "fixture")
    generate_kaist_fixture(root, sim, t_start=1.0, duration=4.0, cam_hz=3.0)
    ds = kaist.KaistDataset(root)
    K = np.asarray(sim.cfg.intrinsics, dtype=np.float64)
    trackers = {"jax": JKltTracker(n_pts=120, cam_k=K, grid_x=16, grid_y=10),
                "port": KltTracker(n_pts=120, cam_k=K, grid_x=16, grid_y=10, device="cpu")}
    prev = {k: None for k in trackers}
    carried = {k: [] for k in trackers}
    tracked = {k: 0 for k in trackers}
    for t, kind, _ in ds.stream():
        if kind != "image":
            continue
        img = ds.image(t)
        for name, tr in trackers.items():
            ids, _ = tr.feed(img)
            if prev[name] is not None:
                carried[name].append(len(np.intersect1d(ids, prev[name])))
            tracked[name] += len(ids)
            prev[name] = ids
    print({k: (sum(v), v.count(0), tracked[k]) for k, v in carried.items()})
    assert len(carried["port"]) == 11
    for name in trackers:
        assert sum(carried[name]) < 0.5 * tracked[name]
    assert carried["port"] == carried["jax"]
