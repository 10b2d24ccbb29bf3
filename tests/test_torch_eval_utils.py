"""The port's evaluation CLI and host utilities against the JAX package, on
the CPU.

`python -m plviwo_tpu_torch.eval` (all eleven subcommands) against
`python -m plviwo_tpu.eval` on the same files; `eval.metrics.rpe` and
`nees`; `utils.timing.TimeChecker`, `utils.logging`, `utils.monitor`,
`utils.recorder.StateRecorder`, `utils.viz` (writers, overlay pixels,
display endpoints, `VizRecorder`), `utils.checkpoint` (a resumed run
against an unbroken one), the `VioSystem.viz` hooks and `run_sim --record`
/ `--viz-dir`.

Tolerances: JSON output numbers within 1e-9 relative (rotations through
torch instead of JAX, both float64), markdown and converted files equal;
`rpe` / `nees` within 1e-9 relative; `TimeChecker` summaries, log lines
(timestamps stripped), recorder files, PLY text, overlay pixels and PNG
pixels (against matplotlib's RGB) equal; display endpoints within 1e-9 m;
a resumed checkpoint's trajectory, stats and covariance equal to the
unbroken run's, bit for bit.  `eval plot` draws its own two panels (no
matplotlib on the card's machine): the same JSON line, and a PNG of the
expected size with each trajectory's color on it.
"""

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from plviwo_tpu.eval import metrics as j_metrics
from plviwo_tpu.eval.__main__ import main as j_eval
from plviwo_tpu.utils import logging as j_logging
from plviwo_tpu.utils import monitor as j_monitor
from plviwo_tpu.utils import recorder as j_recorder
from plviwo_tpu.utils import timing as j_timing
from plviwo_tpu.utils import viz as j_viz
from plviwo_tpu_torch import examples, run_sim
from plviwo_tpu_torch.config.options import EstimatorOptions
from plviwo_tpu_torch.core.system import VioSystem
from plviwo_tpu_torch.data import png
from plviwo_tpu_torch.eval import metrics
from plviwo_tpu_torch.eval.__main__ import main as t_eval
from plviwo_tpu_torch.eval.loader import load_timing, save_timing, save_tum
from plviwo_tpu_torch.sim.simulator import SimConfig, Simulator
from plviwo_tpu_torch.utils import logging as t_logging
from plviwo_tpu_torch.utils import monitor, recorder, timing, viz
from plviwo_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint


def _quat_walk(rng, n):
    """Unit JPL quaternions drifting smoothly (positive scalar part)."""
    q = np.cumsum(rng.normal(0, 0.02, (n, 4)), axis=0) + np.array([0.0, 0.0, 0.0, 1.0])
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return q * np.sign(q[:, 3:4])


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A ground-truth TUM trajectory (~120 m), two noisy estimates of it (one
    a few timestamps off), two timing files and a recorder triplet."""
    d = tmp_path_factory.mktemp("eval")
    rng = np.random.default_rng(0)
    n = 240
    t = np.arange(n) * 0.1
    p = np.cumsum(np.stack([np.cos(t / 4), np.sin(t / 3), 0.05 * np.cos(t)], 1) * 0.5, 0)
    q = _quat_walk(rng, n)
    out = {"gt": str(d / "gt.txt"), "est": str(d / "est.txt"), "est2": str(d / "est2.txt"),
           "gt_rpe": str(d / "gt_rpe.txt"), "est_rpe": str(d / "est_rpe.txt")}
    save_tum(out["gt"], t, p, q)
    for name, sig, dt in (("est", 0.05, 0.0), ("est2", 0.1, 0.004)):
        qe = q + rng.normal(0, 0.01, q.shape)
        qe /= np.linalg.norm(qe, axis=1, keepdims=True)
        R = np.array([[np.cos(0.1), -np.sin(0.1), 0], [np.sin(0.1), np.cos(0.1), 0], [0, 0, 1]])
        save_tum(out[name], t + dt, (p + rng.normal(0, sig, p.shape)) @ R.T + 0.3, qe)
    # every 6th pose for RPE (JAX's RPE converts each pose pair eagerly)
    for name, src in (("gt_rpe", "gt"), ("est_rpe", "est")):
        with open(out[src]) as f:
            lines = f.readlines()
        with open(out[name], "w") as f:
            f.writelines(lines[:1] + lines[1::6])
    for name in ("timing", "timing2"):
        out[name] = str(d / f"{name}.txt")
        rows = np.column_stack([t[:50], rng.uniform(1, 5, (50, 3))])
        save_timing(out[name], ["t", "propagate", "cam", "line" if name == "timing" else "gps"],
                    rows)
    rec = d / "rec"
    rec.mkdir()
    est = np.column_stack([t, q, p, rng.normal(0, 1, (n, 9))])
    gt = est.copy()
    gt[:, 1:5] = _quat_walk(rng, n)
    gt[:, 5:] += rng.normal(0, 0.05, (n, 12))
    std = np.column_stack([t, np.abs(rng.normal(0.05, 0.01, (n, 15)))])
    for name, arr in (("state_est.txt", est), ("state_std.txt", std), ("state_gt.txt", gt)):
        np.savetxt(rec / name, arr, fmt="%.9f")
    out["rec"] = str(rec)
    out["dir"] = d
    return out


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    assert rc == 0
    return buf.getvalue()


def _assert_json_close(got, want, path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for k in want:
            _assert_json_close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _assert_json_close(a, b, f"{path}[{i}]")
    elif isinstance(want, float):
        assert got == pytest.approx(want, rel=1e-9, abs=1e-12, nan_ok=True), path
    else:
        assert got == want, path


SUBCOMMANDS = {
    "ate": lambda f: ["ate", f["est"], f["gt"]],
    "ate_se3": lambda f: ["ate", f["est2"], f["gt"], "--align", "se3", "--tol", "0.01"],
    "ate_sim3": lambda f: ["ate", f["est"], f["gt"], "--align", "sim3"],
    "rpe": lambda f: ["rpe", f["est_rpe"], f["gt_rpe"], "--segments", "8,16,32"],
    "compare": lambda f: ["compare", f["gt"], f["est"], f["est2"]],
    "timing": lambda f: ["timing", f["timing"]],
    "dataset": lambda f: ["dataset", f"{f['est']},{f['gt']}", f"{f['est2']},{f['gt']}"],
    "nees": lambda f: ["nees", f["rec"]],
    "timing_compare": lambda f: ["timing-compare", f["timing"], f["timing2"]],
    "flamegraph": lambda f: ["flamegraph", f["timing"]],
    "percentages": lambda f: ["percentages", f["timing2"]],
}


@pytest.mark.parametrize("name", sorted(SUBCOMMANDS))
def test_eval_subcommand_matches_jax(files, name):
    argv = SUBCOMMANDS[name](files)
    got, want = _run(t_eval, argv), _run(j_eval, argv)
    if want.lstrip().startswith("{"):
        _assert_json_close(json.loads(got), json.loads(want))
    else:
        assert got == want


@pytest.mark.parametrize("to", ["csv", "tum"])
def test_eval_convert_matches_jax(files, to, tmp_path):
    src = files["est"]
    if to == "tum":  # CSV -> TUM, from the port's CSV
        _run(t_eval, ["convert", src, str(tmp_path / "src.csv"), "--to", "csv"])
        src = str(tmp_path / "src.csv")
    argv = ["convert", src, "", "--from", "csv" if to == "tum" else "tum", "--to", to]
    outs = []
    for main, tag in ((t_eval, "port"), (j_eval, "jax")):
        argv[2] = str(tmp_path / f"{tag}.{to}")
        outs.append(json.loads(_run(main, argv))["rows"])
    assert outs[0] == outs[1] == 240
    assert (tmp_path / f"port.{to}").read_bytes() == (tmp_path / f"jax.{to}").read_bytes()


def test_eval_plot_draws_both_panels(files, tmp_path):
    out = str(tmp_path / "plot.png")
    argv = ["plot", files["gt"], files["est"], "--out", out]
    got = json.loads(_run(t_eval, argv))
    assert got == {"out": out, "n": 2}
    img = png.read_rgb(out)
    assert img.shape == (600, 1320, 3)
    for color in ((31, 119, 180), (255, 127, 14)):  # each trajectory's line
        for panel in (img[:, :660], img[:, 660:]):
            assert np.all(panel == color, axis=-1).sum() > 100


def test_rpe_and_nees_match_jax(files):
    from plviwo_tpu_torch.eval.loader import load_tum

    t, p, q = load_tum(files["gt_rpe"])
    te, pe, qe = load_tum(files["est_rpe"])
    want = j_metrics.rpe(te, pe, qe, t, p, q, segment_lengths=(4, 8, 24))
    _assert_json_close(metrics.rpe(te, pe, qe, t, p, q, segment_lengths=(4, 8, 24)), want)
    assert want["8"]["pos"]["n"] > 10
    t, p, q = load_tum(files["gt"])
    te, pe, qe = load_tum(files["est"])
    std = np.full((len(t), 3), 0.05)
    _assert_json_close(metrics.nees(pe, qe, std, 0.5 * std, p, q),
                       j_metrics.nees(pe, qe, std, 0.5 * std, p, q))


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 0.0125
        return self.t


def test_time_checker_matches_jax(monkeypatch, capsys):
    out = []
    for mod in (timing, j_timing):
        monkeypatch.setattr(mod.time, "perf_counter", _Clock())
        tc = mod.TimeChecker()
        for i in range(5):
            tc.ding("frame")
            with tc.timer("track"):
                pass
            dt = tc.dong("frame")
        assert tc.dong("never") == 0.0 and dt > 0
        tc.print_summary()
        out.append((tc.summary(), tc.mean_ms("frame"), tc.max_ms("track"), tc.total_s("frame"),
                    capsys.readouterr().out))
    assert out[0] == out[1]
    assert out[0][0]["track"]["count"] == 5


def _strip_time(text):
    return re.sub(r"^\[\d\d:\d\d:\d\d\]", "[T]", text, flags=re.M)


def test_logging_matches_jax(tmp_path, capsys):
    out = []
    for mod, tag in ((t_logging, "port"), (j_logging, "jax")):
        path = tmp_path / f"{tag}.log"
        mod.open_file(str(path))
        try:
            mod.set_level(mod.DEBUG)
            mod.debug("d")
            mod.info("i 1")
            mod.warning("w")
            mod.set_level(mod.WARNING)
            mod.info("hidden")
            mod.error("e")
        finally:
            mod.set_level(mod.INFO)
            mod.close_file()
        cap = capsys.readouterr()
        out.append((_strip_time(cap.out), _strip_time(cap.err), _strip_time(path.read_text())))
    assert out[0] == out[1]
    assert out[0][2].count("\n") == 4 and "hidden" not in out[0][2]


def test_monitor_samples_and_writes_timing_files(tmp_path):
    """`sample` of this process as JAX's reads it, and a monitor's file in
    the timing layout the eval CLI reads."""
    got, want = monitor.sample(os.getpid()), j_monitor.sample(os.getpid())
    assert got[2] == want[2] and abs(got[0] - want[0]) < 0.5 and abs(got[1] - want[1]) < 64e6
    assert monitor.sample(2**22 + 7) is None
    path = str(tmp_path / "usage.txt")
    with monitor.ResourceMonitor(interval=0.02, out=path) as mon:
        x = np.zeros(1)
        t0 = time.time()
        while time.time() - t0 < 0.2:
            x = np.sin(x + 1.0)
    names, rows = load_timing(path)
    assert names == ["t", "cpu_pct", "rss_mb", "threads"] and len(rows) >= 3
    assert mon.peak_rss_mb > 10 and mon.mean_cpu_pct > 0
    out = json.loads(_run(t_eval, ["timing", path]))
    assert set(out) == {"cpu_pct", "rss_mb", "threads"}


def test_monitor_cli_on_a_child(tmp_path):
    """The CLI samples a child until it exits (the child is reaped here while
    the CLI runs in a thread: a zombie keeps its /proc entry)."""
    import threading

    child = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(0.6)"])
    path = str(tmp_path / "child.txt")
    res = {}
    buf = io.StringIO()

    def cli():
        with contextlib.redirect_stdout(buf):
            res["rc"] = monitor.main([str(child.pid), "--interval", "0.05", "--out", path])

    th = threading.Thread(target=cli, daemon=True)
    th.start()
    child.wait()
    th.join(timeout=10.0)
    assert res.get("rc") == 0 and buf.getvalue().startswith("wrote ")
    assert load_timing(path)[0] == ["t", "cpu_pct", "rss_mb", "threads"]


class _JaxLike:
    """The fields JAX's recorder reads (numpy), for a state given as port
    tensors."""

    def __init__(self, st):
        self.state = type("S", (), {k: getattr(st, k)[0].numpy() for k in
                                    ("q", "p", "v", "bg", "ba", "cov")})()
        self.state.time = float(st.time[0])


def test_recorder_files_match_jax(tmp_path):
    """One device transfer a record; the files JAX's recorder writes for the
    same states."""
    sim = Simulator(SimConfig(duration=2.0, seed=3, sigma_pix=0.5, n_pts=45))
    s = VioSystem(EstimatorOptions(), device="cpu")
    examples.live_calibrate(s, sim, float(sim.imu_t[0]))
    port, ref = recorder.StateRecorder(str(tmp_path / "p")), j_recorder.StateRecorder(
        str(tmp_path / "j"))
    rng = np.random.default_rng(1)
    for i in range(4):
        st = s.state
        s.state = st.replace(p=st.p + 0.1, time=st.time + 0.1,
                             cov=st.cov * (1.0 + 0.01 * i))
        gt = {"q": rng.normal(size=4), "p": rng.normal(size=3), "v": rng.normal(size=3),
              "bg": rng.normal(size=3), "ba": rng.normal(size=3)}
        port.record(s, gt=gt)
        ref.record(_JaxLike(s.state), gt=gt)
        for r in (port, ref):
            r.record_timing(0.1 * i, {"frame": 1.5 + i, "host": 0.25})
    assert port.host_reads == 4
    port.save()
    ref.save()
    for name in ("state_est.txt", "state_std.txt", "state_gt.txt", "trajectory.txt",
                 "timing.txt"):
        assert (tmp_path / "p" / name).read_bytes() == (tmp_path / "j" / name).read_bytes(), name
    assert port.check_files()


def test_viz_writers_match_jax(tmp_path):
    rng = np.random.default_rng(2)
    pts, lines = rng.normal(size=(7, 3)), rng.normal(size=(3, 6))
    for fn, arg in (("save_ply_points", pts), ("save_ply_lines", lines)):
        getattr(viz, fn)(str(tmp_path / "p.ply"), arg)
        getattr(j_viz, fn)(str(tmp_path / "j.ply"), arg)
        assert (tmp_path / "p.ply").read_text() == (tmp_path / "j.ply").read_text()
    gray = rng.uniform(0, 1, (60, 80)).astype(np.float32)
    uv = rng.uniform(0, 80, (12, 2))
    prev = uv + rng.normal(0, 3, uv.shape)
    segs = rng.uniform(-5, 85, (4, 4))
    got = viz.tracking_overlay(gray, uv, prev, segs)
    np.testing.assert_array_equal(got, j_viz.tracking_overlay(gray, uv, prev, segs))
    np.testing.assert_array_equal(viz.tracking_overlay((gray * 255).astype(np.uint8)),
                                  j_viz.tracking_overlay((gray * 255).astype(np.uint8)))


def test_save_image_pixels_are_matplotlibs(tmp_path):
    import matplotlib.image as mpimg

    img = viz.tracking_overlay(np.random.default_rng(3).uniform(0, 1, (40, 50)),
                               np.array([[10.0, 12.0], [30.5, 20.2]]))
    path = viz.save_image(str(tmp_path / "p"), img)
    assert path.endswith("p.png")
    mpimg.imsave(str(tmp_path / "m.png"), img)
    want = np.round(mpimg.imread(str(tmp_path / "m.png"))[..., :3] * 255).astype(np.uint8)
    np.testing.assert_array_equal(png.read_rgb(path), want)


def test_line_display_endpoints_match_jax():
    import jax.numpy as jnp

    rng = np.random.default_rng(4)
    for _ in range(3):
        v = rng.normal(size=3)
        p0 = rng.normal(size=3) * 3
        n = np.cross(p0, v / np.linalg.norm(v))
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        args = (n, v, rng.normal(0, 0.3, 4), q, rng.normal(size=3),
                np.array([0.5, -0.5, 0.5, -0.5]), np.array([0.05, 0.0, 0.0]))
        want = j_viz.line_display_endpoints(*(jnp.asarray(a) for a in args))
        np.testing.assert_allclose(viz.line_display_endpoints(*args), np.asarray(want),
                                   rtol=0, atol=1e-9)


def test_viz_recorder_matches_jax(tmp_path):
    rng = np.random.default_rng(5)
    recs = viz.VizRecorder(str(tmp_path / "p")), j_viz.VizRecorder(str(tmp_path / "j"))
    gray = rng.uniform(0, 1, (30, 40))
    pts, slam, lines, uv = (rng.normal(size=(5, 3)), rng.normal(size=(2, 3)),
                            rng.normal(size=(2, 6)), rng.uniform(0, 40, (3, 2)))
    for r in recs:
        r.add_points(0.1, pts)
        r.add_points(0.2, np.zeros((0, 3)))
        r.add_slam_points(0.2, slam)
        r.add_lines(0.3, lines)
        r.add_overlay(0.3, gray, uv)
    sums = [r.save() for r in recs]
    assert sums[0] == sums[1] == {"overlays": 1, "msckf_points": 5, "slam_points": 2,
                                  "lines": 2}
    for name in ("msckf_points.ply", "slam_points.ply", "lines.ply", "viz_summary.json"):
        assert (tmp_path / "p" / name).read_text() == (tmp_path / "j" / name).read_text()


# --- the live driver: viz hooks, status, checkpoints, run_sim --record / --viz-dir ---------

def _tracks_run(stereo=False, lines=False):
    """A per-track replay's system and events (run_sim --wheel's settings;
    with lines run_sim --lines's)."""
    import chip_smoke

    sim = Simulator(SimConfig(duration=3.0, seed=3, sigma_pix=0.5, n_pts=45))
    o = chip_smoke.run_sim_options(EstimatorOptions(), wheel=True)
    if stereo:
        o.cam.max_n, o.cam.min_track_length = 2, 6
    if lines:
        o.cam.use_lines, o.cam.max_lines, o.cam.sigma_pix_line = True, 20, 2.0
    events = examples.track_events(sim, stereo=stereo, wheel=True, lines=lines)

    def make():
        s = VioSystem(o, device="cpu")
        examples.live_calibrate(s, sim, float(sim.imu_t[0]))
        if stereo:
            c = sim.cfg
            s.set_calibration(c.intrinsics, c.cam_ext_q,
                              np.asarray(c.cam_ext_p) + [-c.stereo_baseline, 0.0, 0.0], cam=1)
        return s

    return make, events


@pytest.mark.parametrize("case", ["mono", "stereo_lines", "host_tracker"])
def test_checkpoint_resume_equals_unbroken(case, tmp_path):
    """Half a replay, a checkpoint, then the rest fed to the unbroken system
    and to the resumed one (with the host tracker, the tracker rides along
    as `extra` and each system's frames go through its own tracker)."""
    if case == "host_tracker":
        sim = Simulator(SimConfig(duration=2.0, seed=2, n_landmarks=350))
        a, tr_a = examples.host_tracker_system(sim, "cpu")
        events = examples.track_events(sim, images=True)
    else:
        make, events = _tracks_run(stereo=case != "mono", lines=case != "mono")
        a, tr_a = make(), None

    def feed(s, tr, kind, args):
        if tr is None:
            examples.feed(s, kind, args)
        else:
            examples.feed_tracked(s, tr, kind, args)

    half = len(events) // 2
    for kind, args in events[:half]:
        feed(a, tr_a, kind, args)
    path = str(tmp_path / "ck.pkl")
    save_checkpoint(path, a, extra={"frames_fed": half, "tracker": tr_a})
    b, extra = load_checkpoint(path, device="cpu", extra=True)
    tr_b = extra["tracker"]
    assert extra["frames_fed"] == half and b.device == a.device
    assert (b.fdb_native is None) == (a.fdb_native is None)
    if a.fdb_native is not None:
        assert len(b.fdb_native) == len(a.fdb_native)
    for kind, args in events[half:]:
        feed(a, tr_a, kind, args)
        feed(b, tr_b, kind, args)
    if tr_a is not None:
        np.testing.assert_array_equal(tr_a.ids, tr_b.ids)
    assert len(a.traj) == len(b.traj) > 15 and a.stats == b.stats
    for (ta, qa, pa), (tb, qb, pb) in zip(a.traj, b.traj):
        assert ta == tb and np.array_equal(qa, qb) and np.array_equal(pa, pb)
    assert torch.equal(a.state.cov, b.state.cov)
    assert a.stats["cam_accept"] > 0 and (case != "stereo_lines" or a.stats["line_accept"] > 0)


def test_viz_hooks_read_only_when_set():
    """The per-track hooks (MSCKF points, line endpoints) against the same
    run without viz: the same trajectory, and the only extra device reads
    are the hooks'."""
    make, events = _tracks_run(lines=True)
    plain, seen = make(), make()
    seen.viz = viz.VizRecorder.__new__(viz.VizRecorder)
    seen.viz.__dict__.update(points=[], lines=[], slam_points=[], n_overlays=0,
                             max_frames=0, out_dir=None)
    for kind, args in events:
        examples.feed(plain, kind, args)
        examples.feed(seen, kind, args)
    assert [p for _, _, p in plain.traj] and all(
        np.array_equal(a[2], b[2]) for a, b in zip(plain.traj, seen.traj))
    n_pts, n_lines = len(seen.viz.points), len(seen.viz.lines)
    assert n_pts > 0 and n_lines > 0
    assert seen.host_reads == plain.host_reads + n_pts + n_lines
    assert sum(len(p) for _, p in seen.viz.points) == seen.stats["cam_accept"]


def test_print_status_logs_through_utils_logging(capsys):
    make, events = _tracks_run()
    s = make()
    for kind, args in events[:400]:
        examples.feed(s, kind, args)
    s.print_status()
    out = capsys.readouterr().out
    assert re.match(r"^\[\d\d:\d\d:\d\d\]\[I\] t=\d+\.\d\d p=\[.*\] clones=\d+ slam=0 stats=\{",
                    out), out


@pytest.mark.parametrize("mode", ["tracks", "images", "host_tracker"])
def test_run_sim_record_and_viz_dir(mode, tmp_path):
    rec, vd = str(tmp_path / "rec"), str(tmp_path / "viz")
    argv = {"tracks": ["--wheel", "--lines", "--duration", "2"],
            "images": ["--images", "--lines", "--duration", "1"],
            "host_tracker": ["--images", "--host-tracker", "--duration", "1"]}[mode]
    out = json.loads(_run(run_sim.main, ["--device", "cpu", "--record", rec, "--viz-dir", vd]
                          + argv).strip().splitlines()[-1])
    n = out["frames"]
    est = np.loadtxt(os.path.join(rec, "state_est.txt"))
    assert est.shape == (n, 17) and np.loadtxt(os.path.join(rec, "state_std.txt")).shape == (
        n, 16) and np.loadtxt(os.path.join(rec, "state_gt.txt")).shape == (n, 17)
    names, rows = load_timing(os.path.join(rec, "timing.txt"))
    assert names[0] == "t" and len(rows) == n
    nees = json.loads(_run(t_eval, ["nees", rec]))
    assert nees["pos_nees"]["n"] == n and np.isfinite(nees["pos_nees"]["mean"])
    summary = json.load(open(os.path.join(vd, "viz_summary.json")))
    if mode == "tracks":
        assert summary["msckf_points"] > 0 and summary["overlays"] == 0
    else:
        assert summary["overlays"] == n and png.read_rgb(os.path.join(
            vd, "track_00000.png")).shape == (480, 640, 3)


@pytest.mark.slow
def test_jax_resume_loses_its_native_store():
    """The JAX package's fault (ROADMAP C): `plviwo_tpu.utils.checkpoint`
    does not save the C++ feature store, and the resumed JAX system comes
    back with an empty one, whose MSCKF candidates then differ: JAX's resumed
    run departs from its unbroken run (measured: 0 observations against 97
    at the save, 0.024 m apart by the end), where the port's equals it
    (`test_checkpoint_resume_equals_unbroken`)."""
    import tempfile

    import chip_smoke
    from plviwo_tpu import native as j_native
    from plviwo_tpu.config.options import EstimatorOptions as JOptions
    from plviwo_tpu.core.system import VioSystem as JVioSystem
    from plviwo_tpu.sim.simulator import SimConfig as JSimConfig
    from plviwo_tpu.sim.simulator import Simulator as JSimulator
    from plviwo_tpu.utils import checkpoint as j_checkpoint

    if not j_native.available():
        pytest.skip("the JAX package's native library is not built here")
    sim = JSimulator(JSimConfig(duration=4.0, seed=3, sigma_pix=0.5, n_pts=45))
    o = chip_smoke.run_sim_options(JOptions(), wheel=True)
    events = examples.track_events(sim, wheel=True)
    a = JVioSystem(o)
    examples.live_calibrate(a, sim, float(sim.imu_t[0]))
    half = len(events) // 2
    for kind, args in events[:half]:
        examples.feed(a, kind, args)
    with tempfile.TemporaryDirectory() as d:
        j_checkpoint.save_checkpoint(os.path.join(d, "ck.pkl"), a)
        b = j_checkpoint.load_checkpoint(os.path.join(d, "ck.pkl"))
    assert len(a.fdb_native) > 0 and len(b.fdb_native) == 0
    for kind, args in events[half:]:
        examples.feed(a, kind, args)
        examples.feed(b, kind, args)
    d = max(np.abs(np.asarray(pa) - np.asarray(pb)).max()
            for (_, _, pa), (_, _, pb) in zip(a.traj, b.traj))
    assert a.stats != b.stats and d > 1e-3
