"""Synthetic KAIST Complex Urban on-disk fixture (port of
plviwo_tpu/sim/kaist_fixture.py).

Writes a simulator run in the raw KAIST layout `data/kaist.py` reads:

    sensor_data/xsens_imu.csv      t_ns, q(4), euler(3), gyro(3), accel(3), mag(3)
    sensor_data/encoder.csv        t_ns, left_count, right_count
    sensor_data/vrs_gps.csv        t_ns, lat, lon, alt
    sensor_data/stereo/left/<t_ns>.png   (+ right/ when stereo=True)
    sensor_data/data_stamp.csv     t_ns, sensor
    calibration/EncoderParameter.txt
    global_pose.csv                t_ns, 4x3 row-major [R|p]

so `run_kaist.py` runs end to end without the real dataset.  It draws the
simulator's noise in the JAX package's order (the IMU stream, the wheel
samples, then the GPS noise from `sim.rng`), so one seed writes the same
CSV bytes; images go through the port's PNG writer (`data/png.py`).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..data import png
from ..ops import lie
from ..update.gps import _A, _E2, geodetic_to_ecef


def _ecef_to_geodetic(p):
    """Iterative (Bowring) ECEF -> WGS84 geodetic; sub-mm after 5 rounds."""
    x, y, z = p
    lon = np.arctan2(y, x)
    r = np.hypot(x, y)
    lat = np.arctan2(z, r * (1 - _E2))
    for _ in range(5):
        N = _A / np.sqrt(1 - _E2 * np.sin(lat) ** 2)
        alt = r / np.cos(lat) - N
        lat = np.arctan2(z, r * (1 - _E2 * N / (N + alt)))
    N = _A / np.sqrt(1 - _E2 * np.sin(lat) ** 2)
    alt = r / np.cos(lat) - N
    return np.degrees(lat), np.degrees(lon), alt


def enu_to_geodetic(p_enu, datum):
    """Inverse of update/gps.geodetic_to_enu (fixture GPS synthesis)."""
    lat0, lon0, alt0 = datum
    p0 = geodetic_to_ecef(lat0, lon0, alt0)
    lat0r, lon0r = np.radians(lat0), np.radians(lon0)
    sl, cl = np.sin(lat0r), np.cos(lat0r)
    so, co = np.sin(lon0r), np.cos(lon0r)
    R = np.array([
        [-so, co, 0.0],
        [-sl * co, -sl * so, cl],
        [cl * co, cl * so, sl],
    ])
    return _ecef_to_geodetic(p0 + R.T @ np.asarray(p_enu, dtype=float))


def generate_kaist_fixture(root: str, sim, t_start: float, duration: float,
                           cam_hz: float = 10.0, stereo: bool = False,
                           datum=(36.37, 127.36, 70.0),
                           encoder_resolution: int = 4096) -> dict:
    """Render a KAIST-layout dataset from a (port) Simulator into `root`.

    Times are written as nanoseconds offset from an arbitrary epoch (KAIST
    uses absolute unix ns; any consistent origin works for the reader).
    Returns a manifest dict (counts + the files written).
    """
    sd = os.path.join(root, "sensor_data")
    os.makedirs(os.path.join(sd, "stereo", "left"), exist_ok=True)
    if stereo:
        os.makedirs(os.path.join(sd, "stereo", "right"), exist_ok=True)
    os.makedirs(os.path.join(root, "calibration"), exist_ok=True)

    epoch = 1.5e9  # fake unix epoch seconds
    to_ns = lambda t: int(round((epoch + t) * 1e9))  # noqa: E731
    t_end = t_start + duration
    stamps = []  # (t_ns, name)

    # ---- IMU: 17-col xsens rows (gyro at 8:11, accel at 11:14) ----
    imu_t, imu_w, imu_a = sim.imu_stream()
    sel = (imu_t >= t_start) & (imu_t <= t_end)
    rows = []
    for t, w, a in zip(imu_t[sel], imu_w[sel], imu_a[sel]):
        ns = to_ns(t)
        rows.append([ns, 0, 0, 0, 1, 0, 0, 0, w[0], w[1], w[2],
                     a[0], a[1], a[2], 0, 0, 0])
        stamps.append((ns, "imu"))
    with open(os.path.join(sd, "xsens_imu.csv"), "w") as f:
        for r in rows:
            f.write(",".join(f"{x:.9g}" if i else str(int(x))
                             for i, x in enumerate(r)) + "\n")
    n_imu = len(rows)

    # ---- encoder: integrate true wheel rates into tick counts ----
    c = sim.cfg
    wheel_hz = c.wheel_hz
    wt = np.arange(t_start, t_end, 1.0 / wheel_hz)
    counts = np.zeros((len(wt), 2))
    cl = cr = 0.0
    prev_t = wt[0]
    enc_rows = []
    for i, t in enumerate(wt):
        m1, m2 = sim.wheel_sample(t)  # rad/s each wheel
        dt = t - prev_t
        cl += m1 * dt * encoder_resolution / (2 * np.pi)
        cr += m2 * dt * encoder_resolution / (2 * np.pi)
        counts[i] = [cl, cr]
        ns = to_ns(t)
        enc_rows.append(f"{ns},{cl:.3f},{cr:.3f}\n")
        stamps.append((ns, "encoder"))
        prev_t = t
    with open(os.path.join(sd, "encoder.csv"), "w") as f:
        f.writelines(enc_rows)

    # ---- GPS: gt position + noise -> geodetic about the datum ----
    gps_rows = []
    for t in np.arange(t_start, t_end, 1.0):
        _, p = sim.gt_pose(t)
        p_enu = np.asarray(p) + sim.rng.normal(0, c.sigma_gps, 3)
        lat, lon, alt = enu_to_geodetic(p_enu, datum)
        ns = to_ns(t)
        gps_rows.append(f"{ns},{lat:.9f},{lon:.9f},{alt:.4f}\n")
        stamps.append((ns, "gps"))
    with open(os.path.join(sd, "vrs_gps.csv"), "w") as f:
        f.writelines(gps_rows)

    # ---- images ----
    n_img = 0
    for t in np.arange(t_start, t_end, 1.0 / cam_hz):
        ns = to_ns(t)
        img = sim.render_frame(t)
        png.write_gray(os.path.join(sd, "stereo", "left", f"{ns}.png"),
                       (img * 255).astype(np.uint8))
        if stereo:
            img_r = sim.render_frame(t, cam=1)
            png.write_gray(os.path.join(sd, "stereo", "right", f"{ns}.png"),
                           (img_r * 255).astype(np.uint8))
        stamps.append((ns, "stereo"))
        n_img += 1

    # ---- data_stamp + calibration + ground truth ----
    stamps.sort()
    with open(os.path.join(sd, "data_stamp.csv"), "w") as f:
        f.writelines(f"{ns},{name}\n" for ns, name in stamps)
    with open(os.path.join(root, "calibration",
                           "EncoderParameter.txt"), "w") as f:
        f.write(f"Encoder resolution: {encoder_resolution}\n")
        f.write(f"Encoder left wheel diameter: {2 * c.wheel_rl}\n")
        f.write(f"Encoder right wheel diameter: {2 * c.wheel_rr}\n")
        f.write(f"Encoder wheel base: {c.wheel_base}\n")

    gt_rows = []
    for t in np.arange(t_start, t_end, 0.1):
        q, p = sim.gt_pose(t)
        R_GtoI = lie.quat_2_rot(torch.as_tensor(np.asarray(q, dtype=np.float64))).numpy()
        M = np.concatenate([R_GtoI.T, np.asarray(p)[:, None]], axis=1)
        gt_rows.append(f"{to_ns(t)}," + ",".join(
            f"{x:.9f}" for x in M.reshape(-1)) + "\n")
    with open(os.path.join(root, "global_pose.csv"), "w") as f:
        f.writelines(gt_rows)

    return {"imu": n_imu, "encoder": len(enc_rows), "gps": len(gps_rows),
            "images": n_img, "datum": datum, "epoch": epoch}


def write_fixture_config(dirpath: str, cfg) -> str:
    """A layered YAML config (config.yaml naming config_camera.yaml,
    config_wheel.yaml and config_gps.yaml) carrying a simulator rig's
    calibration (SimConfig cfg), with the KAIST camera settings: 120
    points, sigma_pix 1.5, chi2 x 8, tracks of >= 4, 40 MSCKF features, 24
    lines; the wheel and GPS noises.  Returns the master file's path."""
    def flat(xs):
        return ", ".join(str(x) for x in xs)

    files = {
        "config_camera.yaml": (
            "est:\n  cam:\n    n_pts: 120\n    sigma_pix: 1.5\n    chi2_mult: 8.0\n"
            "    min_track_length: 4\n    max_msckf: 40\n    max_lines: 24\n"
            f"    intrinsics: [[{flat(cfg.intrinsics)}]]\n"
            f"    extrinsics: [[{flat(list(cfg.cam_ext_q) + list(cfg.cam_ext_p))}]]\n"
            "    timeoffsets: [0.0]\n"),
        "config_wheel.yaml": (
            "est:\n  wheel:\n    noise_w: 0.05\n    noise_v: 0.1\n    noise_p: 0.05\n"
            f"    extrinsics: [{flat(list(cfg.wheel_ext_q) + list(cfg.wheel_ext_p))}]\n"),
        "config_gps.yaml": (
            "est:\n  gps:\n    noise: 1.5\n    init_distance: 12.0\n"
            f"    extrinsics: [[{flat(cfg.gps_ext_p)}]]\n"),
        "config.yaml": "config_files: [config_camera.yaml, config_wheel.yaml, config_gps.yaml]\n",
    }
    for name, text in files.items():
        with open(os.path.join(dirpath, name), "w") as f:
            f.write(text)
    return os.path.join(dirpath, "config.yaml")
