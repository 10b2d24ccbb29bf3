"""KAIST Complex Urban dataset reader (port of plviwo_tpu/data/kaist.py).

The reference replays pre-assembled rosbags of this dataset
(`run_bag.cpp:176-266`, topics configured in `config/kaist/*`); the raw
dataset layout (https://sites.google.com/view/complex-urban-dataset) is:

    sensor_data/
      xsens_imu.csv         # t_ns, qx qy qz qw, ex ey ez, gx gy gz, ax ay az, mx my mz
      encoder.csv           # t_ns, left_count, right_count
      vrs_gps.csv / gps.csv # t_ns, lat, lon, alt, covariances...
      stereo/left/<t_ns>.png
      data_stamp.csv        # t_ns, sensor_name   (global ordering)
    calibration/            # EncoderParameter.txt, Vehicle2IMU.txt, ...
    global_pose.csv         # t_ns, 4x3 row-major pose (ground truth)

This reader streams time-ordered measurements without ROS: IMU, wheel and
GPS from the CSVs (the native parser of `native.py` where it builds, the
same Python parse otherwise; wheel counts differentiated into rates), and
images decoded lazily by the port's PNG reader (`data/png.py`, no Pillow).
Everything is gated on the files being present.
"""

from __future__ import annotations

import os

import numpy as np

from .. import native
from . import png


def _load_csv(path, ncols=None):
    """(rows, cols) float64: commas and blanks separate fields, a line with a
    non-numeric token is skipped, each row keeps its first ncols fields."""
    arr = native.load_csv(path, ncols or 0)  # None without the native library
    if arr is not None:
        return arr
    rows = []
    with open(path) as f:
        for line in f:
            parts = line.strip().replace(",", " ").split()
            if not parts:
                continue
            try:
                rows.append([float(x) for x in parts[: ncols or len(parts)]])
            except ValueError:
                continue
    return np.asarray(rows)


class KaistDataset:
    ENCODER_RESOLUTION = 4096  # ticks/rev (EncoderParameter.txt default)

    def __init__(self, root: str):
        self.root = root
        sd = os.path.join(root, "sensor_data")
        self.has_imu = os.path.exists(os.path.join(sd, "xsens_imu.csv"))
        self.has_encoder = os.path.exists(os.path.join(sd, "encoder.csv"))
        self.gps_file = next(
            (os.path.join(sd, n) for n in ("vrs_gps.csv", "gps.csv")
             if os.path.exists(os.path.join(sd, n))), None)
        self.left_dir = os.path.join(sd, "stereo", "left")
        self.right_dir = os.path.join(sd, "stereo", "right")
        self.has_images = os.path.isdir(self.left_dir)
        self.has_stereo = os.path.isdir(self.right_dir)
        self._load_calibration()

    # ------------------------------------------------------------------
    def _load_calibration(self):
        """Encoder intrinsics + extrinsics from calibration/*.txt."""
        self.wheel_intr = np.array([0.623479, 0.622806, 1.52439])  # rl rr base (urban defaults)
        self.resolution = self.ENCODER_RESOLUTION
        calib = os.path.join(self.root, "calibration", "EncoderParameter.txt")
        if os.path.exists(calib):
            vals = {}
            with open(calib) as f:
                for line in f:
                    if ":" in line:
                        k, v = line.split(":", 1)
                        try:
                            vals[k.strip()] = float(v.strip())
                        except ValueError:
                            pass
            self.resolution = vals.get("Encoder resolution", self.resolution)
            self.wheel_intr = np.array([
                vals.get("Encoder left wheel diameter", 1.246958) / 2.0,
                vals.get("Encoder right wheel diameter", 1.245612) / 2.0,
                vals.get("Encoder wheel base", 1.52439),
            ])

    # ------------------------------------------------------------------
    def imu(self):
        """(t (N,), w (N,3), a (N,3)) in seconds / rad/s / m/s^2."""
        arr = _load_csv(os.path.join(self.root, "sensor_data", "xsens_imu.csv"))
        t = arr[:, 0] * 1e-9
        w = arr[:, 8:11]
        a = arr[:, 11:14]
        return t, w, a

    def wheel(self):
        """(t (M,), rate_left (M,), rate_right (M,)) wheel angular rates.

        Encoder counts are differentiated: rate = dcount/dt * 2 pi / resolution.
        """
        arr = _load_csv(os.path.join(self.root, "sensor_data", "encoder.csv"))
        t = arr[:, 0] * 1e-9
        counts = arr[:, 1:3]
        dt = np.diff(t)
        good = dt > 1e-6
        rate = np.diff(counts, axis=0) / np.where(good, dt, 1.0)[:, None]
        rate *= 2.0 * np.pi / self.resolution
        return t[1:][good], rate[good, 0], rate[good, 1]

    def gps(self):
        """(t (K,), lat, lon, alt)."""
        if self.gps_file is None:
            return np.zeros(0), np.zeros(0), np.zeros(0), np.zeros(0)
        arr = _load_csv(self.gps_file)
        return arr[:, 0] * 1e-9, arr[:, 1], arr[:, 2], arr[:, 3]

    def _image_stamps_ns(self):
        """Sorted integer-ns image stamps (cached).  KAIST stamps are unix
        ns (~1.5e18): float64 seconds cannot round-trip them exactly (ulp
        ~256 ns), so filename lookup must go through this integer list."""
        if not hasattr(self, "_img_ns"):
            self._img_ns = np.asarray(sorted(
                int(f.split(".")[0]) for f in os.listdir(self.left_dir)
                if f.endswith(".png")), dtype=np.int64)
        return self._img_ns

    def image_times(self):
        if not self.has_images:
            return np.zeros(0)
        return self._image_stamps_ns().astype(np.float64) * 1e-9

    def image(self, t, cam: int = 0):
        """Grayscale float32 image in [0, 1] at timestamp t.  cam=0 ->
        stereo/left, cam=1 -> stereo/right.  t is matched to the nearest
        on-disk integer stamp (exact to float64 time resolution)."""
        stamps = self._image_stamps_ns()
        i = int(np.argmin(np.abs(stamps.astype(np.float64) * 1e-9 - t)))
        d = self.left_dir if cam == 0 else self.right_dir
        path = os.path.join(d, f"{int(stamps[i])}.png")
        return png.read_gray(path).astype(np.float32) / 255.0

    def ground_truth(self):
        """(t (N,), p (N,3), R (N,3,3)) from global_pose.csv."""
        path = os.path.join(self.root, "global_pose.csv")
        if not os.path.exists(path):
            return np.zeros(0), np.zeros((0, 3)), np.zeros((0, 3, 3))
        arr = _load_csv(path)
        t = arr[:, 0] * 1e-9
        M = arr[:, 1:13].reshape(-1, 3, 4)
        return t, M[:, :, 3], M[:, :, :3]

    def stream(self):
        """Yield time-ordered (t, kind, payload) tuples for replay
        (the run_bag message loop equivalent)."""
        events = []
        if self.has_imu:
            t, w, a = self.imu()
            events.extend((ti, "imu", (wi, ai)) for ti, wi, ai in zip(t, w, a))
        if self.has_encoder:
            t, rl, rr = self.wheel()
            events.extend((ti, "wheel", (l, r)) for ti, l, r in zip(t, rl, rr))
        if self.gps_file:
            t, la, lo, al = self.gps()
            events.extend(
                (ti, "gps", (lai, loi, ali)) for ti, lai, loi, ali in zip(t, la, lo, al))
        for ti in self.image_times():
            events.append((ti, "image", None))
        events.sort(key=lambda e: e[0])
        yield from events
