"""Visualization outputs (port of plviwo_tpu/utils/viz.py; a file-based
analogue of the reference's rviz publishers,
`PL-VIWO/src/core/ROSPublisher.h:36-57`): per-frame tracking overlays, and
3-D MSCKF/SLAM feature and line dumps.

No ROS / OpenCV / matplotlib dependency: overlays are rasterized with
numpy and written as RGB PNG through the port's own codec (`data/png.py`:
the pixels matplotlib's `imsave` writes for the JAX package, without its
alpha channel); 3-D geometry goes to PLY files any point-cloud viewer
opens, plus a JSON summary.  Host numpy only: `VioSystem` reads the device
for these hooks only when `viz` is set.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..ops import lie


# ---------------------------------------------------------------------------
# raster helpers
# ---------------------------------------------------------------------------

def _draw_segment(img, p0, p1, color):
    """Draw a line segment into an (H, W, 3) uint8 image (numpy raster)."""
    h, w = img.shape[:2]
    n = int(max(abs(p1[0] - p0[0]), abs(p1[1] - p0[1]), 1)) + 1
    xs = np.linspace(p0[0], p1[0], n).round().astype(int)
    ys = np.linspace(p0[1], p1[1], n).round().astype(int)
    m = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    img[ys[m], xs[m]] = color


def _draw_cross(img, p, color, r=2):
    _draw_segment(img, (p[0] - r, p[1]), (p[0] + r, p[1]), color)
    _draw_segment(img, (p[0], p[1] - r), (p[0], p[1] + r), color)


def save_image(path, img):
    """Write an (H, W, 3) uint8 image as an RGB PNG (".png" appended when
    the path lacks it).  Returns the path written."""
    from ..data.png import write_rgb

    if not path.endswith(".png"):
        path += ".png"
    write_rgb(path, np.asarray(img, dtype=np.uint8))
    return path


def tracking_overlay(gray, pts_uv=None, pts_prev_uv=None, segs_uv=None):
    """Build a tracking-overlay RGB image (reference: the tracking image the
    ROS publisher emits, ROSPublisher `publish_cam_images`).

    gray: (H, W) float or uint8 image.  pts_uv: (N, 2) current features
    (green crosses); pts_prev_uv: (N, 2) previous positions (red motion
    tails); segs_uv: (L, 4) line segments (blue).
    """
    g = np.asarray(gray)
    if g.dtype != np.uint8:
        g = np.clip(g * (255.0 if g.max() <= 1.5 else 1.0), 0, 255).astype(np.uint8)
    img = np.stack([g, g, g], axis=-1).copy()
    if segs_uv is not None:
        for s in np.asarray(segs_uv):
            _draw_segment(img, (s[0], s[1]), (s[2], s[3]), (80, 120, 255))
    if pts_uv is not None:
        pts_uv = np.asarray(pts_uv)
        if pts_prev_uv is not None:
            for p0, p1 in zip(np.asarray(pts_prev_uv), pts_uv):
                _draw_segment(img, (p0[0], p0[1]), (p1[0], p1[1]), (255, 80, 80))
        for p in pts_uv:
            _draw_cross(img, p, (0, 255, 0))
    return img


# ---------------------------------------------------------------------------
# 3-D dumps
# ---------------------------------------------------------------------------

def save_ply_points(path, points, color=(0, 255, 0)):
    points = np.asarray(points, dtype=np.float64).reshape(-1, 3)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(points)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        for p in points:
            f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
                    f"{color[0]} {color[1]} {color[2]}\n")
    return path


def save_ply_lines(path, endpoints, color=(80, 120, 255)):
    """endpoints: (L, 6) rows [x0 y0 z0 x1 y1 z1] — written as PLY edges."""
    eps = np.asarray(endpoints, dtype=np.float64).reshape(-1, 6)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {2 * len(eps)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write(f"element edge {len(eps)}\n")
        f.write("property int vertex1\nproperty int vertex2\n")
        f.write("end_header\n")
        for e in eps:
            for k in (0, 3):
                f.write(f"{e[k]:.6f} {e[k+1]:.6f} {e[k+2]:.6f} "
                        f"{color[0]} {color[1]} {color[2]}\n")
        for i in range(len(eps)):
            f.write(f"{2*i} {2*i+1}\n")
    return path


def line_display_endpoints(n_G, v_G, seg_uvn, q_clone, p_clone, cam_q, cam_p):
    """3-D display endpoints for a triangulated Plücker line: the points on
    the infinite line closest to the two endpoint back-projection rays of an
    observation (the reference publishes per-line display endpoints computed
    from observations, ROSHelper::ToMarker)."""
    def rot(q):
        return lie.quat_2_rot(torch.as_tensor(np.asarray(q, dtype=np.float64))).numpy()

    R_GtoI = rot(q_clone)
    R_ItoC = rot(cam_q)
    R_GtoC = R_ItoC @ R_GtoI
    c = np.asarray(p_clone) - R_GtoC.T @ np.asarray(cam_p)
    v = np.asarray(v_G) / max(np.linalg.norm(v_G), 1e-12)
    p0 = np.cross(v, np.asarray(n_G))  # closest point to origin on the line
    out = []
    for k in (0, 2):
        d_C = np.array([seg_uvn[k], seg_uvn[k + 1], 1.0])
        d = R_GtoC.T @ d_C
        d = d / np.linalg.norm(d)
        # closest point on line (p0 + t v) to ray (c + s d)
        w0 = p0 - c
        a, b, cc = 1.0, float(v @ d), 1.0
        dd, e = float(v @ w0), float(d @ w0)
        denom = a * cc - b * b
        t = (b * e - cc * dd) / denom if abs(denom) > 1e-9 else 0.0
        out.append(p0 + t * v)
    return np.concatenate(out)


class VizRecorder:
    """Collects per-frame overlays and 3-D geometry; writes to a directory.

    Attach to a `VioSystem` via `system.viz = VizRecorder(dir)`: the MSCKF
    and line updates then deposit their accepted triangulations here.
    """

    def __init__(self, out_dir: str, max_frames: int = 100000):
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)
        self.points = []       # (t, (N,3))
        self.lines = []        # (t, (L,6))
        self.slam_points = []  # (t, (S,3))
        self.n_overlays = 0
        self.max_frames = max_frames

    def add_points(self, t, pts):
        if len(pts):
            self.points.append((float(t), np.asarray(pts)))

    def add_slam_points(self, t, pts):
        if len(pts):
            self.slam_points.append((float(t), np.asarray(pts)))

    def add_lines(self, t, endpoints):
        if len(endpoints):
            self.lines.append((float(t), np.asarray(endpoints)))

    def add_overlay(self, t, gray, pts_uv=None, pts_prev_uv=None, segs_uv=None):
        if self.n_overlays >= self.max_frames:
            return None
        img = tracking_overlay(gray, pts_uv, pts_prev_uv, segs_uv)
        path = os.path.join(self.out_dir, f"track_{self.n_overlays:05d}")
        self.n_overlays += 1
        return save_image(path, img)

    def save(self):
        summary = {"overlays": self.n_overlays}
        if self.points:
            allp = np.concatenate([p for _, p in self.points])
            save_ply_points(os.path.join(self.out_dir, "msckf_points.ply"), allp)
            summary["msckf_points"] = int(len(allp))
        if self.slam_points:
            allp = np.concatenate([p for _, p in self.slam_points])
            save_ply_points(os.path.join(self.out_dir, "slam_points.ply"),
                            allp, color=(255, 80, 80))
            summary["slam_points"] = int(len(allp))
        if self.lines:
            alll = np.concatenate([l for _, l in self.lines])
            save_ply_lines(os.path.join(self.out_dir, "lines.ply"), alll)
            summary["lines"] = int(len(alll))
        with open(os.path.join(self.out_dir, "viz_summary.json"), "w") as f:
            json.dump(summary, f)
        return summary
