"""Debug visualization of keypoints and matches
(reference: libs/sfm/visualizer.h:45-57, visualizer.cc; port of
mve_tpu/sfm/visualizer.py, host numpy, copied).

Draws keypoint circles (radius from feature scale) and match lines into
byte images using the core rasterizer.
"""

from __future__ import annotations

import numpy as np

from ..core.image_drawing import draw_circle, draw_line


def draw_keypoints(image: np.ndarray, xs, ys, scales=None,
                   color=(255, 255, 0)) -> np.ndarray:
    """Returns a copy of `image` with keypoint circles drawn."""
    out = np.ascontiguousarray(image).copy()
    if out.ndim == 2:
        out = np.stack([out] * 3, axis=-1)
    xs = np.asarray(xs)
    ys = np.asarray(ys)
    if scales is None:
        scales = np.full(len(xs), 3.0)
    for x, y, s in zip(xs, ys, np.asarray(scales)):
        draw_circle(out, int(round(x)), int(round(y)),
                    max(int(round(s)), 1), color)
    return out


def draw_matches(image1: np.ndarray, image2: np.ndarray,
                 p1, p2, color=(0, 255, 0)) -> np.ndarray:
    """Side-by-side match visualization (visualizer.cc draw_matches)."""
    im1 = np.ascontiguousarray(image1)
    im2 = np.ascontiguousarray(image2)
    if im1.ndim == 2:
        im1 = np.stack([im1] * 3, axis=-1)
    if im2.ndim == 2:
        im2 = np.stack([im2] * 3, axis=-1)
    h = max(im1.shape[0], im2.shape[0])
    w = im1.shape[1] + im2.shape[1]
    canvas = np.zeros((h, w, 3), im1.dtype)
    canvas[: im1.shape[0], : im1.shape[1]] = im1[:, :, :3]
    canvas[: im2.shape[0], im1.shape[1] :] = im2[:, :, :3]
    off = im1.shape[1]
    for (x1, y1), (x2, y2) in zip(np.asarray(p1), np.asarray(p2)):
        draw_line(canvas, int(round(x1)), int(round(y1)),
                  int(round(x2)) + off, int(round(y2)), color)
    return canvas
