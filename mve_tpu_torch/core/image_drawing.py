"""Debug rasterization: lines, circles, boxes
(reference: libs/mve/image_drawing.h — used by the sfm visualizer; port
of mve_tpu/core/image_drawing.py, host numpy, copied).

Operates in place on (H, W, C) numpy arrays.
"""

from __future__ import annotations

import numpy as np


def draw_line(img: np.ndarray, x0: int, y0: int, x1: int, y1: int, color) -> None:
    """Bresenham line."""
    h, w = img.shape[:2]
    color = np.asarray(color, img.dtype)
    dx = abs(x1 - x0)
    dy = -abs(y1 - y0)
    sx = 1 if x0 < x1 else -1
    sy = 1 if y0 < y1 else -1
    err = dx + dy
    x, y = x0, y0
    while True:
        if 0 <= x < w and 0 <= y < h:
            img[y, x] = color
        if x == x1 and y == y1:
            break
        e2 = 2 * err
        if e2 >= dy:
            err += dy
            x += sx
        if e2 <= dx:
            err += dx
            y += sy


def draw_circle(img: np.ndarray, cx: int, cy: int, radius: int, color) -> None:
    """Midpoint circle."""
    h, w = img.shape[:2]
    color = np.asarray(color, img.dtype)

    def put(x, y):
        if 0 <= x < w and 0 <= y < h:
            img[y, x] = color

    x, y = radius, 0
    err = 1 - radius
    while x >= y:
        for px, py in ((x, y), (y, x), (-y, x), (-x, y),
                       (-x, -y), (-y, -x), (y, -x), (x, -y)):
            put(cx + px, cy + py)
        y += 1
        if err < 0:
            err += 2 * y + 1
        else:
            x -= 1
            err += 2 * (y - x) + 1


def draw_box(img: np.ndarray, x0: int, y0: int, x1: int, y1: int, color) -> None:
    draw_line(img, x0, y0, x1, y0, color)
    draw_line(img, x1, y0, x1, y1, color)
    draw_line(img, x1, y1, x0, y1, color)
    draw_line(img, x0, y1, x0, y0, color)


def draw_rectangle_filled(img: np.ndarray, x0: int, y0: int, x1: int, y1: int,
                          color) -> None:
    h, w = img.shape[:2]
    x0c, x1c = max(0, min(x0, x1)), min(w, max(x0, x1) + 1)
    y0c, y1c = max(0, min(y0, y1)), min(h, max(y0, y1) + 1)
    img[y0c:y1c, x0c:x1c] = np.asarray(color, img.dtype)
