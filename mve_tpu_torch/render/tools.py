"""Scene-rendering helpers: frusta, axes, turntable orbits (port of
mve_tpu/render/tools.py, host numpy, copied).

Equivalent of the reference's ogl/render_tools.h (create_axis_renderer,
create_fullscreen_quad) plus the umve scene-inspector addins that draw
camera frusta and SfM points (apps/umve/scene_addins/addin_frusta_base.cc
behavior): produces world-space line-segment sets consumed by
rasterizer.overlay_lines, instead of GL vertex arrays.
"""

from __future__ import annotations

import numpy as np

__all__ = ["frustum_segments", "axis_segments", "aabb_segments",
           "turntable_views", "fit_view_to_points"]


def frustum_segments(cam, size: float = 1.0) -> np.ndarray:
    """Camera frustum wireframe: 4 apex-to-far edges, 4 far-plane edges,
    plus one up-tick marking the image top edge (9 segments).

    cam: core.CameraInfo with valid extrinsics; size = apex-to-far-plane
    distance in world units.  Corners are the normalized image corners
    (±0.5 in MVE's larger-dim-normalized convention) through the focal
    length, matching umve's addin_frusta_base.cc draw_camera shape.
    """
    c2w = cam.cam_to_world()
    far = []
    for cx, cy in ((-0.5, -0.5), (0.5, -0.5), (0.5, 0.5), (-0.5, 0.5)):
        d = np.array([cx / cam.flen, cy / cam.flen, 1.0]) * size
        far.append((c2w[:3, :3] @ d) + c2w[:3, 3])
    far = np.asarray(far)
    apex = cam.camera_pos()
    segs = []
    for i in range(4):
        segs.append([apex, far[i]])
        segs.append([far[i], far[(i + 1) % 4]])
    # small up-tick marking the image top edge (viewer orientation cue)
    top_mid = (far[0] + far[1]) * 0.5
    up = top_mid + (top_mid - (far[2] + far[3]) * 0.5) * 0.2
    segs.append([top_mid, up])
    return np.asarray(segs)


def axis_segments(length: float = 1.0, origin=(0.0, 0.0, 0.0)) -> np.ndarray:
    """XYZ axis tripod as (3,2,3) segments (render_tools.cc axis renderer)."""
    o = np.asarray(origin, np.float64)
    return np.asarray([
        [o, o + [length, 0, 0]],
        [o, o + [0, length, 0]],
        [o, o + [0, 0, length]],
    ])


def aabb_segments(aabb_min, aabb_max) -> np.ndarray:
    """Wireframe of an axis-aligned box (umve AABB-creator addin shape)."""
    lo = np.asarray(aabb_min, np.float64)
    hi = np.asarray(aabb_max, np.float64)
    c = np.array([[lo[0], lo[1], lo[2]], [hi[0], lo[1], lo[2]],
                  [hi[0], hi[1], lo[2]], [lo[0], hi[1], lo[2]],
                  [lo[0], lo[1], hi[2]], [hi[0], lo[1], hi[2]],
                  [hi[0], hi[1], hi[2]], [lo[0], hi[1], hi[2]]])
    e = [(0, 1), (1, 2), (2, 3), (3, 0), (4, 5), (5, 6), (6, 7), (7, 4),
         (0, 4), (1, 5), (2, 6), (3, 7)]
    return np.asarray([[c[a], c[b]] for a, b in e])


def fit_view_to_points(points: np.ndarray, fov_y_deg: float = 45.0):
    """(center, radius) of a bounding sphere sized so `points` fill the view."""
    pts = np.asarray(points, np.float64).reshape(-1, 3)
    center = pts.mean(axis=0)
    r = float(np.max(np.linalg.norm(pts - center, axis=1))) if len(pts) else 1.0
    r = max(r, 1e-6)
    dist = r / np.tan(np.radians(fov_y_deg) * 0.5)
    return center, dist * 1.2


def turntable_views(center, distance: float, n_frames: int,
                    elevation_deg: float = 20.0, up=(0.0, 1.0, 0.0)):
    """Yield (campos, viewdir, up) orbiting `center` — headless turntable.

    Replaces interactive trackball orbiting for batch rendering
    (umve's 3D inspector navigation, consumed frame-by-frame).
    """
    center = np.asarray(center, np.float64)
    up = np.asarray(up, np.float64)
    up = up / np.linalg.norm(up)
    # orthonormal basis around `up`
    seed = np.array([1.0, 0.0, 0.0])
    if abs(np.dot(seed, up)) > 0.9:
        seed = np.array([0.0, 0.0, 1.0])
    x = np.cross(up, seed)
    x /= np.linalg.norm(x)
    z = np.cross(x, up)
    el = np.radians(elevation_deg)
    for i in range(n_frames):
        az = 2.0 * np.pi * i / max(n_frames, 1)
        d = (np.cos(el) * (np.cos(az) * z + np.sin(az) * x)
             + np.sin(el) * up)
        pos = center + d * distance
        viewdir = (center - pos)
        viewdir /= np.linalg.norm(viewdir)
        yield pos, viewdir, up
