"""Headless rendering layer (port of mve_tpu/render): the equivalent of
libs/ogl and the umve 3D inspector's draw path (SURVEY §2.7, §2.8) —
camera and trackball math and scene wireframes on the host, a z-buffer
software rasterizer in PyTorch on the device.
"""

from .camera import Camera, CamTrackball, Camera2D, look_at, frustum_matrix
from .rasterizer import render_mesh, overlay_points, overlay_lines
from .tools import (frustum_segments, axis_segments, aabb_segments,
                    turntable_views, fit_view_to_points)

__all__ = [
    "Camera", "CamTrackball", "Camera2D", "look_at", "frustum_matrix",
    "render_mesh", "overlay_points", "overlay_lines",
    "frustum_segments", "axis_segments", "aabb_segments",
    "turntable_views", "fit_view_to_points",
]
