"""Viewing/projection cameras + trackball navigation (headless).

Port of mve_tpu/render/camera.py (host numpy, copied). The equivalent of
the reference's GUI camera stack (libs/ogl/camera.h:33-108,
camera_trackball.h:24-63, camera_2d.h): the
same viewing model — world->camera view matrix, GL-style frustum
projection into the unit cube, and a virtual-trackball controller — but
as plain array math feeding the software rasterizer instead of an
OpenGL context.  All matrices are numpy float32 (4,4), row-vector-free
convention (column vectors, y-up, camera looks down -z like OpenGL).
"""

from __future__ import annotations

import numpy as np

__all__ = ["Camera", "CamTrackball", "Camera2D", "look_at", "frustum_matrix"]


def _rodrigues_to_matrix(r) -> np.ndarray:
    """Axis-angle 3-vector -> 3x3 rotation, in numpy: mve_tpu's
    math.rotation.rodrigues_to_matrix on a host array, step for step (the
    port's math.rotation computes in torch, whose sin and cos may round
    differently)."""
    r = np.asarray(r)
    a2 = np.sum(r * r, axis=-1)
    a = np.sqrt(np.maximum(a2, 1e-32))
    small = a2 < 1e-12
    sinc = np.where(small, 1.0 - a2 / 6.0, np.sin(a) / a)
    cosc = np.where(small, 0.5 - a2 / 24.0, (1.0 - np.cos(a)) / np.maximum(a2, 1e-32))
    rx, ry, rz = r[..., 0], r[..., 1], r[..., 2]
    zero = np.zeros_like(rx)
    K = np.stack([np.stack([zero, -rz, ry], axis=-1),
                  np.stack([rz, zero, -rx], axis=-1),
                  np.stack([-ry, rx, zero], axis=-1)], axis=-2)
    eye = np.broadcast_to(np.eye(3, dtype=K.dtype), K.shape)
    return eye + sinc[..., None, None] * K + cosc[..., None, None] * (K @ K)


def look_at(pos, viewing_dir, up_vec) -> np.ndarray:
    """World->camera matrix from position, viewing direction and up vector."""
    pos = np.asarray(pos, np.float64)
    z = -np.asarray(viewing_dir, np.float64)
    z = z / np.linalg.norm(z)
    x = np.cross(np.asarray(up_vec, np.float64), z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    view = np.eye(4)
    view[0, :3] = x
    view[1, :3] = y
    view[2, :3] = z
    view[:3, 3] = -view[:3, :3] @ pos
    return view.astype(np.float32)


def frustum_matrix(right: float, top: float, z_near: float,
                   z_far: float) -> np.ndarray:
    """Symmetric GL perspective frustum (left=-right, bottom=-top)."""
    proj = np.zeros((4, 4))
    proj[0, 0] = z_near / right
    proj[1, 1] = z_near / top
    proj[2, 2] = -(z_far + z_near) / (z_far - z_near)
    proj[2, 3] = -2.0 * z_far * z_near / (z_far - z_near)
    proj[3, 2] = -1.0
    return proj.astype(np.float32)


class Camera:
    """Viewing + projection camera (reference ogl::Camera semantics).

    Attributes mirror the reference: pos/viewing_dir/up_vec for the view
    matrix; z_near/z_far/top/right for the projection; width/height for
    the viewport.  ``update_matrices()`` fills view/inv_view/proj/inv_proj.
    """

    def __init__(self):
        self.pos = np.array([0.0, 0.0, 5.0], np.float32)
        self.viewing_dir = np.array([0.0, 0.0, -1.0], np.float32)
        self.up_vec = np.array([0.0, 1.0, 0.0], np.float32)
        self.z_near = 0.1
        self.z_far = 500.0
        self.top = 0.1
        self.right = 0.1
        self.width = 800
        self.height = 600
        self.view = np.eye(4, dtype=np.float32)
        self.inv_view = np.eye(4, dtype=np.float32)
        self.proj = np.eye(4, dtype=np.float32)
        self.inv_proj = np.eye(4, dtype=np.float32)

    def set_fov(self, fov_y_deg: float) -> None:
        """Set top/right from a vertical field of view and the aspect."""
        self.top = self.z_near * float(np.tan(np.radians(fov_y_deg) * 0.5))
        self.right = self.top * self.width / float(self.height)

    def update_matrices(self) -> None:
        self.update_view_mat()
        self.update_proj_mat()

    def update_view_mat(self) -> None:
        self.view = look_at(self.pos, self.viewing_dir, self.up_vec)
        self.inv_view = np.linalg.inv(self.view.astype(np.float64)).astype(
            np.float32)

    def update_proj_mat(self) -> None:
        self.proj = frustum_matrix(self.right, self.top, self.z_near,
                                   self.z_far)
        self.inv_proj = np.linalg.inv(self.proj.astype(np.float64)).astype(
            np.float32)


class CamTrackball:
    """Virtual trackball controller (reference ogl::CamTrackball behavior).

    State is (center, unit to-camera vector, up vector, radius); the
    camera orbits ``center`` at distance ``radius``.  Headless API:
    ``rotate(x0,y0,x1,y1)`` applies the great-circle rotation between two
    screen points' ball normals, ``zoom(factor)`` scales the radius,
    ``pan(dx,dy)`` translates the center in the view plane.
    """

    def __init__(self, camera: Camera):
        self.cam = camera
        self.tb_center = np.zeros(3)
        self.tb_tocam = np.array([0.0, 0.0, 1.0])
        self.tb_upvec = np.array([0.0, 1.0, 0.0])
        self.tb_radius = 1.0

    def set_camera_params(self, center, lookat, upvec) -> None:
        center = np.asarray(center, np.float64)
        lookat = np.asarray(lookat, np.float64)
        self.tb_center = lookat.copy()
        tocam = center - lookat
        self.tb_radius = max(float(np.linalg.norm(tocam)), 1e-6)
        self.tb_tocam = tocam / self.tb_radius
        self.tb_upvec = np.asarray(upvec, np.float64)
        self.apply_to_camera()

    # --- navigation -------------------------------------------------
    def _ball_normal(self, x: int, y: int) -> np.ndarray:
        """Screen point -> unit normal on the virtual ball (camera frame)."""
        w, h = self.cam.width, self.cam.height
        r = min(w, h) * 0.5
        px = (x - w * 0.5) / r
        py = (h * 0.5 - y) / r
        d2 = px * px + py * py
        if d2 <= 0.5:  # on the sphere
            pz = np.sqrt(max(1.0 - d2, 0.0))
        else:  # hyperbolic sheet outside, keeps rotation continuous
            pz = 0.5 / np.sqrt(d2)
        n = np.array([px, py, pz])
        return n / np.linalg.norm(n)

    def rotate(self, x0: int, y0: int, x1: int, y1: int) -> None:
        n0 = self._ball_normal(x0, y0)
        n1 = self._ball_normal(x1, y1)
        # Express ball normals in world frame via current camera basis.
        z = self.tb_tocam
        xaxis = np.cross(self.tb_upvec, z)
        xaxis /= max(np.linalg.norm(xaxis), 1e-12)
        yaxis = np.cross(z, xaxis)
        to_world = np.stack([xaxis, yaxis, z], axis=1)
        w0, w1 = to_world @ n0, to_world @ n1
        axis = np.cross(w1, w0)
        s = np.linalg.norm(axis)
        if s < 1e-12:
            return
        angle = float(np.arctan2(s, np.clip(np.dot(w0, w1), -1.0, 1.0)))
        axis /= s
        rot = _rodrigues_to_matrix(axis * angle)
        self.tb_tocam = rot @ self.tb_tocam
        self.tb_upvec = rot @ self.tb_upvec
        self.apply_to_camera()

    def zoom(self, factor: float) -> None:
        self.tb_radius = max(self.tb_radius * float(factor), 1e-6)
        self.apply_to_camera()

    def pan(self, dx: float, dy: float) -> None:
        z = self.tb_tocam
        xaxis = np.cross(self.tb_upvec, z)
        xaxis /= max(np.linalg.norm(xaxis), 1e-12)
        yaxis = np.cross(z, xaxis)
        scale = self.tb_radius
        self.tb_center = self.tb_center - xaxis * dx * scale + yaxis * dy * scale
        self.apply_to_camera()

    # --- read-out ---------------------------------------------------
    def get_campos(self) -> np.ndarray:
        return self.tb_center + self.tb_tocam * self.tb_radius

    def get_viewdir(self) -> np.ndarray:
        return -self.tb_tocam

    def get_upvec(self) -> np.ndarray:
        return self.tb_upvec

    def apply_to_camera(self) -> None:
        self.cam.pos = self.get_campos().astype(np.float32)
        self.cam.viewing_dir = self.get_viewdir().astype(np.float32)
        self.cam.up_vec = self.tb_upvec.astype(np.float32)
        self.cam.update_matrices()


class Camera2D:
    """Pan/zoom controller for flat image inspection (ogl::Camera2D role).

    Maps image pixel coordinates to viewport pixels: ``vp = (img - offset)
    * zoom``.  Used by the headless view inspector for crop/export.
    """

    def __init__(self, width: int, height: int):
        self.width = width
        self.height = height
        self.zoom = 1.0
        self.offset = np.zeros(2)

    def fit(self, img_w: int, img_h: int) -> None:
        self.zoom = min(self.width / img_w, self.height / img_h)
        self.offset = np.array([
            (img_w - self.width / self.zoom) * 0.5,
            (img_h - self.height / self.zoom) * 0.5,
        ])

    def image_to_viewport(self, pts) -> np.ndarray:
        return (np.asarray(pts, np.float64) - self.offset) * self.zoom

    def viewport_to_image(self, pts) -> np.ndarray:
        return np.asarray(pts, np.float64) / self.zoom + self.offset
