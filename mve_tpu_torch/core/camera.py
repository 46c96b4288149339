"""Per-view camera model (reference: libs/mve/camera.h/.cc).

Conventions (identical to the reference so scene files interoperate):

- Intrinsics: focal length ``flen`` normalized by the LARGER image
  dimension; principal point ``ppoint`` in [0,1]^2 (default 0.5);
  pixel aspect ``paspect``; two radial distortion coefficients ``dist``.
  An invalid camera has flen == 0 (camera.h:20-22).
- Extrinsics: ``rot`` is the world-to-camera rotation, ``trans`` the
  world-to-camera translation; camera position is -R^T t (camera.h:33-35).
- K-matrix (camera.cc fill_calibration): for landscape images
  ax = flen*w, ay = flen*w*paspect; for portrait ax = flen*h/paspect,
  ay = flen*h; principal point at (w*ppx, h*ppy). Camera looks along +z.

The dataclass stores plain floats/numpy arrays (host side); the module-level
functions take torch tensors and are batched over leading dimensions.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class CameraInfo:
    """Host-side camera record, serialized to/from view meta.ini."""

    flen: float = 0.0
    ppoint: np.ndarray = dataclasses.field(default_factory=lambda: np.array([0.5, 0.5], np.float32))
    paspect: float = 1.0
    dist: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(2, np.float32))
    trans: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3, np.float32))
    rot: np.ndarray = dataclasses.field(default_factory=lambda: np.eye(3, dtype=np.float32))

    def __post_init__(self):
        self.ppoint = np.asarray(self.ppoint, np.float32).reshape(2)
        self.dist = np.asarray(self.dist, np.float32).reshape(2)
        self.trans = np.asarray(self.trans, np.float32).reshape(3)
        self.rot = np.asarray(self.rot, np.float32).reshape(3, 3)

    @property
    def valid(self) -> bool:
        return self.flen > 0.0

    # -- extrinsics helpers (camera.h:30-75) ------------------------------
    def camera_pos(self) -> np.ndarray:
        """Camera center in world coordinates: -R^T t."""
        return -self.rot.T @ self.trans

    def viewing_direction(self) -> np.ndarray:
        """World-space viewing direction (camera +z axis): third row of R."""
        return self.rot[2].copy()

    def world_to_cam(self) -> np.ndarray:
        """4x4 world-to-camera transform."""
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = self.rot
        m[:3, 3] = self.trans
        return m

    def cam_to_world(self) -> np.ndarray:
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = self.rot.T
        m[:3, 3] = -self.rot.T @ self.trans
        return m

    # -- intrinsics (camera.cc fill_calibration) --------------------------
    def calibration(self, width: float, height: float) -> np.ndarray:
        """3x3 K matrix for the given image dimensions (pure numpy —
        host camera bookkeeping must not touch the device)."""
        image_aspect = width / height * self.paspect
        if image_aspect < 1.0:  # portrait
            ax = self.flen * height / self.paspect
            ay = self.flen * height
        else:
            ax = self.flen * width
            ay = self.flen * width * self.paspect
        return np.array(
            [[ax, 0.0, width * self.ppoint[0]],
             [0.0, ay, height * self.ppoint[1]],
             [0.0, 0.0, 1.0]], np.float64)

    def inverse_calibration(self, width: float, height: float) -> np.ndarray:
        return np.linalg.inv(self.calibration(width, height))

    def reprojection(self, dst: "CameraInfo", src_wh, dst_wh):
        """Pixel reprojection operator (T, t): xd = T xs d + t.

        Depth d is z-depth in the source camera frame (camera.h:105-125).
        """
        sK_i = self.inverse_calibration(*src_wh)
        dK = dst.calibration(*dst_wh)
        R_rel = dst.rot @ self.rot.T
        T = dK @ R_rel @ sK_i
        t = dK @ (dst.trans - R_rel @ self.trans)
        return T.astype(np.float32), t.astype(np.float32)

    # -- (de)serialization to meta.ini value strings ----------------------
    def rotation_string(self) -> str:
        return " ".join(repr(float(x)) for x in self.rot.reshape(-1))

    def translation_string(self) -> str:
        return " ".join(repr(float(x)) for x in self.trans)

    def copy(self) -> "CameraInfo":
        return CameraInfo(
            flen=float(self.flen),
            ppoint=self.ppoint.copy(),
            paspect=float(self.paspect),
            dist=self.dist.copy(),
            trans=self.trans.copy(),
            rot=self.rot.copy(),
        )


# ---------------------------------------------------------------------------
# batched camera math on tensors (device side)
# ---------------------------------------------------------------------------

def calibration_matrix(flen, ppoint, paspect, width, height, device=None):
    """Batched K matrix; follows camera.cc fill_calibration exactly.

    flen: (...,) ppoint: (..., 2); width/height scalars or batched.
    """
    def f32(v):
        return torch.as_tensor(v, dtype=torch.float32, device=device)

    flen, ppoint, paspect = f32(flen), f32(ppoint), f32(paspect)
    width, height = f32(width), f32(height)
    image_aspect = width / height * paspect
    portrait = image_aspect < 1.0
    ax = torch.where(portrait, flen * height / paspect, flen * width)
    ay = torch.where(portrait, flen * height, flen * width * paspect)
    zero = torch.zeros_like(ax)
    one = torch.ones_like(ax)
    cx = (width * ppoint[..., 0]).expand_as(ax)
    cy = (height * ppoint[..., 1]).expand_as(ax)
    return torch.stack([
        torch.stack([ax, zero, cx], dim=-1),
        torch.stack([zero, ay, cy], dim=-1),
        torch.stack([zero, zero, one], dim=-1),
    ], dim=-2)


def project(points_cam, K):
    """Project camera-frame 3D points through K. (..., 3) -> (..., 2).

    Returns image coordinates in the reference's convention (subtract 0.5
    for pixel centers, camera.h:80-86).
    """
    p = torch.einsum("...ij,...j->...i", K, points_cam)
    return p[..., :2] / torch.clamp(p[..., 2:3], min=1e-32)


def distort_normalized(x, y, dist):
    """Apply the reference's radial distortion to normalized image coords.

    The reference BA distortion model (bundle_adjustment.cc radial
    distortion): factor = 1 + r2*(k0 + k1*r2), applied to the normalized
    (pre-K) coordinates.
    """
    r2 = x * x + y * y
    factor = 1.0 + r2 * (dist[..., 0] + dist[..., 1] * r2)
    return x * factor, y * factor


def world_to_cam_points(points_world, rot, trans):
    """(..., N, 3) world points -> camera frame. rot (..., 3, 3)."""
    return torch.einsum("...ij,...nj->...ni", rot, points_world) + trans[..., None, :]
