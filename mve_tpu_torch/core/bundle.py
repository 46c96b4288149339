"""SfM bundle: cameras + sparse 3D features (reference: libs/mve/bundle.h).

A Bundle pairs the per-view cameras with the reconstructed sparse points.
Each Feature3D carries position, color and the list of observing views
(Feature2D refs with per-view feature id and 2D position), exactly the
reference's data model (bundle.h Feature2D/Feature3D structs).

Storage here is struct-of-arrays (numpy) rather than array-of-structs:
positions (N,3) f32, colors (N,3) f32, and a ragged ref table — the layout
device code wants for batched reprojection.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from .camera import CameraInfo


@dataclasses.dataclass
class Feature2D:
    """Observation of a 3D feature in one view (bundle.h Feature2D)."""

    view_id: int
    feature_id: int
    pos: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(2, np.float32))


@dataclasses.dataclass
class Feature3D:
    """Sparse 3D point with color and observations (bundle.h Feature3D)."""

    pos: np.ndarray
    color: np.ndarray  # float RGB in [0, 1]
    refs: List[Feature2D] = dataclasses.field(default_factory=list)

    def contains_view_id(self, view_id: int) -> bool:
        return any(r.view_id == view_id for r in self.refs)


class Bundle:
    """Cameras + features (bundle.h:30-90)."""

    def __init__(self):
        self.cameras: List[CameraInfo] = []
        self.features: List[Feature3D] = []

    def get_num_cameras(self) -> int:
        return len(self.cameras)

    def get_num_features(self) -> int:
        return len(self.features)

    def get_byte_size(self) -> int:
        return len(self.cameras) * 17 * 4 + sum(6 * 4 + len(f.refs) * 16 for f in self.features)

    # -- struct-of-arrays accessors for device code -----------------------
    def feature_positions(self) -> np.ndarray:
        if not self.features:
            return np.zeros((0, 3), np.float32)
        return np.stack([f.pos for f in self.features]).astype(np.float32)

    def feature_colors(self) -> np.ndarray:
        if not self.features:
            return np.zeros((0, 3), np.float32)
        return np.stack([f.color for f in self.features]).astype(np.float32)

    def delete_camera(self, index: int) -> None:
        """Invalidate a camera and drop feature refs to it
        (bundle.cc delete_camera: refs are removed, camera zeroed)."""
        self.cameras[index] = CameraInfo()
        for f in self.features:
            f.refs = [r for r in f.refs if r.view_id != index]
