"""Camera pose container P = K [R|t] (reference: libs/sfm/camera_pose.h).

K is in normalized image coordinates (focal length w.r.t. larger image
dimension = 1 convention, matching FeatureSet position normalization).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class CameraPose:
    K: np.ndarray = dataclasses.field(default_factory=lambda: np.eye(3))
    R: np.ndarray = dataclasses.field(default_factory=lambda: np.eye(3))
    t: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))

    def init_canonical_form(self) -> None:
        """First camera of a pair: [I|0] (camera_pose.h:40)."""
        self.R = np.eye(3)
        self.t = np.zeros(3)

    def set_k_matrix(self, flen: float, px: float, py: float) -> None:
        self.K = np.array([[flen, 0, px], [0, flen, py], [0, 0, 1]], np.float64)

    def get_focal_length(self) -> float:
        return float((self.K[0, 0] + self.K[1, 1]) / 2.0)

    def fill_p_matrix(self) -> np.ndarray:
        return self.K @ np.concatenate([self.R, self.t[:, None]], axis=1)

    def fill_camera_pos(self) -> np.ndarray:
        return -self.R.T @ self.t

    def is_valid(self) -> bool:
        return self.K[0, 0] != 0.0
