"""BA problem containers (reference: libs/sfm/ba_types.h).

Camera = 9 params [flen, k0, k1, t0, t1, t2, (r0, r1, r2)] where r is the
Rodrigues increment linearized at the current rotation (ba_types.h Camera,
bundle_adjustment.cc:662-688 update rule). Storage is struct-of-arrays so
the whole problem ships to the device as a handful of dense tensors
(a numpy copy of mve_tpu/sfm/ba/problem.py).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List

import numpy as np


class BundleMode(enum.IntFlag):
    """bundle_adjustment.h:54-59."""

    CAMERAS = 1
    POINTS = 2
    CAMERAS_AND_POINTS = 3


@dataclasses.dataclass
class BACamera:
    focal_length: float = 0.0
    distortion: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(2))
    translation: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    rotation: np.ndarray = dataclasses.field(default_factory=lambda: np.eye(3))
    is_constant: bool = False


@dataclasses.dataclass
class BAPoint:
    pos: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    is_constant: bool = False


@dataclasses.dataclass
class BAObservation:
    pos: np.ndarray  # (2,) normalized image coordinates
    camera_id: int
    point_id: int


class BAProblem:
    """Struct-of-arrays view of a BA problem."""

    def __init__(self, cameras: List[BACamera], points: List[BAPoint],
                 observations: List[BAObservation]):
        self.cameras = cameras
        self.points = points
        self.observations = observations

    # -- dense tensor export -------------------------------------------
    def camera_arrays(self):
        C = len(self.cameras)
        intr = np.zeros((C, 3), np.float64)  # f, k0, k1
        trans = np.zeros((C, 3), np.float64)
        rot = np.zeros((C, 3, 3), np.float64)
        const = np.zeros(C, bool)
        for i, c in enumerate(self.cameras):
            intr[i] = [c.focal_length, c.distortion[0], c.distortion[1]]
            trans[i] = c.translation
            rot[i] = c.rotation
            const[i] = c.is_constant
        return intr, trans, rot, const

    def point_array(self):
        return np.array([p.pos for p in self.points], np.float64).reshape(-1, 3), \
            np.array([p.is_constant for p in self.points], bool)

    def observation_arrays(self):
        O = len(self.observations)
        pos = np.zeros((O, 2), np.float64)
        cam_idx = np.zeros(O, np.int32)
        pt_idx = np.zeros(O, np.int32)
        for i, o in enumerate(self.observations):
            pos[i] = o.pos
            cam_idx[i] = o.camera_id
            pt_idx[i] = o.point_id
        return pos, cam_idx, pt_idx

    # -- write back ----------------------------------------------------
    def update_from_arrays(self, intr, trans, rot, points):
        for i, c in enumerate(self.cameras):
            c.focal_length = float(intr[i, 0])
            c.distortion = np.array(intr[i, 1:3])
            c.translation = np.array(trans[i])
            c.rotation = np.array(rot[i])
        for i, p in enumerate(self.points):
            p.pos = np.array(points[i])
