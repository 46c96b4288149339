"""Bundler data structures, feature undistortion, survey points and
prebundle serialisation (reference: libs/sfm/bundler_common.h/.cc; a
numpy copy of mve_tpu/sfm/bundler/common.py).

The prebundle.sfm binary format is byte-compatible with the reference
and mve_tpu (bundler_common.cc:56-113): "MVE_PREBUNDLE\\n" signature,
int32 counts, float32 positions, uint8 colours, int32 match index pairs
— all little-endian.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Dict, List

import numpy as np

from ..pose import CameraPose

PREBUNDLE_SIGNATURE = b"MVE_PREBUNDLE\n"


@dataclasses.dataclass
class FeatureReference:
    """(view_id, feature_id) (bundler_common.h:70-80)."""

    view_id: int
    feature_id: int


class Track:
    """A 3D feature track (bundler_common.h Track). Invalid = NaN pos."""

    __slots__ = ("pos", "color", "features")

    def __init__(self):
        self.pos = np.full(3, np.nan, np.float64)
        self.color = np.zeros(3, np.uint8)
        self.features: List[FeatureReference] = []

    def is_valid(self) -> bool:
        return not np.isnan(self.pos[0])

    def invalidate(self) -> None:
        self.pos = np.full(3, np.nan, np.float64)

    def remove_view(self, view_id: int) -> None:
        self.features = [f for f in self.features if f.view_id != view_id]


class Viewport:
    """Per-view SfM state (bundler_common.h:37-59)."""

    def __init__(self):
        self.focal_length: float = 0.0
        self.radial_distortion = np.zeros(2, np.float64)
        self.principal_point = np.array([0.5, 0.5], np.float64)
        self.pose = CameraPose()
        self.pose.K = np.zeros((3, 3))  # invalid until reconstructed
        self.width: int = 0
        self.height: int = 0
        # FeatureSet equivalents (struct-of-arrays). Positions hold SIFT
        # features first, then SURF features (feature_set.h layout); the
        # descriptor arrays are per type and matching combines results
        # with index offsets (matching.cc combine_results).
        self.positions = np.zeros((0, 2), np.float32)  # normalized coords
        self.colors = np.zeros((0, 3), np.uint8)
        self.descriptors = np.zeros((0, 128), np.float32)       # SIFT
        self.surf_descriptors = np.zeros((0, 64), np.float32)   # SURF
        self.num_sift = 0
        self.track_ids = np.zeros(0, np.int32)
        # feature id -> track id of resection outliers, restored later
        # (bundler_incremental.cc:160-175, :194-229).
        self.backup_tracks: Dict[int, int] = {}


@dataclasses.dataclass
class TwoViewMatching:
    """Geometrically verified matches of one view pair (bundler_common.h)."""

    view_1_id: int
    view_2_id: int
    matches: np.ndarray  # (M, 2) int32 feature index pairs


def normalize_feature_positions(xy: np.ndarray, width: int, height: int) -> np.ndarray:
    """Image pixel -> normalized coords: centre (0,0), larger dim 1
    (bundler_common.h:156-158, feature_set.h:44-47)."""
    maxdim = float(max(width, height))
    out = np.empty_like(xy, dtype=np.float32)
    out[:, 0] = (xy[:, 0] + 0.5 - width / 2.0) / maxdim
    out[:, 1] = (xy[:, 1] + 0.5 - height / 2.0) / maxdim
    return out


# ---------------------------------------------------------------------------
# feature undistortion (bundler_common.cc:279-325)
# ---------------------------------------------------------------------------

def _distort_squared_radius(r2: float, k1: float, k2: float) -> float:
    return r2 * (1.0 + r2 * (k1 + k2 * r2)) ** 2


def _solve_undistorted_squared_radius(r2: float, k1: float, k2: float) -> float:
    lbound = ubound = r2
    while _distort_squared_radius(lbound, k1, k2) > r2:
        ubound = lbound
        lbound /= 1.05
    while _distort_squared_radius(ubound, k1, k2) < r2:
        lbound = ubound
        ubound *= 1.05
    mid = 0.5 * (lbound + ubound)
    while mid != lbound and mid != ubound:
        if _distort_squared_radius(mid, k1, k2) > r2:
            ubound = mid
        else:
            lbound = mid
        mid = 0.5 * (lbound + ubound)
    return mid


def undistort_feature(f, k1: float, k2: float, focal_length: float) -> np.ndarray:
    """Remove radial distortion from a normalized feature position."""
    f = np.asarray(f, np.float64)
    if k1 == 0.0 and k2 == 0.0:
        return f.astype(np.float32)
    r2 = float(f @ f) / focal_length**2
    scale = 1.0
    if r2 > 0.0:
        scale = np.sqrt(_solve_undistorted_squared_radius(r2, k1, k2) / r2)
    return (f * scale).astype(np.float32)


def undistort_features(positions: np.ndarray, k1: float, k2: float,
                       focal_length: float) -> np.ndarray:
    """Vectorized undistortion via per-point Newton iteration."""
    positions = np.asarray(positions, np.float64)
    if (k1 == 0.0 and k2 == 0.0) or len(positions) == 0:
        return positions.astype(np.float32)
    r2 = np.sum(positions**2, axis=1) / focal_length**2
    # Solve t (1 + t(k1 + k2 t))^2 = r2 for t (undistorted squared radius).
    t = r2.copy()
    for _ in range(30):
        base = 1.0 + t * (k1 + k2 * t)
        ft = t * base**2 - r2
        dft = base**2 + 2.0 * t * base * (k1 + 2.0 * k2 * t)
        dft = np.where(np.abs(dft) < 1e-20, 1e-20, dft)
        t = np.maximum(t - ft / dft, 0.0)
    scale = np.sqrt(np.where(r2 > 0, t / np.maximum(r2, 1e-30), 1.0))
    return (positions * scale[:, None]).astype(np.float32)


# ---------------------------------------------------------------------------
# prebundle serialisation (bundler_common.cc:56-180)
# ---------------------------------------------------------------------------

def save_prebundle(viewports: List[Viewport], matching: List[TwoViewMatching],
                   path: str) -> None:
    with open(path, "wb") as f:
        f.write(PREBUNDLE_SIGNATURE)
        f.write(struct.pack("<i", len(viewports)))
        for vp in viewports:
            pos = np.asarray(vp.positions, "<f4")
            f.write(struct.pack("<i", len(pos)))
            f.write(pos.tobytes())
            colors = np.asarray(vp.colors, np.uint8)
            f.write(struct.pack("<i", len(colors)))
            f.write(colors.tobytes())
        f.write(struct.pack("<i", len(matching)))
        for tvm in matching:
            f.write(struct.pack("<iii", tvm.view_1_id, tvm.view_2_id, len(tvm.matches)))
            f.write(np.asarray(tvm.matches, "<i4").tobytes())


def load_prebundle(path: str):
    """Returns (viewports, matching) with features/colours populated."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(PREBUNDLE_SIGNATURE):
        raise IOError(f"{path}: invalid prebundle file signature")
    off = len(PREBUNDLE_SIGNATURE)

    def read_i32():
        nonlocal off
        (val,) = struct.unpack_from("<i", data, off)
        off += 4
        return val

    viewports = []
    for _ in range(read_i32()):
        vp = Viewport()
        n_pos = read_i32()
        vp.positions = np.frombuffer(data, "<f4", n_pos * 2, off).reshape(n_pos, 2).copy()
        off += n_pos * 8
        n_col = read_i32()
        vp.colors = np.frombuffer(data, np.uint8, n_col * 3, off).reshape(n_col, 3).copy()
        off += n_col * 3
        vp.track_ids = np.full(n_pos, -1, np.int32)
        viewports.append(vp)

    matching = []
    for _ in range(read_i32()):
        v1 = read_i32()
        v2 = read_i32()
        n = read_i32()
        m = np.frombuffer(data, "<i4", n * 2, off).reshape(n, 2).copy()
        off += n * 8
        matching.append(TwoViewMatching(v1, v2, m))
    return viewports, matching


# ---------------------------------------------------------------------------
# survey points (bundler_common.h:148-166)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SurveyObservation:
    view_id: int
    pos: np.ndarray  # (2,)


@dataclasses.dataclass
class SurveyPoint:
    pos: np.ndarray  # (3,)
    observations: List[SurveyObservation] = dataclasses.field(default_factory=list)


def load_survey(path: str) -> List[SurveyPoint]:
    with open(path) as f:
        content = f.read().split()
    if content[0] != "MVE_SURVEY":
        raise IOError(f"{path}: invalid survey file signature")
    n_pts = int(content[1])
    n_obs = int(content[2])
    idx = 3
    points = []
    for _ in range(n_pts):
        points.append(SurveyPoint(np.array([float(x) for x in content[idx : idx + 3]])))
        idx += 3
    for _ in range(n_obs):
        pid = int(content[idx])
        vid = int(content[idx + 1])
        xy = np.array([float(content[idx + 2]), float(content[idx + 3])])
        points[pid].observations.append(SurveyObservation(vid, xy))
        idx += 4
    return points
