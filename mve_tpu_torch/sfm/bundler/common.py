"""Bundler data structures + prebundle serialisation
(reference: libs/sfm/bundler_common.h/.cc).

The prebundle.sfm binary format is byte-compatible with the reference
and mve_tpu (bundler_common.cc:56-113): "MVE_PREBUNDLE\\n" signature,
int32 counts, float32 positions, uint8 colours, int32 match index pairs
— all little-endian.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import List

import numpy as np

from ..pose import CameraPose

PREBUNDLE_SIGNATURE = b"MVE_PREBUNDLE\n"


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
