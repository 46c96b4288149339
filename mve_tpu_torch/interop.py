"""Hand the per-view state, the tracks and the options of another package
to this one, as plain data.

MVE has no learned weights: what two implementations must share to be
compared is each view's features and SfM state, the tracks, the scene on
disk and the options. The fields here are those of mve_tpu's Viewport, Track and
option dataclasses, passed as numpy arrays and plain values, so the two
packages meet only in the tests.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from .mvs.settings import Settings
from .sfm.ba import BAOptions
from .sfm.bundler.common import FeatureReference, Track, Viewport
from .sfm.bundler.incremental import IncrementalOptions
from .sfm.bundler.init_pair import InitialPairOptions
from .sfm.bundler.matching import MatchingOptions
from .sfm.bundler.pipeline import SfmOptions
from .sfm.pose import CameraPose
from .sfm.ransac import RansacOptions
from .sfm.sift import SiftOptions
from .sfm.surf import SurfOptions

VIEWPORT_FIELDS = ("positions", "colors", "descriptors", "surf_descriptors",
                   "num_sift", "width", "height")
# Optional SfM state of a viewport: focal_length, radial_distortion,
# pose (K, R, t), track_ids and backup_tracks.
VIEWPORT_SFM_FIELDS = ("focal_length", "radial_distortion", "K", "R", "t",
                       "track_ids", "backup_tracks")


def viewports_from_numpy(views: List[Dict]) -> List[Viewport]:
    """Viewports from dicts holding VIEWPORT_FIELDS (arrays as numpy) and
    any of VIEWPORT_SFM_FIELDS; missing feature arrays are empty."""
    out = []
    for v in views:
        vp = Viewport()
        vp.positions = np.asarray(v.get("positions", vp.positions), np.float32).reshape(-1, 2)
        vp.colors = np.asarray(v.get("colors", vp.colors), np.uint8).reshape(-1, 3)
        vp.descriptors = np.asarray(v.get("descriptors", vp.descriptors),
                                    np.float32).reshape(-1, 128)
        vp.surf_descriptors = np.asarray(v.get("surf_descriptors", vp.surf_descriptors),
                                         np.float32).reshape(-1, 64)
        vp.num_sift = int(v.get("num_sift", 0))
        vp.width = int(v.get("width", 0))
        vp.height = int(v.get("height", 0))
        vp.track_ids = np.asarray(v.get("track_ids", np.full(len(vp.positions), -1)),
                                  np.int32).copy()
        vp.focal_length = float(v.get("focal_length", 0.0))
        vp.radial_distortion = np.asarray(v.get("radial_distortion", np.zeros(2)),
                                          np.float64).copy()
        if "K" in v:
            vp.pose = CameraPose(K=np.asarray(v["K"], np.float64).copy(),
                                 R=np.asarray(v["R"], np.float64).copy(),
                                 t=np.asarray(v["t"], np.float64).copy())
        vp.backup_tracks = {int(f): int(t) for f, t in dict(v.get("backup_tracks", {})).items()}
        out.append(vp)
    return out


def tracks_from_numpy(positions, colors, references) -> List[Track]:
    """Tracks from (T, 3) positions (NaN = not triangulated), (T, 3) uint8
    colours and, per track, a sequence of (view_id, feature_id)."""
    out = []
    for pos, col, refs in zip(np.asarray(positions, np.float64),
                              np.asarray(colors, np.uint8), references):
        t = Track()
        t.pos = pos.copy()
        t.color = col.copy()
        t.features = [FeatureReference(int(v), int(f)) for v, f in refs]
        out.append(t)
    return out


def _build(cls, values: Dict):
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(values) - names
    if unknown:
        raise ValueError(f"{cls.__name__}: unknown fields {sorted(unknown)}")
    return cls(**values)


def _with_ransac(values: Dict, key: str) -> Dict:
    values = dict(values)
    if isinstance(values.get(key), dict):
        values[key] = _build(RansacOptions, values[key])
    return values


def options_from_dict(d: Dict):
    """All option objects of the SfM path from one dict of dicts of field
    values, under the optional keys "sift", "surf", "matching", "sfm",
    "incremental", "init_pair" and "ba". Returns (SiftOptions,
    SurfOptions, MatchingOptions, SfmOptions, IncrementalOptions,
    InitialPairOptions, BAOptions); the SfmOptions holds the
    IncrementalOptions and InitialPairOptions returned beside it. RANSAC
    options (matching's "ransac_opts", incremental's "pose_p3p_opts",
    init_pair's "homography_opts") may be dicts."""
    inc = _build(IncrementalOptions, _with_ransac(d.get("incremental", {}), "pose_p3p_opts"))
    init = _build(InitialPairOptions, _with_ransac(d.get("init_pair", {}), "homography_opts"))
    sfm = dict(d.get("sfm", {}))
    if "initial_pair" in sfm:
        sfm["initial_pair"] = tuple(sfm["initial_pair"])
    return (_build(SiftOptions, d.get("sift", {})),
            _build(SurfOptions, d.get("surf", {})),
            _build(MatchingOptions, _with_ransac(d.get("matching", {}), "ransac_opts")),
            _build(SfmOptions, dict(sfm, incremental_opts=inc, init_pair_opts=init)),
            inc, init, _build(BAOptions, d.get("ba", {})))


def mvs_settings_from_dict(values: Dict) -> Settings:
    """The port's mvs.Settings from a dict of field values (mve_tpu's
    Settings fields, e.g. dataclasses.asdict of one); unknown fields are
    refused, as options_from_dict refuses them."""
    return _build(Settings, dict(values))
