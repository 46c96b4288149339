"""Hand the per-view feature state and the options of another package to
this one, as plain data.

MVE has no learned weights: what two implementations must share to be
compared is each view's features and the options. The fields here are
those of mve_tpu's Viewport and option dataclasses, passed as numpy
arrays and plain values, so the two packages meet only in the tests.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from .sfm.bundler.common import Viewport
from .sfm.bundler.matching import MatchingOptions
from .sfm.ransac import RansacOptions
from .sfm.sift import SiftOptions
from .sfm.surf import SurfOptions

VIEWPORT_FIELDS = ("positions", "colors", "descriptors", "surf_descriptors",
                   "num_sift", "width", "height")


def viewports_from_numpy(views: List[Dict]) -> List[Viewport]:
    """Viewports from dicts holding VIEWPORT_FIELDS (arrays as numpy)."""
    out = []
    for v in views:
        vp = Viewport()
        vp.positions = np.asarray(v["positions"], np.float32).reshape(-1, 2)
        vp.colors = np.asarray(v["colors"], np.uint8).reshape(-1, 3)
        vp.descriptors = np.asarray(v["descriptors"], np.float32).reshape(-1, 128)
        vp.surf_descriptors = np.asarray(v["surf_descriptors"], np.float32).reshape(-1, 64)
        vp.num_sift = int(v["num_sift"])
        vp.width = int(v["width"])
        vp.height = int(v["height"])
        vp.track_ids = np.full(len(vp.positions), -1, np.int32)
        out.append(vp)
    return out


def _build(cls, values: Dict):
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(values) - names
    if unknown:
        raise ValueError(f"{cls.__name__}: unknown fields {sorted(unknown)}")
    return cls(**values)


def options_from_dict(d: Dict):
    """(SiftOptions, SurfOptions, MatchingOptions) from a dict with the
    optional keys "sift", "surf" and "matching", each a dict of field
    values; matching's "ransac_opts" may itself be a dict."""
    matching = dict(d.get("matching", {}))
    if isinstance(matching.get("ransac_opts"), dict):
        matching["ransac_opts"] = _build(RansacOptions, matching["ransac_opts"])
    return (_build(SiftOptions, d.get("sift", {})),
            _build(SurfOptions, d.get("surf", {})),
            _build(MatchingOptions, matching))
