"""MVE bundle file I/O (reference: libs/mve/bundle_io.cc; a copy of the
MVE-native part of mve_tpu/core/bundle_io.py).

``synth_0.out`` is the Photosynther text format with the "drews 1.0"
header (bundle_io.cc:218-280 format doc, :430-500 writer). The files this
module writes are byte-identical to mve_tpu's. The Bundler, NVM and
COLMAP readers are not ported yet (ROADMAP.md queue A item 15).
"""

from __future__ import annotations

import numpy as np

from .bundle import Bundle, Feature2D, Feature3D
from .camera import CameraInfo


def load_mve_bundle(path: str) -> Bundle:
    with open(path, "r") as f:
        tokens = f.read().split()
    it = iter(tokens)

    def nxt():
        return next(it)

    magic = nxt() + " " + nxt()
    if magic != "drews 1.0":
        raise IOError(f"{path}: invalid Photosynther signature {magic!r}")

    num_cameras = int(nxt())
    num_features = int(nxt())
    bundle = Bundle()
    for _ in range(num_cameras):
        vals = np.array([float(nxt()) for _ in range(15)], np.float64)
        cam = CameraInfo()
        cam.flen = float(vals[0])
        cam.dist = vals[1:3].astype(np.float32)
        cam.rot = vals[3:12].reshape(3, 3).astype(np.float32)
        cam.trans = vals[12:15].astype(np.float32)
        bundle.cameras.append(cam)

    for _ in range(num_features):
        pos = np.array([float(nxt()) for _ in range(3)], np.float32)
        color = np.array([float(nxt()) for _ in range(3)], np.float32) / 255.0
        nrefs = int(nxt())
        refs = []
        for _ in range(nrefs):
            view_id = int(nxt())
            feat_id = int(nxt())
            nxt()  # reprojection quality, discarded (bundle_io.cc:375)
            refs.append(Feature2D(view_id, feat_id))
        bundle.features.append(Feature3D(pos, color, refs))
    return bundle


def save_mve_bundle(bundle: Bundle, path: str) -> None:
    """Write the MVE native bundle (bundle_io.cc save_photosynther_bundle)."""
    lines = ["drews 1.0", f"{len(bundle.cameras)} {len(bundle.features)}"]
    for cam in bundle.cameras:
        valid = (
            cam.flen != 0.0
            and np.all(np.isfinite(cam.trans))
            and np.all(np.isfinite(cam.rot))
        )
        if not valid:
            lines.extend(["0 0 0"] * 5)
            continue
        r = cam.rot.reshape(-1)
        lines.append(f"{_fmt(cam.flen)} {_fmt(cam.dist[0])} {_fmt(cam.dist[1])}")
        lines.append(f"{_fmt(r[0])} {_fmt(r[1])} {_fmt(r[2])}")
        lines.append(f"{_fmt(r[3])} {_fmt(r[4])} {_fmt(r[5])}")
        lines.append(f"{_fmt(r[6])} {_fmt(r[7])} {_fmt(r[8])}")
        lines.append(f"{_fmt(cam.trans[0])} {_fmt(cam.trans[1])} {_fmt(cam.trans[2])}")
    for feat in bundle.features:
        lines.append(f"{_fmt(feat.pos[0])} {_fmt(feat.pos[1])} {_fmt(feat.pos[2])}")
        c = [int(x * 255.0 + 0.5) for x in feat.color]
        lines.append(f"{c[0]} {c[1]} {c[2]}")
        ref_str = " ".join(f"{r.view_id} {r.feature_id} 0" for r in feat.refs)
        lines.append(f"{len(feat.refs)}" + (" " + ref_str if ref_str else ""))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def _fmt(x: float) -> str:
    """Compact float formatting comparable to C++ operator<< defaults."""
    return f"{float(x):.9g}"
