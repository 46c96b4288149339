"""Per-view intrinsics initialization (reference:
libs/sfm/bundler_intrinsics.cc:17).

Either parse the view's "exif" blob into a focal prior (FROM_EXIF) or take
the values from the view's meta.ini camera (FROM_VIEWS).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List

from ...core.image_exif import exif_extract
from ..extract_focal_length import extract_focal_length
from .common import Viewport


class IntrinsicsSource(enum.Enum):
    FROM_EXIF = 0
    FROM_VIEWS = 1


@dataclasses.dataclass
class IntrinsicsOptions:
    intrinsics_source: IntrinsicsSource = IntrinsicsSource.FROM_EXIF
    exif_embedding: str = "exif"  # sfmrecon.cc -e/--exif blob name
    verbose: bool = False


class Intrinsics:
    def __init__(self, options: IntrinsicsOptions | None = None):
        self.opts = options or IntrinsicsOptions()

    def compute(self, scene, viewports: List[Viewport]) -> None:
        """scene: core.Scene; viewports indexed like scene views."""
        views = scene.get_views()
        for i, vp in enumerate(viewports):
            view = views[i] if i < len(views) else None
            if view is None:
                continue
            if self.opts.intrinsics_source == IntrinsicsSource.FROM_VIEWS:
                cam = view.camera
                vp.focal_length = float(cam.flen)
                vp.radial_distortion[:] = cam.dist
                vp.principal_point[:] = cam.ppoint
            else:
                exif_blob = view.get_blob(self.opts.exif_embedding)
                exif = exif_extract(exif_blob) if exif_blob else None
                flen, method = extract_focal_length(exif)
                vp.focal_length = float(flen)
                vp.radial_distortion[:] = 0.0
                if self.opts.verbose:
                    print(f"View {i}: focal {flen:.3f} ({method.name})")
