"""Core data plane: scene/view/camera/bundle/image (reference: libs/mve/).

On-disk contracts match the reference and mve_tpu, so all three read the
same scene directories: `views/view_NNNN.mve/` dirs with `meta.ini` +
embeddings, MVEI images, `synth_0.out` bundles (reference:
libs/mve/view.h:9-37, scene.h:34-100, bundle_io.cc).
"""

from .camera import CameraInfo
from .mesh import TriangleMesh
from .view import View
from .scene import Scene
from .bundle import Bundle, Feature2D, Feature3D

__all__ = ["CameraInfo", "TriangleMesh", "View", "Scene", "Bundle", "Feature2D", "Feature3D"]
