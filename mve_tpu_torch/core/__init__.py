"""Core data plane: scene/view/camera/image (reference: libs/mve/).

On-disk contracts match the reference and mve_tpu, so all three read the
same scene directories: `views/view_NNNN.mve/` dirs with `meta.ini` +
embeddings, MVEI images (reference: libs/mve/view.h:9-37, scene.h:34-100).
"""

from .camera import CameraInfo
from .view import View
from .scene import Scene

__all__ = ["CameraInfo", "View", "Scene"]
