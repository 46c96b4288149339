"""Math helpers (reference: libs/math/; port of mve_tpu.math)."""

from . import rotation
from . import geometry
from . import intersect
from .rotation import (rodrigues_to_matrix, matrix_to_rodrigues, quat_to_matrix,
                       matrix_to_quat, skew)

__all__ = ["rotation", "geometry", "intersect", "rodrigues_to_matrix", "matrix_to_rodrigues",
           "quat_to_matrix", "matrix_to_quat", "skew"]
