"""Math helpers (reference: libs/math/; port of mve_tpu.math)."""

from .rotation import (rodrigues_to_matrix, matrix_to_rodrigues, quat_to_matrix,
                       matrix_to_quat, skew)

__all__ = ["rodrigues_to_matrix", "matrix_to_rodrigues", "quat_to_matrix",
           "matrix_to_quat", "skew"]
