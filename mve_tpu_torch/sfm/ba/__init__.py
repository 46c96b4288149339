"""Bundle adjustment (reference: libs/sfm/bundle_adjustment.*,
ba_linear_solver.*, ba_conjugate_gradient.h; port of mve_tpu.sfm.ba).

The reference's CSC sparse matrices become batched tensors: per
observation residuals and autodiff Jacobian blocks; Hessian blocks B
(9x9 per camera), C (3x3 per point) and the E couplings formed by
deterministic segment sums; the Schur complement solved matrix-free by
preconditioned CG. The LM trust-region rules are the reference's.
"""

from .problem import BAProblem, BACamera, BAPoint, BAObservation, BundleMode
from .lm import BundleAdjustment, BAOptions, BAStatus, optimize_arrays

__all__ = [
    "BAProblem", "BACamera", "BAPoint", "BAObservation", "BundleMode",
    "BundleAdjustment", "BAOptions", "BAStatus", "optimize_arrays",
]
