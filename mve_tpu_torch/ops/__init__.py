"""Device ops. Each hand-written kernel has a plain version beside it:
ops/matching.py holds the plain descriptor top-2, ops/top2.py wraps the
CUDA kernel csrc/top2.cu; ops/pyramid.py wraps csrc/pyramid.cu (MVS level
images), whose plain version is the numpy path of mvs/pyramid.py;
ops/plane_ncc.py wraps csrc/plane_ncc.cu (the slanted-plane NCC), whose
plain version is mvs/patch._plane_tap_sums_plain; and ops/cuda_build.py
builds csrc/."""

from .matching import descriptor_top2, descriptor_top2_pairs

__all__ = ["descriptor_top2", "descriptor_top2_pairs"]
