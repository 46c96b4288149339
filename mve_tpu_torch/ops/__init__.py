"""Device ops. Each hand-written kernel has a plain PyTorch version beside
it: ops/matching.py holds the plain descriptor top-2, ops/top2.py wraps
the CUDA kernel csrc/top2.cu, and ops/cuda_build.py builds csrc/."""

from .matching import descriptor_top2, descriptor_top2_pairs

__all__ = ["descriptor_top2", "descriptor_top2_pairs"]
