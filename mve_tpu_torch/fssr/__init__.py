"""Floating-Scale Surface Reconstruction (reference: libs/fssr/; port of
mve_tpu/fssr/).

Fuhrmann & Goesele FSSR: each point sample {pos, normal, scale,
confidence, color} contributes a scale-adaptive signed basis function
(Gaussian derivative along the normal) and a compactly-supported weight;
the implicit function is their confidence-weighted quotient, and the
surface is the zero level set.

Split as in mve_tpu: the sample octree, the block partition and the
surface extraction (dual contouring, or marching tetrahedra on a uniform
grid) are host numpy; the implicit function is evaluated on the device
in plain PyTorch (block_eval.py).
"""

from .sample import Sample, SampleList, samples_from_mesh, load_samples_from_ply
from .iso_octree import IsoOctree
from .iso_surface import IsoSurface
from .mesh_clean import clean_mc_mesh, clean_needles, clean_caps

__all__ = [
    "Sample", "SampleList", "samples_from_mesh", "load_samples_from_ply",
    "IsoOctree", "IsoSurface",
    "clean_mc_mesh", "clean_needles", "clean_caps",
]
