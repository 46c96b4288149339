"""Multi-view stereo: per-view depth maps (reference: libs/dmrecon/).

The reference implements Goesele-style NCC region growing: a sequential
confidence-ordered priority queue, one pixel at a time
(dmrecon.cc:334-434). This package, like mve_tpu's, recasts it as
per-pixel computation over every pixel at once with the same outputs
(depth-L<s>, conf-L<s>, dz-L<s>, undist-L<s> embeddings, ray-length depth
convention) and the same matching core (5x5 NCC patches against the
best-scoring neighbor views):

1. seed a dense depth map from the sparse SfM features,
2. plane-sweep candidate depths per pixel, scored through per-pair
   rectified NCC tables (sweep_solver.py) or per-candidate warps
   (solver.py); both solvers run the rounds of rounds.py,
3. iterate batched PatchMatch-style propagation (shifted-neighbor
   candidates) + parabolic sub-candidate refinement,
4. confidence from final NCC with the reference's minNCC/acceptNCC
   semantics.

Every step is a PyTorch program over all pixels on the device; views are
the embarrassingly-parallel axis.
"""

from .settings import Settings
from .dmrecon import DMRecon

__all__ = ["Settings", "DMRecon"]
