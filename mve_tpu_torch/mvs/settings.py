"""MVS settings (reference: libs/dmrecon/settings.h:22-52 defaults)."""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Settings:
    ref_view_nr: int = 0
    image_embedding: str = "undistorted"
    filter_width: int = 5          # NCC patch is filter_width^2
    min_ncc: float = 0.3
    min_parallax: float = 10.0     # degrees, global view selection
    accept_ncc: float = 0.6
    # min_refine_diff / max_iterations bound the joint depth+normal
    # rounds (patch_optimization.cc:184-218 convergence + budget).
    min_refine_diff: float = 0.001
    max_iterations: int = 20
    nr_recon_neighbors: int = 4
    global_vs_max: int = 20
    scale: int = 0                 # pyramid level
    # NOTE: the reference's useColorScale knob (settings.h:40) has no
    # equivalent here by design — its per-view multiplicative color scale
    # compensates exposure differences inside an SSD-style objective,
    # while this implementation scores pure NCC, which is invariant to
    # affine intensity changes (a strictly stronger correction that
    # cannot be disabled).
    write_ply_file: bool = False
    ply_path: str = ""             # destination dir for write_ply_file
    aabb_min: np.ndarray = dataclasses.field(
        default_factory=lambda: np.full(3, -np.finfo(np.float32).max))
    aabb_max: np.ndarray = dataclasses.field(
        default_factory=lambda: np.full(3, np.finfo(np.float32).max))
    keep_dz_map: bool = True
    keep_conf_map: bool = True
    quiet: bool = False
    # Knobs of the batched sweep that replaces sequential region growing
    # (no reference equivalent):
    num_sweep_planes: int = 48     # initial depth candidates per pixel
    num_propagation_iters: int = 8
    num_refine_steps: int = 3
    exact_ncc: bool = False        # True = per-tap warped patches (slower)
    local_vs: bool = True          # per-pixel diverse view selection
                                   # (local_view_selection.cc performVS);
                                   # False = plain per-pixel top-k NCC
    # Rectified plane-sweep scoring (mvs/sweep_solver.py): candidate
    # NCCs come from per-pair precomputed plane tables (a 2-tap lookup
    # along the plane axis) instead of per-candidate warps. Views whose neighbor
    # pairs cannot be rectified (baseline ~ viewing direction) fall back
    # to the warp solver automatically. False forces the warp solver.
    use_sweep: bool = True
    num_lookup_planes: int = 64    # D: planes per pair table
