"""meshclean: confidence/degenerate/component cleanup
(reference: apps/meshclean/meshclean.cc:28-103; port of
mve_tpu/apps/meshclean.py).

    python -m mve_tpu_torch.apps.meshclean <surf.ply> <clean.ply>

All of it is host numpy in both packages, so it takes no device= and
no --device.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..core import mesh_io
from ..core.mesh_tools import mesh_delete_small_components
from ..fssr.mesh_clean import clean_mc_mesh


def mesh_clean(input_path: str, output_path: str | None = None, *,
               threshold: float = 1.0, conf_percentile: float = -1.0,
               component_size: int = 1000,
               clean_degenerated: bool = True, delete_scale: bool = False,
               delete_conf: bool = False, delete_colors: bool = False,
               verbose: bool = True):
    mesh = mesh_io.load_mesh(input_path)
    if verbose:
        print(f"Loaded mesh: {mesh.num_vertices()} vertices, {mesh.num_faces()} faces.")

    # Confidence threshold from a percentile of the distribution
    # (meshclean.cc:36-44 nth_element percentile).
    if conf_percentile >= 0 and mesh.has_vertex_confidences():
        conf = mesh.vertex_confidences
        n = int(conf_percentile / 100.0 * len(conf))
        threshold = float(np.partition(conf, min(n, len(conf) - 1))[
            min(n, len(conf) - 1)])
        if verbose:
            print(f"Confidence percentile {conf_percentile} -> "
                  f"threshold {threshold:.4f}.")

    # Confidence-threshold vertex deletion (meshclean.cc).
    if mesh.has_vertex_confidences() and threshold > 0:
        delete = mesh.vertex_confidences < threshold
        n = int(delete.sum())
        mesh.delete_vertices_fix_faces(delete)
        if verbose:
            print(f"Deleted {n} low-confidence vertices.")

    if clean_degenerated:
        n = clean_mc_mesh(mesh)
        if verbose:
            print(f"Removed {n} degenerated faces/vertices.")

    if component_size > 0:
        n = mesh_delete_small_components(mesh, component_size)
        if verbose:
            print(f"Deleted {n} vertices in small components.")

    if delete_scale:
        mesh.vertex_values = np.zeros(0, np.float32)
    if delete_conf:
        mesh.vertex_confidences = np.zeros(0, np.float32)
    if delete_colors:
        mesh.vertex_colors = np.zeros((0, 4), np.float32)

    if output_path:
        mesh_io.save_mesh(mesh, output_path)
        if verbose:
            print(f"Wrote {mesh.num_vertices()} vertices, "
                  f"{mesh.num_faces()} faces to {output_path}.")
    return mesh


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="meshclean", description="Mesh cleanup.")
    p.add_argument("input", help="Input PLY mesh")
    p.add_argument("output", help="Output PLY mesh")
    p.add_argument("-t", "--threshold", type=float, default=1.0,
                   help="Threshold on the geometry confidence [1.0]")
    p.add_argument("-p", "--percentile", type=float, default=-1.0,
                   help="Use percentile (0-100) of confidence distribution "
                        "as threshold [off]")
    p.add_argument("-c", "--component-size", type=int, default=1000,
                   help="Minimum number of vertices per component [1000]")
    p.add_argument("-n", "--no-clean", action="store_true",
                   help="Prevent cleanup of degenerated faces")
    p.add_argument("--delete-scale", action="store_true")
    p.add_argument("--delete-conf", action="store_true")
    p.add_argument("--delete-color", action="store_true")
    args = p.parse_args(argv)
    mesh_clean(args.input, args.output, threshold=args.threshold,
               conf_percentile=args.percentile,
               component_size=args.component_size,
               clean_degenerated=not args.no_clean,
               delete_scale=args.delete_scale, delete_conf=args.delete_conf,
               delete_colors=args.delete_color)
    return 0


if __name__ == "__main__":
    sys.exit(main())
