"""bundle2pset: bundle file -> PLY point cloud
(reference: apps/bundle2pset/bundle2pset.cc; port of
mve_tpu/apps/bundle2pset.py, host numpy).

    python -m mve_tpu_torch.apps.bundle2pset <scene or synth_0.out> <pset.ply>
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from ..core import bundle_io, mesh_io
from ..core.mesh import TriangleMesh


def bundle_to_pointset(bundle_path: str, output_path: str | None = None,
                       sphere_radius: float = 0.0):
    if os.path.isdir(bundle_path):
        bundle_path = os.path.join(bundle_path, "synth_0.out")
    bundle = bundle_io.load_mve_bundle(bundle_path)
    mesh = TriangleMesh()
    mesh.vertices = bundle.feature_positions()
    colors = bundle.feature_colors()
    mesh.vertex_colors = np.concatenate(
        [colors, np.ones((len(colors), 1), np.float32)], axis=1)
    if sphere_radius > 0.0:
        mesh = _spheres_mesh(mesh, sphere_radius)
    if output_path:
        mesh_io.save_mesh(mesh, output_path)
    return mesh


def _spheres_mesh(pset: TriangleMesh, radius: float) -> TriangleMesh:
    """One octahedron-subdivision sphere per point, carrying its color
    (bundle2pset.cc generate_spheres)."""
    # Icosahedron template.
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]], np.float32)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]], np.int32)
    n = pset.num_vertices()
    V = len(verts)
    out = TriangleMesh()
    out.vertices = (pset.vertices[:, None, :]
                    + radius * verts[None, :, :]).reshape(-1, 3)
    out.faces = (faces[None, :, :]
                 + (np.arange(n, dtype=np.int64) * V)[:, None, None]
                 ).reshape(-1, 3).astype(np.int32)
    if pset.has_vertex_colors():
        out.vertex_colors = np.repeat(pset.vertex_colors, V, axis=0)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="bundle2pset",
                                description="Bundle -> PLY point cloud.")
    p.add_argument("bundle", help="Bundle file or scene directory")
    p.add_argument("output", help="Output PLY")
    p.add_argument("-s", "--spheres", type=float, default=0.0,
                   help="Generates a sphere for every point (radius ARG) [0.0]")
    args = p.parse_args(argv)
    mesh = bundle_to_pointset(args.bundle, args.output,
                              sphere_radius=args.spheres)
    print(f"Wrote {mesh.num_vertices()} points.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
