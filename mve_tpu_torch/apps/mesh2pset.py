"""mesh2pset: mesh -> FSSR-ready point set
(reference: apps/mesh2pset/mesh2pset.cc).

Per vertex: normal from the mesh, scale either constant (-s) or average
distance to adjacent vertices x factor (-a), confidence via boundary
decay (depthmap_mesh_confidences), optional AABB clip; connectivity is
stripped and scale is written to the "value" PLY property. A port of
mve_tpu/apps/mesh2pset.py, host numpy.

    python -m mve_tpu_torch.apps.mesh2pset <mesh.ply> <pset.ply>
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..core import mesh_io
from ..core.depthmap import depthmap_mesh_confidences


def mesh_to_pset(input_path: str, output_path: str | None = None, *,
                 sample_scale: float = 0.0, scale_factor: float = 1.0,
                 aabb=None, no_confidences: bool = False,
                 no_scale: bool = False, no_normals: bool = False):
    mesh = mesh_io.load_mesh(input_path)
    if not no_normals:
        mesh.recalc_normals(face_normals=False, vertex_normals=True)
    if not no_scale:
        if sample_scale > 0.0:
            mesh.vertex_values = np.full(mesh.num_vertices(), sample_scale,
                                         np.float32)
        else:
            # Average distance to adjacent vertices x factor
            # (mesh2pset.cc:160-183; unreferenced vertices get scale 0).
            n = mesh.num_vertices()
            acc = np.zeros(n, np.float64)
            deg = np.zeros(n, np.float64)
            v = mesh.vertices
            f = mesh.faces
            for a, b in ((0, 1), (1, 2), (2, 0)):
                d = np.linalg.norm(v[f[:, a]] - v[f[:, b]], axis=1)
                acc += np.bincount(f[:, a], weights=d, minlength=n)
                acc += np.bincount(f[:, b], weights=d, minlength=n)
                deg += np.bincount(f[:, a], minlength=n)
                deg += np.bincount(f[:, b], minlength=n)
            scale = np.where(deg > 0, acc / np.maximum(deg, 1), 0.0)
            mesh.vertex_values = (scale * scale_factor).astype(np.float32)
    if not no_confidences:
        depthmap_mesh_confidences(mesh, 3)
    if aabb is not None:
        amin, amax = aabb
        inside = np.all((mesh.vertices >= amin) & (mesh.vertices <= amax),
                        axis=1)
        mesh.delete_vertices_fix_faces(~inside)
    mesh.faces = np.zeros((0, 3), np.int32)
    if output_path:
        mesh_io.save_mesh(mesh, output_path, write_normals=not no_normals,
                          write_values=not no_scale,
                          write_confidences=not no_confidences)
    return mesh


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="mesh2pset",
                                description="Mesh -> FSSR point set with normals/scale.")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("-s", "--scale", type=float, default=0.0,
                   help="Set constant scale for all samples [off]")
    p.add_argument("-a", "--adaptive", type=float, default=1.0,
                   help="Average distance to neighbors scale factor [1.0]")
    p.add_argument("-b", "--bounding-box", type=str, default="",
                   help="Six comma separated values used as AABB [off]")
    p.add_argument("-c", "--no-confidences", action="store_true",
                   help="Do not compute vertex confidences")
    p.add_argument("-x", "--no-scale-values", action="store_true",
                   help="Do not compute sample scale")
    p.add_argument("-n", "--no-normals", action="store_true",
                   help="Do not compute sample normals")
    args = p.parse_args(argv)
    aabb = None
    if args.bounding_box:
        vals = [float(x) for x in args.bounding_box.split(",")]
        if len(vals) != 6:
            p.error("--bounding-box needs 6 comma-separated values")
        aabb = (np.asarray(vals[:3], np.float32), np.asarray(vals[3:], np.float32))
    mesh = mesh_to_pset(args.input, args.output,
                        sample_scale=args.scale, scale_factor=args.adaptive,
                        aabb=aabb, no_confidences=args.no_confidences,
                        no_scale=args.no_scale_values,
                        no_normals=args.no_normals)
    print(f"Wrote {mesh.num_vertices()} points.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
