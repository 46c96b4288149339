"""meshconvert: mesh format conversion (reference: apps/meshconvert/; port
of mve_tpu/apps/meshconvert.py, host numpy).

    python -m mve_tpu_torch.apps.meshconvert <in.ply> <out.off>
"""

from __future__ import annotations

import argparse
import sys

from ..core import mesh_io


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="meshconvert",
                                description="Convert between mesh formats (by extension).")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("-a", "--ascii", action="store_true", help="Write ASCII PLY")
    p.add_argument("-n", "--normals", action="store_true",
                   help="Compute vertex normals (meshconvert.cc -n)")
    args = p.parse_args(argv)
    mesh = mesh_io.load_mesh(args.input)
    kw = {}
    if args.normals:
        mesh.recalc_normals(face_normals=False, vertex_normals=True)
        kw["write_normals"] = True
    if args.output.lower().endswith(".ply") and args.ascii:
        kw["fmt"] = "ascii"
    mesh_io.save_mesh(mesh, args.output, **kw)
    print(f"Converted {mesh.num_vertices()} vertices, {mesh.num_faces()} faces.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
