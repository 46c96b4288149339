"""meshalign: merge range-scan alignments into one mesh
(reference: apps/meshalign/meshalign.cc, stanford_alignment.h,
meshlab_alignment.h).

Supports Stanford .conf alignment files:
    camera T1 T2 T3 Q1 Q2 Q3 Q4
    bmesh FILE_NAME T1 T2 T3 Q1 Q2 Q3 Q4
Each bmesh entry is a scan transformed by translation T and quaternion Q
(x, y, z, w order as in the Stanford repositories).

Supports Meshlab .aln alignment files (meshlab_alignment.h:18-31):
    NUM_MESHES
    MESH_FILE_NAME
    R1 R2 R3 T1
    R4 R5 R6 T2
    R7 R8 R9 T3
    0  0  0  1
with '#' comments and blank lines ignored. Each vertex maps to R*v + T.

Plain mesh arguments are merged untransformed. A port of
mve_tpu/apps/meshalign.py, host numpy.

    python -m mve_tpu_torch.apps.meshalign <align.conf|.aln|mesh>... <out.ply>
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from ..core import mesh_io
from ..core.mesh_tools import mesh_merge, mesh_transform
from ..math.rotation import quat_to_matrix


def read_stanford_alignment(conf_path: str):
    """Returns a list of (mesh_path, 4x4 transform)."""
    base = os.path.dirname(conf_path)
    entries = []
    with open(conf_path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "bmesh":
                name = parts[1]
                t = np.array([float(x) for x in parts[2:5]])
                qx, qy, qz, qw = (float(x) for x in parts[5:9])
                R = np.asarray(quat_to_matrix(np.array([qw, qx, qy, qz])), np.float64)
                M = np.eye(4)
                M[:3, :3] = R
                M[:3, 3] = t
                entries.append((os.path.join(base, name), M))
    return entries


def read_meshlab_alignment(aln_path: str):
    """Returns a list of (mesh_path, 4x4 transform) from a Meshlab .aln file
    (reference: apps/meshalign/meshlab_alignment.cc:43-97)."""
    base = os.path.dirname(aln_path)
    with open(aln_path) as f:
        lines = [ln.strip() for ln in f]
    lines = [ln for ln in lines if ln and not ln.startswith("#")]
    if not lines:
        raise IOError(f"{aln_path}: empty alignment file")
    num = int(lines[0].split()[0])
    entries = []
    pos = 1
    for _ in range(num):
        if pos + 4 > len(lines):
            raise IOError(f"{aln_path}: truncated alignment file")
        name = lines[pos]
        M = np.eye(4)
        for r in range(3):
            vals = [float(x) for x in lines[pos + 1 + r].split()[:4]]
            M[r, :] = vals
        # 4th matrix row ("0 0 0 1") is present but ignored, as in the
        # reference reader.
        pos += 5
        entries.append((os.path.join(base, name), M))
    return entries


def mesh_align(inputs, output_path: str | None = None, verbose: bool = True):
    meshes = []
    for path in inputs:
        if path.endswith(".aln"):
            for mesh_path, M in read_meshlab_alignment(path):
                if not os.path.isfile(mesh_path):
                    if verbose:
                        print(f"Missing scan {mesh_path}, skipping.")
                    continue
                mesh = mesh_io.load_mesh(mesh_path)
                mesh_transform(mesh, M)
                meshes.append(mesh)
                if verbose:
                    print(f"{mesh_path}: {mesh.num_vertices()} vertices.")
        elif path.endswith(".conf"):
            for mesh_path, M in read_stanford_alignment(path):
                if not os.path.isfile(mesh_path):
                    # Stanford archives often gzip scans; try .ply fallback.
                    alt = os.path.splitext(mesh_path)[0] + ".ply"
                    if os.path.isfile(alt):
                        mesh_path = alt
                    else:
                        if verbose:
                            print(f"Missing scan {mesh_path}, skipping.")
                        continue
                mesh = mesh_io.load_mesh(mesh_path)
                mesh_transform(mesh, M)
                meshes.append(mesh)
                if verbose:
                    print(f"{mesh_path}: {mesh.num_vertices()} vertices.")
        else:
            meshes.append(mesh_io.load_mesh(path))
    merged = mesh_merge(meshes)
    if output_path:
        mesh_io.save_mesh(merged, output_path)
        if verbose:
            print(f"Wrote {merged.num_vertices()} vertices to {output_path}.")
    return merged


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="meshalign",
                                description="Merge aligned range scans into one mesh.")
    p.add_argument("inputs", nargs="+", help="Meshes and/or .conf alignments")
    p.add_argument("output", help="Output mesh")
    args = p.parse_args(argv)
    mesh_align(args.inputs, args.output)
    return 0


if __name__ == "__main__":
    sys.exit(main())
