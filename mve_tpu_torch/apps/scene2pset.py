"""scene2pset: fuse depth maps into a point set
(reference: apps/scene2pset/scene2pset.cc; port of
mve_tpu/apps/scene2pset.py).

Per view: triangulate the depth map into a world-space mesh (dd_factor
discontinuity test), compute per-vertex normals, confidence (boundary
ramp), and scale (mean adjacent-edge length x factor), then merge. -F<s>
sets FSSR mode: depth-L<s>, undist-L<s>, normals+scale+confidence on.

    python -m mve_tpu_torch.apps.scene2pset -F2 <scene> <pset.ply>

All of it is host numpy, as in mve_tpu; device= (--device) is resolved
like every entry point's, so it raises without CUDA unless the caller
asks for the CPU, and no device work is done. --process-id and --num-processes
split the views modulo the process count; as in mve_tpu, their defaults
come from JAX_PROCESS_ID and JAX_NUM_PROCESSES (0 and 1 when unset).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from .. import resolve_device
from ..core import Scene
from ..core import depthmap as dmod
from ..core import mesh_io
from ..core.mesh import TriangleMesh
from ..core.mesh_tools import mesh_merge, mesh_transform
from ..parallel.multihost import my_shard, num_processes_from_env, process_id_from_env


def scene_to_pointset(scene_path: str, output_path: str | None = None, *,
                      dmname: str = "depth-L0", image: str = "undistorted",
                      with_normals: bool = False, with_scale: bool = False,
                      with_conf: bool = False, poisson_normals: bool = False,
                      scale_factor: float = 2.5, dd_factor: float = 5.0,
                      min_valid_fraction: float = 0.0, view_ids=None,
                      aabb=None, mask_name: str = "",
                      with_correspondence: bool = False,
                      process_id: int = 0, num_processes: int = 1,
                      verbose: bool = True, device="cuda") -> TriangleMesh:
    """With num_processes > 1 the views partition across processes (the
    distributed analog of the reference's OpenMP view loop,
    scene2pset.cc:264); each process writes its own output PLY and
    fssrecon consumes all of them as multiple inputs."""
    resolve_device(device)
    scene = Scene(scene_path)
    meshes = []
    corr_rows = []       # (x, y) per merged vertex, in merge order
    corr_meta = []       # (view_id, width, height, first_vertex_index)
    candidates = [i for i, v in enumerate(scene.get_views()) if v is not None]
    if num_processes > 1:
        mine = set(my_shard(candidates, process_id, num_processes))
    else:
        mine = None
    for i, view in enumerate(scene.get_views()):
        if view is None or not view.camera.valid:
            continue
        if view_ids is not None and i not in view_ids:
            continue
        if mine is not None and i not in mine:
            continue
        dm = view.get_float_image(dmname)
        if dm is None:
            continue
        dm = np.squeeze(dm)
        if min_valid_fraction > 0:
            frac = float((dm > 0).mean())
            if frac < min_valid_fraction:
                if verbose:
                    print(f"View {i}: fill {100 * frac:.2f}%, skipping.")
                continue
        if mask_name:
            # Clip 3D points against a mask/silhouette image
            # (scene2pset.cc:172,212-230): depth where mask == 0 drops.
            mask = view.get_byte_image(mask_name)
            if mask is not None:
                mask = np.squeeze(mask[..., 0] if mask.ndim == 3 else mask)
                if mask.shape == dm.shape:
                    dm = np.where(mask > 0, dm, 0.0)
                elif verbose:
                    print(f"View {i}: mask size mismatch, ignoring.")
        ci = view.get_byte_image(image) if image else None
        if ci is not None and ci.shape[:2] != dm.shape:
            ci = None

        h, w = dm.shape
        invproj = view.camera.inverse_calibration(w, h)
        mesh, vid_img = dmod.depthmap_triangulate(dm, invproj, dd_factor,
                                                  color_image=ci)
        # Transform to world coords (depthmap.cc:377-399).
        mesh_transform(mesh, view.camera.cam_to_world())
        if with_normals or poisson_normals:
            mesh.recalc_normals(face_normals=False, vertex_normals=True)
        if with_conf:
            dmod.depthmap_mesh_confidences(mesh, 4)
        if poisson_normals and mesh.has_vertex_confidences():
            mesh.vertex_normals = mesh.vertex_normals * mesh.vertex_confidences[:, None]
        if with_scale:
            # Mean distance to adjacent vertices x factor
            # (scene2pset.cc:345-358). Vectorized over edges: sum
            # |v_i - v_j| into both endpoints (bincount is the fast
            # scatter-add; np.add.at is an order of magnitude slower).
            n = mesh.num_vertices()
            v = mesh.vertices
            f = mesh.faces
            deg = np.zeros(n, np.float64)
            acc = np.zeros(n, np.float64)
            for a, b in ((0, 1), (1, 2), (2, 0)):
                d = np.linalg.norm(v[f[:, a]] - v[f[:, b]], axis=1)
                acc += np.bincount(f[:, a], weights=d, minlength=n)
                acc += np.bincount(f[:, b], weights=d, minlength=n)
                deg += np.bincount(f[:, a], minlength=n)
                deg += np.bincount(f[:, b], minlength=n)
            scale = (acc / np.maximum(deg, 1)) * scale_factor
            mesh.vertex_values = scale.astype(np.float32)
        if aabb is not None:
            amin, amax = aabb
            inside = np.all((mesh.vertices >= amin) & (mesh.vertices <= amax), axis=1)
            mesh.delete_vertices_fix_faces(~inside)
        if with_correspondence and aabb is None and not mask_name:
            # Per-vertex source pixel (scene2pset.cc:65-83): valid only
            # while vertex ids are stable, i.e. without mask/AABB clips.
            vid = np.asarray(vid_img)
            ys, xs = np.nonzero(vid >= 0)
            order = vid[ys, xs]
            px = np.zeros((mesh.num_vertices(), 2), np.int64)
            px[order, 0] = xs
            px[order, 1] = ys
            corr_meta.append((i, w, h, sum(len(r) for r in corr_rows)))
            corr_rows.append(px)
        # Point sets drop connectivity (scene2pset collects vertices only).
        mesh.faces = np.zeros((0, 3), np.int32)
        meshes.append(mesh)
        if verbose:
            print(f"View {i}: {mesh.num_vertices()} points.")
        view.cache_cleanup()

    merged = mesh_merge(meshes)
    if output_path:
        mesh_io.save_mesh(merged, output_path,
                          write_normals=with_normals or poisson_normals,
                          write_values=with_scale, write_confidences=with_conf)
        if verbose:
            print(f"Wrote {merged.num_vertices()} points to {output_path}.")
        if with_correspondence and corr_meta:
            # scene2pset.cc save_correspondence_data CSV layout.
            with open(output_path + "_correspondence-data.csv", "w") as f:
                f.write("x, y\n")
                for rows in corr_rows:
                    for x, y in rows:
                        f.write(f"{x}, {y}\n")
            with open(output_path + "_correspondence-metadata.csv", "w") as f:
                f.write("View_ID, Width, Height, First_Vertex_Index\n")
                for vid_, w_, h_, first in corr_meta:
                    f.write(f"{vid_}, {w_}, {h_}, {first}\n")
            if verbose:
                print(f"Wrote correspondence CSVs next to {output_path}.")
    return merged


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="scene2pset",
                                description="Depth maps -> merged point set.")
    p.add_argument("scene", help="Scene directory")
    p.add_argument("output", help="Output PLY file")
    p.add_argument("-d", "--depthmap", default="depth-L0")
    p.add_argument("-i", "--image", default="undistorted")
    p.add_argument("-n", "--with-normals", action="store_true")
    p.add_argument("-s", "--with-scale", action="store_true")
    p.add_argument("-c", "--with-conf", action="store_true")
    p.add_argument("-p", "--poisson-normals", action="store_true")
    p.add_argument("-m", "--mask", type=str, default="",
                   help="Name of mask/silhouette image to clip 3D points []")
    p.add_argument("-b", "--bounding-box", type=str, default="",
                   help="Six comma separated values used as AABB")
    p.add_argument("-C", "--correspondence", action="store_true",
                   help="Output correspondences (in absence of -m and -b only)")
    p.add_argument("-S", "--scale-factor", type=float, default=2.5)
    p.add_argument("-f", "--min-fraction", type=float, default=0.0)
    p.add_argument("-v", "--views", default="", help="View IDs [all]")
    p.add_argument("-F", "--fssr", type=int, default=None, metavar="SCALE",
                   help="FSSR mode: sets -nsc, depth/undist at level SCALE")
    p.add_argument("--process-id", type=int, default=process_id_from_env(),
                   help="This process's index for sharding the views "
                        "[JAX_PROCESS_ID or 0]")
    p.add_argument("--num-processes", type=int, default=num_processes_from_env(),
                   help="Total processes sharing the view list (give each "
                        "process its own output file; fssrecon accepts "
                        "multiple inputs)")
    p.add_argument("--device", default="cuda",
                   help="Device the entry point is resolved on: cuda (default) or cpu")
    args = p.parse_args(argv)

    dmname, image = args.depthmap, args.image
    with_normals, with_scale, with_conf = (args.with_normals, args.with_scale,
                                           args.with_conf)
    if args.fssr is not None:
        dmname = f"depth-L{args.fssr}"
        image = "undistorted" if args.fssr == 0 else f"undist-L{args.fssr}"
        with_normals = with_scale = with_conf = True
    ids = set(int(x) for x in args.views.split(",")) if args.views else None
    aabb = None
    if args.bounding_box:
        vals = [float(x) for x in args.bounding_box.split(",")]
        if len(vals) != 6:
            p.error("--bounding-box needs 6 comma-separated values")
        aabb = (np.asarray(vals[:3], np.float32),
                np.asarray(vals[3:], np.float32))
    scene_to_pointset(
        args.scene, args.output, dmname=dmname, image=image,
        with_normals=with_normals, with_scale=with_scale, with_conf=with_conf,
        poisson_normals=args.poisson_normals, scale_factor=args.scale_factor,
        min_valid_fraction=args.min_fraction, view_ids=ids,
        aabb=aabb, mask_name=args.mask,
        with_correspondence=args.correspondence,
        process_id=args.process_id, num_processes=args.num_processes,
        device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
