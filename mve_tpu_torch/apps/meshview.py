"""meshview: headless 3D scene/mesh renderer (reference: apps/umve 3D
inspector + libs/ogl draw path, SURVEY §2.7/§2.8; port of
mve_tpu/apps/meshview.py).

    python -m mve_tpu_torch.apps.meshview [--device cpu] [--scene <scene>] <mesh.ply> ...

Renders meshes/point sets — optionally with camera frusta, SfM points
and a world axis from an MVE scene — to PNG images via the software
rasterizer, which runs on the device (render/rasterizer.py); the overlays
are host numpy. `--turntable N` produces an N-frame orbit; a specific
viewpoint can be taken from a scene view (`--view-id`) exactly as umve's
"snap to view" does. Every option is mve_tpu's; the port adds --device.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from .. import resolve_device
from ..core import mesh_io
from ..core.image_io import save_image
from ..core.scene import Scene
from ..render import (Camera, render_mesh, overlay_points, overlay_lines,
                      frustum_segments, axis_segments, turntable_views,
                      fit_view_to_points)


def _gather_scene_overlays(scene_path: str):
    """Load the scene once; return (cameras, sfm points, colors, scene)."""
    scene = Scene()
    scene.load_scene(scene_path)
    cams = [v.camera for v in scene.get_views()
            if v is not None and v.camera.valid]
    pts = np.zeros((0, 3))
    cols = np.zeros((0, 3))
    if scene.has_bundle():
        bundle = scene.get_bundle()
        pts = bundle.feature_positions()
        cols = bundle.feature_colors()[:, :3]
    return cams, pts, cols, scene


def _frusta(cams, size: float) -> np.ndarray:
    segs = [frustum_segments(c, size=size) for c in cams]
    return np.concatenate(segs) if segs else np.zeros((0, 2, 3))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="meshview",
                                description="Render meshes and scene geometry to images.")
    p.add_argument("meshes", nargs="*", help="Mesh/point-set files (PLY/OFF/OBJ/...)")
    p.add_argument("-o", "--output", default="render.png",
                   help="Output PNG (frame index appended for turntables)")
    p.add_argument("--scene", help="MVE scene: draw camera frusta + SfM points")
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--height", type=int, default=768)
    p.add_argument("--fov", type=float, default=45.0, help="Vertical FoV (deg)")
    p.add_argument("--turntable", type=int, default=0, metavar="N",
                   help="Render N orbit frames instead of one view")
    p.add_argument("--elevation", type=float, default=20.0)
    p.add_argument("--view-id", type=int, default=-1,
                   help="Render from this scene view's camera pose")
    p.add_argument("--frustum-size", type=float, default=0.0,
                   help="Frustum depth in world units (0 = auto)")
    p.add_argument("--no-axis", action="store_true")
    p.add_argument("--background", type=float, nargs=3,
                   default=(1.0, 1.0, 1.0))
    p.add_argument("--device", default="cuda",
                   help="torch device of the rasterizer (default: cuda)")
    args = p.parse_args(argv)
    if not args.meshes and not args.scene:
        p.error("need at least one mesh or --scene")
    dev = resolve_device(args.device)

    meshes = [mesh_io.load_mesh(m) for m in args.meshes]
    all_pts = [m.vertices for m in meshes if m.num_vertices()]

    scene = None
    segs = np.zeros((0, 2, 3))
    sfm_pts = np.zeros((0, 3))
    sfm_cols = np.zeros((0, 3))
    if args.scene:
        cams, sfm_pts, sfm_cols, scene = _gather_scene_overlays(args.scene)
        if len(sfm_pts):
            all_pts.append(sfm_pts)
        size = args.frustum_size
        if not size:
            # Auto frustum size from the content extent (camera apexes +
            # mesh + SfM points), then recompute the segments — and the
            # fit points — with the chosen size.
            probe = all_pts + [np.asarray([c.camera_pos() for c in cams])] \
                if cams else all_pts
            if probe:
                extent = np.concatenate(probe)
                size = 0.05 * float(np.linalg.norm(
                    extent.max(0) - extent.min(0)) or 1.0)
            else:
                size = 1.0
        segs = _frusta(cams, size)
        if len(segs):
            all_pts.append(segs.reshape(-1, 3))

    if not all_pts:
        print("Nothing to render.", file=sys.stderr)
        return 1
    center, dist = fit_view_to_points(np.concatenate(all_pts), args.fov)

    fov = args.fov
    if args.view_id >= 0:
        if scene is None:
            p.error("--view-id requires --scene")
        view = scene.get_view_by_id(args.view_id)
        if view is None or not view.camera.valid:
            p.error(f"--view-id {args.view_id}: no such view or camera invalid")
        # Match the view's actual framing: vertical FoV from the
        # normalized focal length (flen normalized by the larger dim).
        fov = float(np.rad2deg(2.0 * np.arctan2(
            args.height / max(args.width, args.height), 2.0 * view.camera.flen)))

    cam = Camera()
    cam.width, cam.height = args.width, args.height
    cam.z_far = dist * 100.0
    cam.set_fov(fov)

    def camera_poses():
        if args.view_id >= 0:
            ci = scene.get_view_by_id(args.view_id).camera
            yield ci.camera_pos(), ci.viewing_direction(), -ci.cam_to_world()[:3, 1]
        elif args.turntable > 0:
            yield from turntable_views(center, dist, args.turntable,
                                       elevation_deg=args.elevation)
        else:
            yield from turntable_views(center, dist, 1,
                                       elevation_deg=args.elevation)

    base, ext = os.path.splitext(args.output)
    frames = list(camera_poses())
    for i, (pos, viewdir, up) in enumerate(frames):
        cam.pos = np.asarray(pos, np.float32)
        cam.viewing_dir = np.asarray(viewdir, np.float32)
        cam.up_vec = np.asarray(up, np.float32)
        cam.update_matrices()

        rgb = np.ones((args.height, args.width, 3), np.float32) \
            * np.asarray(args.background, np.float32)
        depth = np.full((args.height, args.width), np.inf, np.float32)
        for m in meshes:
            if m.num_faces():
                r, d = render_mesh(m, cam.view, cam.proj,
                                   args.width, args.height,
                                   background=args.background, device=dev)
                closer = d < depth
                rgb[closer] = r[closer]
                depth[closer] = d[closer]
            elif m.num_vertices():
                cols = (m.vertex_colors[:, :3] if m.has_vertex_colors()
                        else np.full((1, 3), 0.3, np.float32))
                overlay_points(rgb, depth, m.vertices, cols,
                               cam.view, cam.proj, radius=0)
        if len(sfm_pts):
            overlay_points(rgb, depth, sfm_pts, sfm_cols,
                           cam.view, cam.proj, radius=0)
        if len(segs):
            overlay_lines(rgb, depth, segs, (0.1, 0.35, 0.9),
                          cam.view, cam.proj)
        if not args.no_axis:
            overlay_lines(rgb, depth, axis_segments(dist * 0.2, center),
                          (0.8, 0.2, 0.2), cam.view, cam.proj)

        out = args.output if len(frames) == 1 else f"{base}_{i:04d}{ext}"
        save_image((np.clip(rgb, 0, 1) * 255).astype(np.uint8), out)
        print(f"Wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
