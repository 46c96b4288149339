"""sceneinspect — headless scene inspector (UMVE equivalent).

The reference ships UMVE, a Qt5 GUI (reference: apps/umve/, ~11k LoC) with a
scene manager, a view/image inspector with tonemapping, and a 3D scene
inspector whose addins render camera frusta, SfM points and depth-map
triangulations. A windowing GUI is out of scope for a TPU cluster framework
(SURVEY §2.7), so this app provides the same *capabilities* headlessly:

- ``info``        scene manager view: per-view table (id, name, camera,
                  embeddings + dims, blobs), bundle stats, memory footprint
                  (umve scene_inspect/view_inspect panes).
- ``export``      view inspector: export any embedding as PNG/PFM with the
                  inspector's tonemapping modes (umve imageinspector
                  tone mapping: gamma + min/max normalization).
- ``frusta``      3D addin: camera frusta wireframe mesh to PLY
                  (umve scene_addins/addin_frusta_base.cc).
- ``points``      3D addin: SfM points + per-camera tint to PLY
                  (umve scene_addins/addin_sfm_renderer.cc).
- ``dmtriangulate`` 3D addin: depth-map triangulation to a world-space mesh
                  (umve scene_addins/addin_dm_triangulate.cc).
- ``delete-embeddings`` batch dialog: remove an embedding across views
                  (umve batch_delete.cc).
- ``report``      self-contained HTML report with thumbnails and an
                  interactive 3D point/frusta viewer (vanilla JS canvas,
                  no external assets) — the "GUI" replacement.

A port of mve_tpu/apps/sceneinspect.py: host numpy, except the report's
thumbnails, which are resized on the device (``report --device``).

    python -m mve_tpu_torch.apps.sceneinspect info <scene>
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import os
import sys

import numpy as np

from .. import resolve_device
from ..core import image_tools, mesh_io
from ..core.mesh import TriangleMesh
from ..core.scene import Scene
from ..core.depthmap import depthmap_triangulate


# ---------------------------------------------------------------------------
# info
# ---------------------------------------------------------------------------

def scene_info(scene_path: str, out=sys.stdout) -> dict:
    """Scene-manager style summary. Returns the data as a dict too."""
    scene = Scene(scene_path)
    views = [v for v in scene.get_views() if v is not None]
    rows = []
    for v in views:
        embeddings = {}
        for name in sorted(v.get_image_names()):
            size = v.get_image_size(name)
            embeddings[name] = "x".join(str(s) for s in size) if size else "?"
        rows.append({
            "id": v.id,
            "name": v.name,
            "camera": f"flen={v.camera.flen:.4g}" if v.camera.valid else "invalid",
            "images": embeddings,
            "blobs": sorted(v.get_blob_names()),
        })
    info = {"path": scene_path, "views": rows}
    if scene.has_bundle():
        b = scene.get_bundle()
        valid = sum(1 for c in b.cameras if c.valid)
        info["bundle"] = {
            "cameras": b.get_num_cameras(),
            "valid_cameras": valid,
            "features": b.get_num_features(),
        }
    info["mem_bytes"] = scene.get_total_mem_usage()

    print(f"Scene: {scene_path} ({len(rows)} views)", file=out)
    for r in rows:
        imgs = ", ".join(f"{k}({v})" for k, v in r["images"].items())
        blobs = (" blobs: " + ",".join(r["blobs"])) if r["blobs"] else ""
        print(f"  view {r['id']:4d}  {r['name']:<16} {r['camera']:<14} "
              f"{imgs}{blobs}", file=out)
    if "bundle" in info:
        bi = info["bundle"]
        print(f"Bundle: {bi['cameras']} cameras ({bi['valid_cameras']} valid), "
              f"{bi['features']} features", file=out)
    print(f"Memory: {info['mem_bytes']} bytes", file=out)
    return info


# ---------------------------------------------------------------------------
# export (view inspector tonemapping)
# ---------------------------------------------------------------------------

def tonemap(img: np.ndarray, mode: str = "auto", gamma: float = 2.2) -> np.ndarray:
    """Map any embedding to displayable uint8 like umve's image inspector:
    byte images pass through; float images are min/max normalized over
    finite, positive-where-depth pixels, with optional gamma."""
    img = np.asarray(img)
    if img.dtype == np.uint8:
        return img
    x = img.astype(np.float32)
    finite = np.isfinite(x)
    valid = finite & (x > 0) if mode == "depth" else finite
    if not valid.any():
        return np.zeros(img.shape, np.uint8)
    lo = float(x[valid].min())
    hi = float(x[valid].max())
    x = np.where(valid, (x - lo) / max(hi - lo, 1e-20), 0.0)
    if gamma and gamma != 1.0:
        x = np.power(np.clip(x, 0.0, 1.0), 1.0 / gamma)
    return (np.clip(x, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def export_embedding(scene_path: str, view_id: int, name: str,
                     output: str, mode: str = "auto", gamma: float = 2.2) -> None:
    from ..core import image_io

    scene = Scene(scene_path)
    view = scene.get_view_by_id(view_id)
    if view is None:
        raise IOError(f"no view {view_id}")
    img = view.get_image(name)
    if img is None:
        raise IOError(f"view {view_id} has no embedding '{name}'")
    if output.lower().endswith(".pfm"):
        image_io.save_image(np.asarray(img, np.float32), output)
    else:
        image_io.save_image(tonemap(img, mode=mode, gamma=gamma), output)


# ---------------------------------------------------------------------------
# 3D addins: frusta / points / depth-map triangulation
# ---------------------------------------------------------------------------

def frusta_mesh(scene_path: str, size: float = 0.1) -> TriangleMesh:
    """Camera frusta as line-ish quads (addin_frusta_base.cc draw_camera):
    for each valid camera a pyramid from the center through the four
    normalized image corners at depth ``size``."""
    scene = Scene(scene_path)
    verts, faces, colors = [], [], []
    for v in scene.get_views():
        if v is None or not v.camera.valid:
            continue
        cam = v.camera
        c2w = cam.cam_to_world()
        # Normalized image plane corners at unit focal distance.
        corners = []
        for cx, cy in ((-0.5, -0.5), (0.5, -0.5), (0.5, 0.5), (-0.5, 0.5)):
            d = np.array([cx / cam.flen, cy / cam.flen, 1.0]) * size
            corners.append((c2w[:3, :3] @ d) + c2w[:3, 3])
        apex = cam.camera_pos()
        base = len(verts)
        verts.extend([apex] + corners)
        # Four side triangles + two base triangles.
        for i in range(4):
            faces.append([base, base + 1 + i, base + 1 + (i + 1) % 4])
        faces.append([base + 1, base + 2, base + 3])
        faces.append([base + 1, base + 3, base + 4])
        colors.extend([[0.5, 0.5, 0.5, 1.0]] * 5)
    mesh = TriangleMesh()
    if verts:
        mesh.vertices = np.asarray(verts, np.float32)
        mesh.faces = np.asarray(faces, np.int32)
        mesh.vertex_colors = np.asarray(colors, np.float32)
    return mesh


def sfm_points_mesh(scene_path: str) -> TriangleMesh:
    """Bundle features as a colored point cloud (addin_sfm_renderer.cc)."""
    scene = Scene(scene_path)
    bundle = scene.get_bundle()
    mesh = TriangleMesh()
    mesh.vertices = bundle.feature_positions()
    colors = bundle.feature_colors()
    mesh.vertex_colors = np.concatenate(
        [colors, np.ones((len(colors), 1), np.float32)], axis=1)
    return mesh


def dm_triangulate(scene_path: str, view_id: int, depth_name: str,
                   image_name: str | None = None,
                   dd_factor: float = 5.0) -> TriangleMesh:
    """Depth-map triangulation into a WORLD-space mesh
    (addin_dm_triangulate.cc -> mve::geom::depthmap_triangulate)."""
    scene = Scene(scene_path)
    view = scene.get_view_by_id(view_id)
    if view is None:
        raise IOError(f"no view {view_id}")
    depth = view.get_float_image(depth_name)
    if depth is None:
        raise IOError(f"view {view_id} has no depth embedding '{depth_name}'")
    color = view.get_byte_image(image_name) if image_name else None
    h, w = np.squeeze(np.asarray(depth)).shape[:2]
    invproj = view.camera.inverse_calibration(w, h)
    mesh, _ = depthmap_triangulate(depth, invproj, dd_factor=dd_factor,
                                   color_image=color)
    c2w = view.camera.cam_to_world()
    mesh.vertices = (mesh.vertices @ c2w[:3, :3].T + c2w[:3, 3]).astype(np.float32)
    return mesh


# ---------------------------------------------------------------------------
# batch dialogs
# ---------------------------------------------------------------------------

def delete_embeddings(scene_path: str, name: str,
                      view_ids=None) -> int:
    """Remove embedding ``name`` from all (or selected) views
    (umve batch_delete.cc)."""
    scene = Scene(scene_path)
    n = 0
    for v in scene.get_views():
        if v is None or (view_ids is not None and v.id not in view_ids):
            continue
        if v.remove_image(name) or v.remove_blob(name):
            v.save_view()
            n += 1
    return n


# ---------------------------------------------------------------------------
# HTML report (the interactive stand-in for the GUI)
# ---------------------------------------------------------------------------

_REPORT_JS = r"""
const cv = document.getElementById('v3d'); const ctx = cv.getContext('2d');
let yaw = 0.6, pitch = 0.4, dist = 3.0, cx = 0, cy = 0, czz = 0;
if (PTS.length) {
  let sx=0, sy=0, sz=0;
  for (const p of PTS) { sx+=p[0]; sy+=p[1]; sz+=p[2]; }
  cx=sx/PTS.length; cy=sy/PTS.length; czz=sz/PTS.length;
  let r=0; for (const p of PTS) r=Math.max(r, Math.hypot(p[0]-cx,p[1]-cy,p[2]-czz));
  dist = Math.max(1e-3, r*2.2);
}
function draw() {
  ctx.fillStyle='#111'; ctx.fillRect(0,0,cv.width,cv.height);
  const cyw=Math.cos(yaw), syw=Math.sin(yaw), cp=Math.cos(pitch), sp=Math.sin(pitch);
  const f = 0.9*Math.min(cv.width,cv.height);
  function proj(p){
    let x=p[0]-cx, y=p[1]-cy, z=p[2]-czz;
    let x1=cyw*x+syw*z, z1=-syw*x+cyw*z;
    let y1=cp*y-sp*z1, z2=sp*y+cp*z1+dist;
    if (z2<=1e-6) return null;
    return [cv.width/2+f*x1/z2, cv.height/2-f*y1/z2, z2];
  }
  for (let i=0;i<PTS.length;i++){
    const s=proj(PTS[i]); if(!s) continue;
    ctx.fillStyle=COLS[i]; ctx.fillRect(s[0],s[1],2,2);
  }
  ctx.strokeStyle='#6cf'; ctx.lineWidth=1;
  for (const fr of FRUSTA){
    const v=fr.map(proj); if(v.some(a=>!a)) continue;
    ctx.beginPath();
    for (let i=1;i<=4;i++){ ctx.moveTo(v[0][0],v[0][1]); ctx.lineTo(v[i][0],v[i][1]); }
    for (let i=1;i<=4;i++){ const j=i%4+1;
      ctx.moveTo(v[i][0],v[i][1]); ctx.lineTo(v[j][0],v[j][1]); }
    ctx.stroke();
  }
}
let drag=false, lx=0, ly=0;
cv.addEventListener('mousedown',e=>{drag=true;lx=e.offsetX;ly=e.offsetY;});
window.addEventListener('mouseup',()=>drag=false);
cv.addEventListener('mousemove',e=>{ if(!drag)return;
  yaw+=(e.offsetX-lx)*0.01; pitch+=(e.offsetY-ly)*0.01;
  pitch=Math.max(-1.5,Math.min(1.5,pitch)); lx=e.offsetX; ly=e.offsetY; draw();});
cv.addEventListener('wheel',e=>{e.preventDefault();
  dist*=Math.exp(e.deltaY*0.001); draw();});
draw();
"""


def write_report(scene_path: str, output: str, thumb_size: int = 100,
                 max_points: int = 20000, device="cuda") -> None:
    """Self-contained HTML report: scene table, per-view thumbnails
    (base64 PNG), and an orbitable 3D canvas with SfM points + frusta."""
    dev = resolve_device(device)
    scene = Scene(scene_path)
    views = [v for v in scene.get_views() if v is not None]

    def thumb_b64(v):
        img = None
        for name in ("thumbnail", "original", "undistorted"):
            if v.has_image(name):
                img = v.get_image(name)
                break
        if img is None:
            for name in sorted(v.get_image_names()):
                img = v.get_image(name)
                break
        if img is None:
            return None
        img = tonemap(img)
        if max(img.shape[:2]) > thumb_size:
            img = image_tools.create_thumbnail(img, thumb_size, thumb_size, device=dev)
        from PIL import Image

        arr = np.squeeze(img)
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, format="PNG")
        return base64.b64encode(buf.getvalue()).decode()

    rows_html = []
    for v in views:
        b64 = thumb_b64(v)
        img_tag = (f'<img src="data:image/png;base64,{b64}">' if b64 else "")
        embeds = ", ".join(
            f"{n}({'x'.join(str(s) for s in (v.get_image_size(n) or ()))})"
            for n in sorted(v.get_image_names()))
        cam = f"flen={v.camera.flen:.4g}" if v.camera.valid else "—"
        rows_html.append(
            f"<tr><td>{v.id}</td><td>{img_tag}</td><td>{v.name}</td>"
            f"<td>{cam}</td><td>{embeds}</td></tr>")

    pts_js, cols_js, frusta_js = "[]", "[]", "[]"
    if scene.has_bundle():
        b = scene.get_bundle()
        pos = b.feature_positions()
        col = b.feature_colors()
        if len(pos) > max_points:
            idx = np.linspace(0, len(pos) - 1, max_points).astype(int)
            pos, col = pos[idx], col[idx]
        pts_js = json.dumps(np.round(pos, 4).tolist())
        cols_js = json.dumps([
            "#%02x%02x%02x" % tuple(int(c * 255) for c in rgb) for rgb in col])
    fmesh_sz = 0.08
    frusta = []
    for v in views:
        if not v.camera.valid:
            continue
        cam = v.camera
        c2w = cam.cam_to_world()
        pts = [cam.camera_pos().tolist()]
        for fx, fy in ((-0.5, -0.5), (0.5, -0.5), (0.5, 0.5), (-0.5, 0.5)):
            d = np.array([fx / cam.flen, fy / cam.flen, 1.0]) * fmesh_sz
            pts.append(((c2w[:3, :3] @ d) + c2w[:3, 3]).tolist())
        frusta.append([[round(float(x), 4) for x in p] for p in pts])
    frusta_js = json.dumps(frusta)

    html = f"""<!doctype html><html><head><meta charset="utf-8">
<title>Scene report: {os.path.basename(scene_path)}</title>
<style>
body {{ font: 13px sans-serif; margin: 16px; background: #fafafa; }}
table {{ border-collapse: collapse; }}
td, th {{ border: 1px solid #ccc; padding: 3px 8px; }}
img {{ display: block; }}
canvas {{ border: 1px solid #888; cursor: grab; }}
</style></head><body>
<h2>Scene: {scene_path}</h2>
<p>{len(views)} views. Drag to orbit, wheel to zoom.</p>
<canvas id="v3d" width="720" height="480"></canvas>
<h3>Views</h3>
<table><tr><th>id</th><th>thumb</th><th>name</th><th>camera</th><th>embeddings</th></tr>
{''.join(rows_html)}
</table>
<script>
const PTS = {pts_js};
const COLS = {cols_js};
const FRUSTA = {frusta_js};
{_REPORT_JS}
</script></body></html>"""
    with open(output, "w") as f:
        f.write(html)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="sceneinspect",
        description="Headless scene inspector (UMVE equivalent)")
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("info", help="scene summary")
    sp.add_argument("scene")

    sp = sub.add_parser("export", help="export embedding with tonemapping")
    sp.add_argument("scene")
    sp.add_argument("output")
    sp.add_argument("--view", type=int, required=True)
    sp.add_argument("--embedding", default="original")
    sp.add_argument("--mode", default="auto", choices=["auto", "depth"])
    sp.add_argument("--gamma", type=float, default=2.2)

    sp = sub.add_parser("frusta", help="camera frusta mesh to PLY")
    sp.add_argument("scene")
    sp.add_argument("output")
    sp.add_argument("--size", type=float, default=0.1)

    sp = sub.add_parser("points", help="SfM points to PLY")
    sp.add_argument("scene")
    sp.add_argument("output")

    sp = sub.add_parser("dmtriangulate", help="depth map -> world mesh")
    sp.add_argument("scene")
    sp.add_argument("output")
    sp.add_argument("--view", type=int, required=True)
    sp.add_argument("--depth", default="depth-L0")
    sp.add_argument("--image", default=None)
    sp.add_argument("--dd-factor", type=float, default=5.0)

    sp = sub.add_parser("delete-embeddings", help="remove embedding from views")
    sp.add_argument("scene")
    sp.add_argument("--name", required=True)
    sp.add_argument("--views", default="",
                    help="comma-separated view ids (default: all)")

    sp = sub.add_parser("report", help="self-contained HTML report")
    sp.add_argument("scene")
    sp.add_argument("output")
    sp.add_argument("--device", default="cuda",
                    help="Device of the thumbnail resize: cuda or cpu [cuda]")

    args = p.parse_args(argv)
    if args.cmd == "info":
        scene_info(args.scene)
    elif args.cmd == "export":
        export_embedding(args.scene, args.view, args.embedding, args.output,
                         mode=args.mode, gamma=args.gamma)
        print(f"Exported view {args.view} '{args.embedding}' to {args.output}")
    elif args.cmd == "frusta":
        mesh_io.save_mesh(frusta_mesh(args.scene, size=args.size), args.output)
        print(f"Wrote frusta mesh to {args.output}")
    elif args.cmd == "points":
        mesh_io.save_mesh(sfm_points_mesh(args.scene), args.output)
        print(f"Wrote SfM points to {args.output}")
    elif args.cmd == "dmtriangulate":
        mesh = dm_triangulate(args.scene, args.view, args.depth,
                              image_name=args.image, dd_factor=args.dd_factor)
        mesh_io.save_mesh(mesh, args.output)
        print(f"Wrote {mesh.num_vertices()} verts / {mesh.num_faces()} faces "
              f"to {args.output}")
    elif args.cmd == "delete-embeddings":
        ids = ([int(x) for x in args.views.split(",") if x]
               if args.views else None)
        n = delete_embeddings(args.scene, args.name, view_ids=ids)
        print(f"Removed '{args.name}' from {n} views")
    elif args.cmd == "report":
        write_report(args.scene, args.output, device=args.device)
        print(f"Wrote report to {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
