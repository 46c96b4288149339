"""The port's viewer against mve_tpu's, on the CPU: render/camera.py,
render/tools.py, the rasterizer, the overlays, meshview's PNG, and the
drawing helpers (core/image_drawing.py, sfm/visualizer.py).

The host code is a numpy copy and is held bit for bit. The rasterizer is
XLA in mve_tpu and PyTorch here, at 64x48. XLA's CPU backend may fuse
the multiply-adds of the edge functions and of the interpolation, so a
pixel on an edge two triangles share can change owner, and depth and
colour round apart. Stated limits: at most 1% of the pixels either
package covers differ in coverage or in owner (a depth more than 1e-5 or
a colour more than 1e-4 apart); on every other pixel, depth within 1e-6
and colour within 1e-5. The measured differences are a few 1e-7, with no
pixel at fault on these meshes.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from mve_tpu.apps import meshview as japp
from mve_tpu.core import image_drawing as jdraw
from mve_tpu.core.camera import CameraInfo as JCameraInfo
from mve_tpu.core.mesh import TriangleMesh as JMesh
from mve_tpu.render import camera as jcam
from mve_tpu.render import rasterizer as jras
from mve_tpu.render import tools as jtools
from mve_tpu.sfm import visualizer as jvis

from mve_tpu_torch import synthetic
from mve_tpu_torch.apps import meshview as papp
from mve_tpu_torch.apps.fssrecon import fssr_reconstruct
from mve_tpu_torch.core import bundle as pbundle
from mve_tpu_torch.core import image_drawing as pdraw
from mve_tpu_torch.core.bundle_io import save_mve_bundle
from mve_tpu_torch.core.camera import CameraInfo as PCameraInfo
from mve_tpu_torch.core.mesh import TriangleMesh as PMesh
from mve_tpu_torch.core.mesh_io import save_mesh
from mve_tpu_torch.render import camera as pcam
from mve_tpu_torch.render import rasterizer as pras
from mve_tpu_torch.render import tools as ptools
from mve_tpu_torch.sfm import visualizer as pvis

from tests.test_torch_fssr import sphere
from tests.test_torch_fssrecon import _write_pset

torch.set_num_threads(1)

W, H = 64, 48
FAULT_SHARE, DEPTH_TOL, RGB_TOL = 0.01, 1e-6, 1e-5


def _grid(n, z0, seed, scale=1.0):
    rng = np.random.RandomState(seed)
    ys, xs = np.mgrid[0:n, 0:n].astype(np.float64) / (n - 1) - 0.5
    verts = np.stack([xs, ys, z0 + 0.05 * rng.randn(n, n)], -1).reshape(-1, 3) * scale
    idx = np.arange(n * n).reshape(n, n)
    a, b, c, d = idx[:-1, :-1].ravel(), idx[:-1, 1:].ravel(), idx[1:, :-1].ravel(), idx[1:, 1:].ravel()
    return verts, np.concatenate([np.stack([a, b, d], 1), np.stack([a, d, c], 1)])


def _meshes(verts, faces, colors=None):
    out = []
    for cls in (JMesh, PMesh):
        m = cls()
        m.vertices = np.asarray(verts, np.float32)
        m.faces = np.asarray(faces, np.int32)
        if colors is not None:
            m.vertex_colors = np.asarray(colors, np.float32)
        out.append(m)
    return out


def _quads():
    v, f = _grid(12, 0.0, 1)
    return _meshes(v, f)


def _overlapping():
    """Two noisy grids, one in front of the other, and a copy of the first
    grid's faces in other colours: the copies tie in depth with the
    originals, and the lower face index must win."""
    v1, f1 = _grid(12, 0.0, 1)
    v2, f2 = _grid(9, 0.15, 2, scale=0.7)
    verts = np.concatenate([v1, v2, v1])
    faces = np.concatenate([f1, f2 + len(v1), f1 + len(v1) + len(v2)])
    rng = np.random.RandomState(3)
    colors = np.c_[rng.rand(len(verts), 3), np.ones(len(verts))]
    return _meshes(verts, faces, colors)


@pytest.fixture(scope="module")
def fssr_sphere(tmp_path_factory):
    root = tmp_path_factory.mktemp("render")
    path = _write_pset(root / "sphere.ply", [sphere(n=600, scale=0.2)[0]])
    mesh = fssr_reconstruct(path, verbose=False, device="cpu")
    return _meshes(mesh.vertices, mesh.faces, mesh.vertex_colors)


def _camera(pos, fov=45.0):
    cams = []
    for mod in (jcam, pcam):
        cam = mod.Camera()
        cam.width, cam.height = W, H
        cam.pos = np.asarray(pos, np.float32)
        cam.viewing_dir = -cam.pos / np.linalg.norm(cam.pos)
        cam.set_fov(fov)
        cam.update_matrices()
        cams.append(cam)
    return cams


def _compare_frames(ref, got):
    """(pixels at fault, covered pixels); asserts the limits elsewhere."""
    (r_rgb, r_d), (g_rgb, g_d) = ref, got
    assert g_rgb.shape == r_rgb.shape == (H, W, 3) and g_d.shape == r_d.shape == (H, W)
    rc, gc = np.isfinite(r_d), np.isfinite(g_d)
    both = rc & gc
    dd = np.zeros_like(r_d)
    dd[both] = np.abs(r_d[both] - g_d[both])
    owner = both & ((dd > 1e-5) | (np.abs(r_rgb - g_rgb).max(-1) > 1e-4))
    fault = (rc != gc) | owner
    assert dd[both & ~owner].max(initial=0) <= DEPTH_TOL
    assert np.abs(r_rgb - g_rgb).max(-1)[~fault].max(initial=0) <= RGB_TOL
    return int(fault.sum()), int((rc | gc).sum())


@pytest.mark.parametrize("which", ["quads", "overlapping", "fssr_sphere"])
def test_render_mesh_matches_jax(which, request):
    jm, pm = request.getfixturevalue(which) if which == "fssr_sphere" else \
        {"quads": _quads, "overlapping": _overlapping}[which]()
    pos = [0.3, 0.2, 2.0] if which != "fssr_sphere" else [1.5, 1.2, 3.0]
    jc, pc = _camera(pos)
    ref = jras.render_mesh(jm, jc.view, jc.proj, W, H)
    got = pras.render_mesh(pm, pc.view, pc.proj, W, H, device="cpu")
    fault, covered = _compare_frames(ref, got)
    assert covered > 300, "the mesh should fill a good part of the frame"
    assert fault <= FAULT_SHARE * covered


def test_image_does_not_depend_on_chunk_size(monkeypatch):
    """The same mesh at five chunk sizes (each windowing the screen
    differently) gives identical buffers: per pixel the nearest triangle,
    ties to the lowest face index."""
    _, pm = _overlapping()
    _, pc = _camera([0.3, 0.2, 2.0])
    frames = []
    for chunk in (1, 3, 7, 32, 64):
        monkeypatch.setattr(pras, "_chunk_size", lambda n_pix, c=chunk: c)
        frames.append(pras.render_mesh(pm, pc.view, pc.proj, W, H, device="cpu"))
    for rgb, depth in frames[1:]:
        np.testing.assert_array_equal(rgb, frames[0][0])
        np.testing.assert_array_equal(depth, frames[0][1])


def test_ties_go_to_the_lowest_face_index():
    """The duplicated faces of _overlapping carry other colours: wherever
    the first grid is visible, its own colours show."""
    _, pm = _overlapping()
    _, pc = _camera([0.0, 0.0, 2.0])
    first_only = PMesh()
    first_only.vertices = pm.vertices
    first_only.faces = pm.faces[:2 * 11 * 11]          # the first grid's faces
    first_only.vertex_colors = pm.vertex_colors
    rgb, depth = pras.render_mesh(pm, pc.view, pc.proj, W, H, device="cpu")
    rgb1, depth1 = pras.render_mesh(first_only, pc.view, pc.proj, W, H, device="cpu")
    same_depth = np.isfinite(depth) & (depth == depth1)
    assert same_depth.sum() > 100
    np.testing.assert_array_equal(rgb[same_depth], rgb1[same_depth])


def test_overlays_match_jax():
    """Depth-tested points and lines over one rendered frame (the same
    z-buffer in both): identical frames."""
    jm, _ = _quads()
    jc, pc = _camera([0.3, 0.2, 2.0])
    rgb, depth = jras.render_mesh(jm, jc.view, jc.proj, W, H)
    rng = np.random.RandomState(4)
    pts = rng.uniform(-0.6, 0.6, (300, 3))
    cols = rng.rand(300, 3)
    segs = rng.uniform(-1, 1, (12, 2, 3))
    segs[0] = [[0, 0, 1.0], [0, 0, 3.0]]          # crosses the camera plane
    out = []
    for ras, cam in ((jras, jc), (pras, pc)):
        frame = rgb.copy()
        ras.overlay_points(frame, depth, pts, cols, cam.view, cam.proj, radius=1)
        ras.overlay_points(frame, depth, pts[:50] * 0.5, (0.3, 0.3, 0.3), cam.view, cam.proj,
                           radius=0)
        ras.overlay_lines(frame, depth, segs, (0.1, 0.35, 0.9), cam.view, cam.proj)
        out.append(frame)
    assert not np.array_equal(out[0], rgb)
    np.testing.assert_array_equal(out[1], out[0])


def test_camera_and_trackball_bit_identical():
    jc, pc = _camera([0.4, -0.3, 2.5], fov=50.0)
    for name in ("view", "inv_view", "proj", "inv_proj"):
        np.testing.assert_array_equal(getattr(pc, name), getattr(jc, name))
    np.testing.assert_array_equal(pcam.look_at([1, 2, 3], [0, -1, -1], [0, 0, 1]),
                                  jcam.look_at([1, 2, 3], [0, -1, -1], [0, 0, 1]))
    np.testing.assert_array_equal(pcam.frustum_matrix(0.2, 0.15, 0.1, 80.0),
                                  jcam.frustum_matrix(0.2, 0.15, 0.1, 80.0))
    balls = []
    for mod, cam in ((jcam, jc), (pcam, pc)):
        tb = mod.CamTrackball(cam)
        tb.set_camera_params([0.5, 1.0, 3.0], [0.1, 0.0, 0.2], [0, 1, 0])
        tb.rotate(10, 12, 40, 30)
        tb.rotate(60, 5, 2, 47)          # both ends outside the ball
        tb.zoom(0.7)
        tb.pan(0.1, -0.05)
        tb.rotate(5, 5, 5, 5)            # no motion
        balls.append((tb, cam))
    (jt, jcam_), (pt, pcam_) = balls
    for name in ("tb_center", "tb_tocam", "tb_upvec", "tb_radius"):
        np.testing.assert_array_equal(getattr(pt, name), getattr(jt, name))
    for name in ("pos", "viewing_dir", "up_vec", "view", "proj"):
        np.testing.assert_array_equal(getattr(pcam_, name), getattr(jcam_, name))
    j2, p2 = jcam.Camera2D(W, H), pcam.Camera2D(W, H)
    for c in (j2, p2):
        c.fit(300, 100)
    pts = np.array([[0, 0], [150.5, 50.25], [299, 99]])
    np.testing.assert_array_equal(p2.image_to_viewport(pts), j2.image_to_viewport(pts))
    np.testing.assert_array_equal(p2.viewport_to_image(pts), j2.viewport_to_image(pts))


def test_tools_bit_identical():
    rng = np.random.RandomState(5)
    rot = synthetic.rodrigues_to_matrix(rng.randn(3) * 0.4)
    trans = rng.randn(3)
    cams = []
    for cls in (JCameraInfo, PCameraInfo):
        c = cls()
        c.flen, c.rot, c.trans = 0.9, rot.astype(np.float32), trans.astype(np.float32)
        cams.append(c)
    np.testing.assert_array_equal(ptools.frustum_segments(cams[1], 0.3),
                                  jtools.frustum_segments(cams[0], 0.3))
    np.testing.assert_array_equal(ptools.axis_segments(2.0, (1, 2, 3)),
                                  jtools.axis_segments(2.0, (1, 2, 3)))
    np.testing.assert_array_equal(ptools.aabb_segments([0, -1, 2], [3, 4, 5]),
                                  jtools.aabb_segments([0, -1, 2], [3, 4, 5]))
    pts = rng.randn(100, 3)
    for got, want in zip(ptools.fit_view_to_points(pts, 40.0), jtools.fit_view_to_points(pts, 40.0)):
        np.testing.assert_array_equal(got, want)
    for up in ((0, 1, 0), (1, 0, 0)):
        for got, want in zip(ptools.turntable_views([1, 2, 3], 4.0, 5, 30.0, up),
                             jtools.turntable_views([1, 2, 3], 4.0, 5, 30.0, up)):
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def viewer_scene(tmp_path_factory, fssr_sphere):
    """A 3-view scene of 48x36 images with cameras, a bundle of 200 points
    and the FSSR sphere as a PLY."""
    root = tmp_path_factory.mktemp("meshview")
    _, cams = synthetic.make_two_plane_scene(str(root / "scene"), n_views=3, width=48,
                                             height=36, seed=3)
    bundle = pbundle.Bundle()
    bundle.cameras = list(cams)
    rng = np.random.RandomState(6)
    for p in rng.uniform(-1, 1, (200, 3)) * [1.0, 0.8, 0.3] + [0, 0, 4.0]:
        bundle.features.append(pbundle.Feature3D(pos=p.astype(np.float32),
                                                 color=rng.rand(3).astype(np.float32)))
    save_mve_bundle(bundle, str(root / "scene" / "synth_0.out"))
    save_mesh(fssr_sphere[1], str(root / "sphere.ply"))
    return root


@pytest.mark.parametrize("args", [["--turntable", "2", "--no-axis"],
                                  ["--scene", "{scene}", "--view-id", "1"],
                                  ["--scene", "{scene}", "--elevation", "35", "--fov", "60"]])
def test_meshview_png_matches_jax(viewer_scene, args, capsys):
    """meshview's PNGs from the command line, the port with --device cpu:
    the same files, with at most 1% of the pixels at fault (the
    rasterizer's limit; the overlays are drawn identically)."""
    args = [a.format(scene=viewer_scene / "scene") for a in args]
    mesh = str(viewer_scene / "sphere.ply")
    common = ["--width", str(W), "--height", str(H), mesh] + args
    japp.main(common + ["-o", str(viewer_scene / "j.png")])
    papp.main(common + ["-o", str(viewer_scene / "p.png"), "--device", "cpu"])
    jfiles = sorted(f for f in os.listdir(viewer_scene) if f.startswith("j"))
    pfiles = sorted(f for f in os.listdir(viewer_scene) if f.startswith("p"))
    assert [f[1:] for f in pfiles] == [f[1:] for f in jfiles] and jfiles
    for jf, pf in zip(jfiles, pfiles):
        a = np.asarray(Image.open(viewer_scene / jf)).astype(int)
        b = np.asarray(Image.open(viewer_scene / pf)).astype(int)
        assert a.shape == b.shape == (H, W, 3)
        assert (np.abs(a - b).max(-1) > 0).sum() <= FAULT_SHARE * H * W
        os.remove(viewer_scene / jf)
        os.remove(viewer_scene / pf)
    assert "Wrote" in capsys.readouterr().out


def test_meshview_refuses_without_cuda(viewer_scene):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        papp.main([str(viewer_scene / "sphere.ply"), "-o", str(viewer_scene / "x.png")])


def test_drawing_and_visualizer_byte_identical():
    rng = np.random.RandomState(7)
    img = (rng.rand(40, 50, 3) * 255).astype(np.uint8)
    gray = (rng.rand(30, 20) * 255).astype(np.uint8)
    outs = []
    for draw in (jdraw, pdraw):
        a = img.copy()
        draw.draw_line(a, -5, 3, 60, 35, (255, 0, 0))
        draw.draw_line(a, 10, 30, 12, 2, (0, 255, 0))
        draw.draw_circle(a, 20, 20, 7, (0, 0, 255))
        draw.draw_circle(a, 48, 2, 5, (9, 9, 9))
        draw.draw_box(a, 3, 4, 30, 25, (1, 2, 3))
        draw.draw_rectangle_filled(a, 45, 35, 40, 30, (7, 7, 7))
        outs.append(a)
    np.testing.assert_array_equal(outs[1], outs[0])
    xs, ys, sc = rng.uniform(0, 50, 30), rng.uniform(0, 40, 30), rng.uniform(0.5, 6, 30)
    np.testing.assert_array_equal(pvis.draw_keypoints(img, xs, ys, sc),
                                  jvis.draw_keypoints(img, xs, ys, sc))
    np.testing.assert_array_equal(pvis.draw_keypoints(gray, xs, ys),
                                  jvis.draw_keypoints(gray, xs, ys))
    p1, p2 = rng.uniform(0, 20, (15, 2)), rng.uniform(0, 30, (15, 2))
    np.testing.assert_array_equal(pvis.draw_matches(img, gray, p1, p2),
                                  jvis.draw_matches(img, gray, p1, p2))
