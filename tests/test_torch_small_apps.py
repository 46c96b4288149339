"""The port's featurerecon and host apps against mve_tpu's, on the CPU.

bundle2pset, mesh2pset, meshconvert, meshalign, sceneupgrade,
sceneinspect and prebundle are host numpy in both packages: given the
same input, every file they write is byte-identical (sceneinspect's
report too: its thumbnails are resized by the port's create_thumbnail,
and no pixel of them lies at a rounding tie here), and so is what they
print. featurerecon runs the whole per-view path (features, the per-pair
matcher, tracks, triangulation with the known cameras, points-only BA)
in both packages on a 4-view 200x150 scene: the cameras must be the
views' own, bit for bit; the track counts within 5% of mve_tpu's (the
SIFT keypoints of the two packages agree to 99%, test_torch_features.py);
and at least 95% of the port's points within 1e-3 of one of mve_tpu's.
"""

import contextlib
import io
import os
import shutil

import numpy as np
import pytest
import torch

from mve_tpu.apps import (bundle2pset as jb2p, featurerecon as jfr, mesh2pset as jm2p,
                          meshalign as jalign, meshconvert as jconv, prebundle as jpre,
                          sceneinspect as jinsp, sceneupgrade as jup)
from mve_tpu.core import Scene as JScene
from mve_tpu.core.view import View as JView

from mve_tpu_torch.apps import (bundle2pset as pb2p, featurerecon as pfr, mesh2pset as pm2p,
                                meshalign as palign, meshconvert as pconv, prebundle as ppre,
                                sceneinspect as pinsp, sceneupgrade as pup)
from mve_tpu_torch.core import Scene
from mve_tpu_torch.core import mesh_io
from mve_tpu_torch.core.mesh import TriangleMesh

from tests.synthetic import expected_ray_depth, make_cameras, make_plane_scene, make_texture, \
    render_two_plane_view
from tests.test_apps_upgrade_align import _write_legacy_prebundle, _write_legacy_view

torch.set_num_threads(1)


def run(main, argv):
    """(return code, stdout) of main(argv)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


def same_bytes(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


def same_trees(a, b):
    def files(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs)

    assert files(a) == files(b)
    for rel in files(a):
        assert same_bytes(os.path.join(a, rel), os.path.join(b, rel)), rel
    return True


def _grid_mesh(n=9, seed=0):
    rng = np.random.RandomState(seed)
    gx, gy = np.meshgrid(np.linspace(0, 1, n), np.linspace(0, 1, n))
    mesh = TriangleMesh()
    mesh.vertices = np.stack([gx.ravel(), gy.ravel(), 0.05 * rng.randn(n * n)],
                             axis=1).astype(np.float32)
    idx = np.arange(n * n).reshape(n, n)
    a, b, c, d = idx[:-1, :-1].ravel(), idx[:-1, 1:].ravel(), idx[1:, :-1].ravel(), idx[1:, 1:].ravel()
    mesh.faces = np.concatenate([np.stack([a, b, c], 1), np.stack([b, d, c], 1)]).astype(np.int32)
    mesh.vertex_colors = rng.rand(n * n, 4).astype(np.float32)
    return mesh


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    """tests/synthetic.py's plane scene with a bundle and depth maps."""
    path = tmp_path_factory.mktemp("apps") / "scene"
    make_plane_scene(str(path), n_views=3, width=96, height=72)
    scene = JScene(str(path))
    for v in scene.get_views():
        w, h = v.get_image_size("undistorted")
        v.set_image("depth-L0", expected_ray_depth(v.camera, w, h).astype(np.float32))
        v.save_view()
    return str(path)


@pytest.mark.parametrize("flags", [[], ["-s", "0.05"]])
def test_bundle2pset(scene_dir, tmp_path, flags):
    for main, name in ((jb2p.main, "j.ply"), (pb2p.main, "p.ply")):
        assert run(main, [scene_dir, str(tmp_path / name), *flags])[0] == 0
    assert same_bytes(tmp_path / "j.ply", tmp_path / "p.ply")


@pytest.mark.parametrize("flags", [[], ["-s", "0.02"], ["-a", "2.5", "-c"], ["-x", "-n"],
                                   ["-b", "0.1,0.1,-1,0.8,0.9,1"]])
def test_mesh2pset(tmp_path, flags):
    src = str(tmp_path / "mesh.ply")
    mesh_io.save_mesh(_grid_mesh(), src)
    for main, name in ((jm2p.main, "j.ply"), (pm2p.main, "p.ply")):
        assert run(main, [src, str(tmp_path / name), *flags])[0] == 0
    assert same_bytes(tmp_path / "j.ply", tmp_path / "p.ply")


@pytest.mark.parametrize("out,flags", [("m.off", []), ("m.obj", []), ("m.ply", ["-a"]),
                                       ("m.ply", ["-n"]), ("m.npts", [])])
def test_meshconvert(tmp_path, out, flags):
    src = str(tmp_path / "mesh.ply")
    mesh_io.save_mesh(_grid_mesh(seed=1), src)
    outs = []
    for main, sub in ((jconv.main, "j"), (pconv.main, "p")):
        (tmp_path / sub).mkdir()
        outs.append(run(main, [src, str(tmp_path / sub / out), *flags]))
    assert outs[0] == outs[1]
    assert same_bytes(tmp_path / "j" / out, tmp_path / "p" / out)


def test_meshalign(tmp_path):
    for k in range(2):
        mesh_io.save_mesh(_grid_mesh(n=5, seed=k), str(tmp_path / f"scan{k}.ply"))
    (tmp_path / "align.aln").write_text(
        "# comment\n2\n\nscan0.ply\n1 0 0 0\n0 1 0 0\n0 0 1 0\n0 0 0 1\n"
        "scan1.ply\n0 -1 0 2\n1 0 0 0\n0 0 1 -1\n0 0 0 1\n")
    (tmp_path / "scans.conf").write_text(
        "camera 0 0 0 0 0 0 1\nbmesh scan0.ply 0.5 0 0 0 0 0.3826834 0.9238795\n"
        "bmesh missing.ply 0 0 0 0 0 0 1\nbmesh scan1.ply 0 0 1 0 0 0 1\n")
    inputs = [str(tmp_path / n) for n in ("align.aln", "scans.conf", "scan1.ply")]
    outs = [run(main, [*inputs, str(tmp_path / name)])
            for main, name in ((jalign.main, "j.ply"), (palign.main, "p.ply"))]
    assert outs[0][1].replace("j.ply", "") == outs[1][1].replace("p.ply", "")
    assert same_bytes(tmp_path / "j.ply", tmp_path / "p.ply")


def _legacy_scene(root):
    views = root / "views"
    views.mkdir(parents=True)
    rng = np.random.default_rng(3)
    for k in range(2):
        _write_legacy_view(str(views / f"view_000{k}.mve"),
                           rng.integers(0, 255, (6, 8, 3), np.uint8), b"\x01blob\x00",
                           np.eye(3).ravel(), np.array([0.5, -1.0, 2.0 + k]), 0.85)
    _write_legacy_prebundle(str(root / "prebundle.sfm"), 200, 100,
                            np.array([[10.0, 20.0], [100.0, 50.0]], np.float32),
                            np.array([[255, 0, 0], [0, 255, 0]], np.uint8),
                            np.array([3, -1], np.int32),
                            [(0, 1, np.array([[0, 1], [1, 0]], np.int32))])


@pytest.mark.parametrize("flags", [[], ["-k"]])
def test_sceneupgrade(tmp_path, flags):
    for main, name in ((jup.main, "jax"), (pup.main, "port")):
        _legacy_scene(tmp_path / name)
        assert run(main, [*flags, str(tmp_path / name)])[0] == 0
    assert same_trees(str(tmp_path / "jax"), str(tmp_path / "port"))
    assert os.path.isdir(tmp_path / "port" / "views" / "view_0001.mve")


def test_sceneinspect(scene_dir, tmp_path):
    results = {}
    for pkg, main in (("j", jinsp.main), ("p", pinsp.main)):
        sc = str(tmp_path / pkg / "scene")
        shutil.copytree(scene_dir, sc)
        o = str(tmp_path / pkg)
        dev = ["--device", "cpu"] if pkg == "p" else []
        results[pkg] = [
            run(main, ["info", sc])[1].replace(sc, "S"),
            run(main, ["export", sc, f"{o}/u.png", "--view", "1", "--embedding",
                       "undistorted"])[0],
            run(main, ["export", sc, f"{o}/d.png", "--view", "0", "--embedding", "depth-L0",
                       "--mode", "depth", "--gamma", "1.5"])[0],
            run(main, ["export", sc, f"{o}/d.pfm", "--view", "2", "--embedding", "depth-L0"])[0],
            run(main, ["frusta", sc, f"{o}/f.ply", "--size", "0.2"])[0],
            run(main, ["points", sc, f"{o}/p.ply"])[0],
            run(main, ["dmtriangulate", sc, f"{o}/t.ply", "--view", "1", "--depth", "depth-L0",
                       "--image", "undistorted"])[1].replace(o, "O"),
            run(main, ["report", sc, f"{o}/r.html", *dev])[0],
            run(main, ["delete-embeddings", sc, "--name", "depth-L0", "--views", "0,2"])[1],
        ]
    assert results["p"] == results["j"]
    for name in ("u.png", "d.png", "d.pfm", "f.ply", "p.ply", "t.ply"):
        assert same_bytes(tmp_path / "j" / name, tmp_path / "p" / name), name
    # The report names its scene's path; all else is the same bytes.
    assert (tmp_path / "p" / "r.html").read_text().replace(str(tmp_path / "p"), "") == \
        (tmp_path / "j" / "r.html").read_text().replace(str(tmp_path / "j"), "")
    assert same_trees(str(tmp_path / "j" / "scene"), str(tmp_path / "p" / "scene"))
    assert Scene(str(tmp_path / "p" / "scene")).get_total_mem_usage() == \
        JScene(str(tmp_path / "j" / "scene")).get_total_mem_usage()


def test_prebundle(tmp_path):
    from mve_tpu_torch.sfm.bundler.common import TwoViewMatching, Viewport, save_prebundle

    rng = np.random.RandomState(1)
    vps = []
    for _ in range(3):
        vp = Viewport()
        vp.positions = rng.rand(5, 2).astype(np.float32)
        vp.colors = (rng.rand(5, 3) * 255).astype(np.uint8)
        vps.append(vp)
    matching = [TwoViewMatching(0, 1, np.array([[0, 1], [2, 3]], np.int32)),
                TwoViewMatching(1, 2, np.array([[4, 0]], np.int32))]
    path = str(tmp_path / "prebundle.sfm")
    save_prebundle(vps, matching, path)
    assert run(ppre.main, [path]) == run(jpre.main, [path])
    assert run(ppre.main, [str(tmp_path)]) == run(jpre.main, [str(tmp_path)])
    run(jpre.main, [path, "-g", str(tmp_path / "j.dot")])
    run(ppre.main, [path, "-g", str(tmp_path / "p.dot")])
    assert same_bytes(tmp_path / "j.dot", tmp_path / "p.dot")


def _known_camera_scene(path):
    tex_far = make_texture(seed=7, smooth_sigma=3.0)
    tex_near = make_texture(seed=107, smooth_sigma=3.0)
    scene = JScene.create(path)
    for i, cam in enumerate(make_cameras(4, spread=0.5, seed=7)):
        view = JView.create(scene.view_dir_for_id(i), i)
        view.set_image("undistorted", render_two_plane_view(tex_far, tex_near, cam, 200, 150))
        view.set_camera(cam)
        view.save_view()
        scene.add_view(view)
    return path


def test_featurerecon(tmp_path):
    jpath = _known_camera_scene(str(tmp_path / "jax"))
    ppath = str(tmp_path / "port")
    shutil.copytree(jpath, ppath)
    jfr.feature_reconstruct(jpath, verbose=False)
    assert pfr.main([ppath, "--device", "cpu", "--prebundle", str(tmp_path / "p.sfm")]) == 0
    jb, pb = JScene(jpath).get_bundle(), Scene(ppath).get_bundle()
    assert pb.get_num_cameras() == jb.get_num_cameras() == 4
    for pc, jc in zip(pb.cameras, jb.cameras):
        assert pc.flen == jc.flen
        np.testing.assert_array_equal(pc.rot, jc.rot)
        np.testing.assert_array_equal(pc.trans, jc.trans)
    nj, n = jb.get_num_features(), pb.get_num_features()
    assert nj > 20 and abs(n - nj) <= 0.05 * nj, (n, nj)
    pp, jp = pb.feature_positions(), jb.feature_positions()
    near = np.linalg.norm(pp[:, None] - jp[None], axis=-1).min(axis=1) < 1e-3
    assert near.mean() >= 0.95
    for f in pb.features:     # in front of every camera that sees it
        for ref in f.refs:
            cam = pb.cameras[ref.view_id]
            assert (cam.rot @ f.pos + cam.trans)[2] > 0.0
    # The prebundle it stored loads back and gives the same bundle.
    assert os.path.isfile(tmp_path / "p.sfm")
    again = pfr.feature_reconstruct(ppath, prebundle_path=str(tmp_path / "p.sfm"),
                                    verbose=False, device="cpu")
    np.testing.assert_array_equal(again.feature_positions(), pp)
