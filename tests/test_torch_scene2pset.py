"""The port's scene2pset and depth-map/mesh host code against mve_tpu's,
on the CPU.

Both packages get the same depth maps (the analytic plane depth of
tests/synthetic.py's 5-view scene, with noise, holes and a step); the
point sets must be byte-identical PLYs for every flag combination. The
port keeps mve_tpu's pure-Python fallbacks where mve_tpu calls its native
library, with the vertex classification and the boundary confidences
vectorised in numpy: both are held here to mve_tpu's output exactly.
The bilateral filter runs in torch and agrees to 1e-6 relative.
"""

import numpy as np
import pytest
import torch

from mve_tpu.apps import scene2pset as jax_app
from mve_tpu.core import Scene as JScene
from mve_tpu.core import depthmap as jdmap, mesh_io as jmesh_io
from mve_tpu.core.mesh import MeshInfo as JMeshInfo, TriangleMesh as JMesh

from mve_tpu_torch.apps import scene2pset as app
from mve_tpu_torch.core import depthmap as pdmap, mesh_io as pmesh_io
from mve_tpu_torch.core.mesh import MeshInfo, TriangleMesh

from tests.synthetic import expected_ray_depth, make_plane_scene

torch.set_num_threads(1)


def _depth(cam, w, h, seed):
    rng = np.random.RandomState(seed)
    d = expected_ray_depth(cam, w, h) * (1 + 0.002 * rng.randn(h, w))
    d[rng.rand(h, w) < 0.05] = 0.0            # holes
    d[h // 3:h // 2, w // 4:w // 2] *= 0.8    # a step: discontinuities
    d[: h // 6, : w // 5] = 0.0               # a missing block
    return d.astype(np.float32)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("pset")
    path = str(root / "scene")
    make_plane_scene(path, n_views=5, width=96, height=72)
    sc = JScene(path)
    for i, view in enumerate(sc.get_views()):
        w, h = view.get_image_size("undistorted")
        view.set_image("depth-L0", _depth(view.camera, w, h, i)[:, :, None])
        mask = np.full((h, w, 1), 255, np.uint8)
        mask[:, : w // 3] = 0
        view.set_image("mask", mask)
        view.save_view()
    return path


CASES = {
    "fssr": ["-F0"],
    "plain": [],
    "normals_conf": ["-n", "-c"],
    "poisson": ["-p", "-c", "-s", "-S", "1.5"],
    "bbox_views": ["-F0", "--bounding-box=-1,-1,0,1,1,10", "-v", "0,2,4"],
    "mask_fraction": ["-F0", "-m", "mask", "-f", "0.5"],
    "correspondence": ["-n", "-C"],
    "shard": ["-F0", "--num-processes", "2", "--process-id", "1"],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_point_sets_identical(scene, tmp_path, case):
    out_j, out_p = str(tmp_path / "jax.ply"), str(tmp_path / "port.ply")
    jax_app.main([scene, out_j] + CASES[case])
    assert app.main([scene, out_p, "--device", "cpu"] + CASES[case]) == 0
    a, b = open(out_j, "rb").read(), open(out_p, "rb").read()
    assert a == b and len(a) > 200
    if case == "correspondence":
        for suffix in ("_correspondence-data.csv", "_correspondence-metadata.csv"):
            assert open(out_j + suffix).read() == open(out_p + suffix).read()
    # Each package reads the other's PLY.
    pm, jm = pmesh_io.load_mesh(out_j), jmesh_io.load_mesh(out_p)
    assert pm.num_vertices() == jm.num_vertices() > 0
    for attr in ("vertices", "vertex_normals", "vertex_confidences", "vertex_values"):
        assert np.array_equal(getattr(pm, attr), getattr(jm, attr)), attr


def test_fssr_point_set_attributes(scene, tmp_path):
    out = str(tmp_path / "pset.ply")
    merged = app.scene_to_pointset(scene, out, dmname="depth-L0", image="undistorted",
                                   with_normals=True, with_scale=True, with_conf=True,
                                   verbose=False, device="cpu")
    mesh = pmesh_io.load_mesh(out)
    n = merged.num_vertices()
    assert mesh.num_vertices() == n > 1000
    assert mesh.vertex_normals.shape == (n, 3) and mesh.vertex_values.shape == (n,)
    assert mesh.vertex_confidences.shape == (n,)
    assert set(np.unique(mesh.vertex_confidences)) <= {0.0, 0.25, 0.5, 0.75, 1.0}


def _meshes():
    """Triangulated depth maps plus small meshes with degenerate, complex
    and border vertices."""
    rng = np.random.RandomState(0)
    out = []
    for seed in range(3):
        d = (4.0 + rng.rand(40, 50) * (0.3 if seed else 3.0)).astype(np.float32)
        d[rng.rand(40, 50) < 0.1 * seed] = 0.0
        invproj = np.linalg.inv(np.array([[45.0, 0, 25], [0, 45.0, 20], [0, 0, 1]]))
        mesh, _ = jdmap.depthmap_triangulate(d, invproj, 5.0)
        out.append((mesh.vertices, mesh.faces))
    fan = np.array([[0, 1, 2], [0, 2, 3], [0, 3, 4], [0, 4, 1],    # closed fan: simple 0
                    [5, 6, 7], [5, 7, 8],                          # open fan: border 5
                    [9, 10, 11], [9, 11, 10],                      # opposite windings
                    [12, 12, 13], [12, 13, 14],                    # degenerate face
                    [15, 16, 17], [15, 18, 19], [15, 19, 20]],     # two fans at 15
                   np.int32)
    out.append((rng.rand(22, 3).astype(np.float32), fan))           # 21 unreferenced
    return out


@pytest.mark.parametrize("which", range(4))
def test_mesh_classes_and_boundary_confidences(which):
    verts, faces = _meshes()[which]
    jm, pm = JMesh(), TriangleMesh()
    for m in (jm, pm):
        m.vertices, m.faces = verts.copy(), faces.copy()
    assert np.array_equal(MeshInfo(pm).vclass, JMeshInfo(jm).vclass)
    for it in (1, 3, 4):
        jdmap.depthmap_mesh_confidences(jm, it)
        pdmap.depthmap_mesh_confidences(pm, it)
        assert np.array_equal(pm.vertex_confidences, jm.vertex_confidences)


@pytest.mark.parametrize("seed", [0, 1])
def test_depthmap_host_functions_identical(seed):
    rng = np.random.RandomState(seed)
    d = (3.0 + rng.rand(30, 40)).astype(np.float32)
    d[rng.rand(30, 40) < 0.2] = 0.0
    conf = rng.rand(30, 40).astype(np.float32)
    invproj = np.linalg.inv(np.array([[35.0, 0, 20], [0, 35.0, 15], [0, 0, 1]]))
    color = rng.randint(0, 255, (30, 40, 3)).astype(np.uint8)
    jm, jidx = jdmap.depthmap_triangulate(d, invproj, 5.0, color_image=color)
    pm, pidx = pdmap.depthmap_triangulate(d, invproj, 5.0, color_image=color)
    assert np.array_equal(jidx, pidx)
    for attr in ("vertices", "faces", "vertex_colors"):
        assert np.array_equal(getattr(jm, attr), getattr(pm, attr)), attr
    for fn, args in (("depthmap_cleanup", (d, 8)), ("depthmap_confidence_clean", (d, conf, 0.5)),
                     ("depthmap_convert_conventions", (d, invproj, True)),
                     ("pixel_footprint", (d, invproj)), ("pixel_3dpos", (d, invproj))):
        assert np.array_equal(getattr(jdmap, fn)(*args), getattr(pdmap, fn)(*args)), fn
    jdmap.depthmap_mesh_peeling(jm, 2)
    pdmap.depthmap_mesh_peeling(pm, 2)
    assert np.array_equal(jm.faces, pm.faces) and np.array_equal(jm.vertices, pm.vertices)


def test_bilateral_filter():
    rng = np.random.RandomState(3)
    d = (2.0 + rng.rand(33, 47)).astype(np.float32)
    d[rng.rand(33, 47) < 0.15] = 0.0
    for gc, pc in ((2.0, 0.01), (1.0, 0.1)):
        want = jdmap.depthmap_bilateral_filter(d, gc, pc)
        got = pdmap.depthmap_bilateral_filter(d, gc, pc, device="cpu")
        assert got.dtype == want.dtype and np.array_equal(got > 0, want > 0)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_scene2pset_defaults_to_the_card(scene, tmp_path):
    if torch.cuda.is_available():
        return  # the default device is legitimate where a card exists
    out = tmp_path / "pset.ply"
    with pytest.raises(RuntimeError, match="CUDA"):
        app.main([scene, str(out), "-F0"])
    with pytest.raises(RuntimeError, match="CUDA"):
        app.scene_to_pointset(scene, str(out))
    assert not out.exists()
