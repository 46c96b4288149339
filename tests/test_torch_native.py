"""The port's native host library (mve_tpu_torch/native) against its
Python fallbacks and against mve_tpu's binding, on the CPU: all six
functions give identical results. The influence pairs and the scale
filter come in another order from the native code than from the Python
grid hashing, so those are compared as sets of (voxel, sample) pairs.
"""

import numpy as np
import pytest
import torch

from mve_tpu import native as jnative
from mve_tpu.core.mesh import MeshInfo as JMeshInfo
from mve_tpu.core.mesh import TriangleMesh as JMesh
from mve_tpu.core import mesh_tools as jmesh_tools

from mve_tpu_torch import native
from mve_tpu_torch.core import depthmap as pdepthmap
from mve_tpu_torch.core import mesh_tools as pmesh_tools
from mve_tpu_torch.core.mesh import MeshInfo as PMeshInfo
from mve_tpu_torch.core.mesh import TriangleMesh as PMesh
from mve_tpu_torch.fssr import basis as pbasis
from mve_tpu_torch.fssr import mesh_clean as pclean
from mve_tpu_torch.fssr.iso_octree import IsoOctree

from tests.test_torch_fssr import hemispheres, sphere

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def lib():
    lib = native.get_lib()
    if lib is None or jnative.get_lib() is None:
        pytest.skip("no C++ compiler: both packages take their Python fallbacks")
    return lib


def _ragged_grid(n=24, seed=0):
    """A grid with holes, a bow-tie vertex, a repeated face, a flipped
    face and an unreferenced vertex: every vertex class of mesh_info.cc."""
    rng = np.random.RandomState(seed)
    ys, xs = np.mgrid[0:n, 0:n].astype(np.float64)
    verts = np.stack([xs, ys, 0.1 * rng.randn(n, n)], -1).reshape(-1, 3)
    idx = np.arange(n * n).reshape(n, n)
    a, b, c, d = idx[:-1, :-1].ravel(), idx[:-1, 1:].ravel(), idx[1:, :-1].ravel(), idx[1:, 1:].ravel()
    faces = np.concatenate([np.stack([a, b, d], 1), np.stack([a, d, c], 1)])
    faces = faces[rng.rand(len(faces)) > 0.15]                  # holes
    extra = np.array([[0, n + 1, 2 * n + 5], faces[10], faces[20][::-1]])
    faces = np.concatenate([faces, extra])
    verts = np.concatenate([verts, [[99.0, 99.0, 99.0]]])       # unreferenced
    return verts.astype(np.float32), faces.astype(np.int32)


def _both(verts, faces):
    out = []
    for cls in (JMesh, PMesh):
        m = cls()
        m.vertices, m.faces = verts.copy(), faces.copy()
        out.append(m)
    return out


def test_library_builds_outside_the_package(lib):
    path = native.library_path()
    assert path.is_file() and path.parent == native.BUILD_DIR
    assert native.BUILD_DIR.parts[-2:] == ("build", "mve_tpu_torch")
    assert not list(native.SOURCE.parent.glob("*.so"))


@pytest.mark.parametrize("seed", [0, 1])
def test_classify_vertices(lib, seed, monkeypatch):
    verts, faces = _ragged_grid(seed=seed)
    jm, pm = _both(verts, faces)
    got = native.classify_vertices(len(verts), faces)
    assert set(np.unique(got)) == {0, 1, 2, 3}
    np.testing.assert_array_equal(got, jnative.classify_vertices(len(verts), faces))
    np.testing.assert_array_equal(PMeshInfo(pm).vclass, got)
    np.testing.assert_array_equal(JMeshInfo(jm).vclass, got)
    monkeypatch.setattr(native, "get_lib", lambda: None)
    np.testing.assert_array_equal(PMeshInfo(pm).vclass, got)


def test_components(lib, monkeypatch):
    verts, faces = _ragged_grid(seed=2)
    faces = faces[np.random.RandomState(3).rand(len(faces)) > 0.4]   # many components
    jm, pm = _both(verts, faces)
    got = native.components(len(verts), faces)
    assert len(np.unique(got)) > 5
    np.testing.assert_array_equal(got, jnative.components(len(verts), faces))
    np.testing.assert_array_equal(pmesh_tools.mesh_components(pm), got)
    np.testing.assert_array_equal(jmesh_tools.mesh_components(jm), got)
    monkeypatch.setattr(native, "get_lib", lambda: None)
    np.testing.assert_array_equal(pmesh_tools.mesh_components(pm), got)


def test_collapse_edges(lib):
    verts, faces = _ragged_grid(seed=4)
    rng = np.random.RandomState(5)
    edges = faces[rng.randint(0, len(faces), 300)][:, :2].astype(np.int64)
    count, target, new = native.collapse_edges(verts, edges)
    jcount, jtarget, jnew = jnative.collapse_edges(verts, edges)
    assert count == jcount > 50
    np.testing.assert_array_equal(target, jtarget)
    np.testing.assert_array_equal(new, jnew)
    _, pm = _both(verts, faces)
    pcount, ptarget = pclean._collapse_edges_python(pm, edges)
    assert pcount == count
    np.testing.assert_array_equal(ptarget, target)
    np.testing.assert_array_equal(pm.vertices, new)


@pytest.mark.parametrize("path", ["native", "python"])
@pytest.mark.parametrize("iterations", [1, 3])
def test_boundary_confidences(lib, iterations, path, monkeypatch):
    verts, faces = _ragged_grid(seed=6)
    jm, pm = _both(verts, faces)
    vclass = JMeshInfo(jm).vclass
    want = jnative.boundary_confidences(len(verts), faces, vclass, iterations)
    assert len(np.unique(want)) == iterations + 1
    np.testing.assert_array_equal(
        native.boundary_confidences(len(verts), faces, vclass, iterations), want)
    if path == "python":
        monkeypatch.setattr(native, "get_lib", lambda: None)
    pdepthmap.depthmap_mesh_confidences(pm, iterations)
    np.testing.assert_array_equal(pm.vertex_confidences, want)


def _pairs_inputs(make):
    _, ps = make()
    iso = IsoOctree()
    positions = iso._build_voxel_set(ps)[-1]
    return positions, ps.pos.astype(np.float64), ps.scale.astype(np.float64)


def _as_set(pv, ps):
    return set(zip(pv.tolist(), ps.tolist()))


@pytest.mark.parametrize("make", [sphere, hemispheres])
def test_influence_pairs_and_scale_filter(lib, make):
    positions, pos, scale = _pairs_inputs(make)
    pv, ps = native.fssr_influence_pairs(positions, pos, scale)
    jv, js = jnative.fssr_influence_pairs(positions, pos, scale)
    np.testing.assert_array_equal(pv, jv)
    np.testing.assert_array_equal(ps, js)
    h = float(np.median(scale))
    fv, fs = IsoOctree._influence_pairs(positions, pos, scale, h)
    assert len(fv) == len(pv) > 10_000
    assert _as_set(fv, fs) == _as_set(pv, ps)
    kv, ks = native.fssr_scale_filter(pv, ps, scale, len(positions))
    np.testing.assert_array_equal(np.diff(kv) >= 0, True)          # grouped by voxel
    jkv, jks = jnative.fssr_scale_filter(pv, ps, scale, len(positions))
    np.testing.assert_array_equal(kv, jkv)
    np.testing.assert_array_equal(ks, jks)
    tv, ts, tk = (a.numpy() for a in pbasis.scale_filter_pairs(
        torch.from_numpy(scale.astype(np.float32)), torch.from_numpy(pv), torch.from_numpy(ps),
        len(positions)))
    assert len(kv) < len(pv) or make is sphere
    assert _as_set(tv[tk], ts[tk]) == _as_set(kv, ks)


def test_bindings_check_indices(lib):
    with pytest.raises(ValueError):
        native.components(3, np.array([[0, 1, 3]]))
    with pytest.raises(ValueError):
        native.collapse_edges(np.zeros((3, 3), np.float32), np.array([[0, 5]]))
    with pytest.raises(ValueError):
        native.fssr_scale_filter(np.array([0, 2]), np.array([0, 0]), np.ones(1), 2)
