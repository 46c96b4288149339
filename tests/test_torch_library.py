"""The port's library modules that no app calls against mve_tpu's, on the
CPU: colour conversions, triangle geometry and intersection tests (torch
functions), curves, volumes and marching cubes (numpy copies), and the
matching helpers count_consistent_matches and combine_results, and
Bundle.get_features_as_mesh.

Inputs are seeded numpy arrays, float32 for the torch functions (mve_tpu
computes in float32 without x64). Limits: the torch functions within
1e-6 of mve_tpu, relative where a value's magnitude is above 1 and
absolute below it, hit masks equal (pow and the order of three-term sums
round apart by an ulp or so); a colour conversion within 1e-6 of each
channel's largest magnitude, because XLA's float32 cube root is an ulp
off the correctly rounded one at about 1% of the inputs (the port's is
correctly rounded) and Lab's a* and b* are 500 and 200 times a
difference of two cube roots (measured: 3.1e-5 apart in an a* of -22.4,
3.3e-7 of the channel's largest); the numpy copies exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mve_tpu.core import bundle as jbundle
from mve_tpu.core import image_color as jcolor
from mve_tpu.core import marching_cubes as jmc
from mve_tpu.core import volume as jvolume
from mve_tpu.math import curve as jcurve
from mve_tpu.math import geometry as jgeom
from mve_tpu.math import intersect as jisect
from mve_tpu.sfm import matching as jmatching

from mve_tpu_torch.core import bundle as pbundle
from mve_tpu_torch.core import image_color as pcolor
from mve_tpu_torch.core import marching_cubes as pmc
from mve_tpu_torch.core import volume as pvolume
from mve_tpu_torch.math import curve as pcurve
from mve_tpu_torch.math import geometry as pgeom
from mve_tpu_torch.math import intersect as pisect
from mve_tpu_torch.sfm import matching as pmatching

torch.set_num_threads(1)


def _close(got, want, tol=1e-6, per_channel=False):
    """|got - want| within tol of max(1, |want|), or with per_channel of
    max(1, the largest |want| of its last-axis channel)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    mag = np.abs(want).reshape(-1, want.shape[-1]).max(axis=0) if per_channel else np.abs(want)
    err = np.abs(got - want) / np.maximum(1.0, mag)
    assert err.max() <= tol, err.max()


def _both(jfn, pfn, *arrays):
    """(mve_tpu's outputs, the port's) of one call on float32 arrays,
    each as a tuple of numpy arrays."""
    want = jfn(*(jnp.asarray(a) for a in arrays))
    got = pfn(*(torch.from_numpy(np.array(a)) for a in arrays))
    as_tuple = lambda x: x if isinstance(x, tuple) else (x,)
    return ([np.asarray(w) for w in as_tuple(want)],
            [g.numpy() for g in as_tuple(got)])


def _rgb(n=257, seed=3):
    rgb = np.random.RandomState(seed).rand(n, 3).astype(np.float32)
    rgb[:3] = [[0, 0, 0], [1, 1, 1], [0.04045, 0.0031308, 0.5]]  # branch edges
    return rgb


COLOR = ["srgb_to_linear", "linear_to_srgb", "rgb_to_xyz", "xyz_to_rgb", "xyz_to_lab",
         "lab_to_xyz", "rgb_to_ycbcr", "ycbcr_to_rgb"]


def _color_input(name):
    rgb = _rgb()
    if name in ("xyz_to_rgb", "xyz_to_lab"):
        return np.asarray(jcolor.rgb_to_xyz(rgb), np.float32)
    if name == "lab_to_xyz":
        return np.asarray(jcolor.xyz_to_lab(jcolor.rgb_to_xyz(rgb)), np.float32)
    if name == "ycbcr_to_rgb":
        return np.asarray(jcolor.rgb_to_ycbcr(rgb), np.float32)
    return rgb


@pytest.mark.parametrize("name", COLOR)
def test_color_conversions(name):
    (want,), (got,) = _both(getattr(jcolor, name), getattr(pcolor, name), _color_input(name))
    assert got.dtype == np.float32
    _close(got, want, per_channel=True)


def test_color_round_trips_and_reference_points():
    """tests/test_color_drawing_curves.py's checks, on the port."""
    rgb = torch.from_numpy(_rgb())
    assert torch.allclose(pcolor.linear_to_srgb(pcolor.srgb_to_linear(rgb)), rgb, atol=1e-6)
    assert torch.allclose(pcolor.xyz_to_rgb(pcolor.rgb_to_xyz(rgb)), rgb, atol=1e-6)
    xyz = pcolor.rgb_to_xyz(rgb)
    assert torch.allclose(pcolor.lab_to_xyz(pcolor.xyz_to_lab(xyz)), xyz, atol=1e-5)
    assert torch.allclose(pcolor.ycbcr_to_rgb(pcolor.rgb_to_ycbcr(rgb)), rgb, atol=1e-5)
    lab = pcolor.xyz_to_lab(pcolor.rgb_to_xyz(torch.ones(1, 3)))
    assert abs(lab[0, 0] - 100.0) < 1e-3 and abs(lab[0, 1]) < 0.5 and abs(lab[0, 2]) < 0.5
    black = torch.zeros(1, 3)
    assert abs(pcolor.xyz_to_lab(pcolor.rgb_to_xyz(black))[0, 0]) < 1e-6
    assert abs(pcolor.rgb_to_ycbcr(black)[0, 0]) < 1e-6


def _triangles(n=500, seed=5):
    rng = np.random.RandomState(seed)
    v = rng.randn(3, n, 3).astype(np.float32)
    v[:, 0] = [[0, 0, 0], [1, 0, 0], [2, 0, 0]]   # a degenerate triangle
    return v


GEOMETRY = [("triangle_normal", {}), ("triangle_normal", {"normalize": False}),
            ("triangle_area", {}), ("triangle_circumradius", {})]


@pytest.mark.parametrize("name,kw", GEOMETRY)
def test_geometry(name, kw):
    v0, v1, v2 = _triangles()
    (want,), (got,) = _both(lambda *a: getattr(jgeom, name)(*a, **kw),
                            lambda *a: getattr(pgeom, name)(*a, **kw), v0, v1, v2)
    _close(got, want)


def test_normalize():
    v = np.random.RandomState(6).randn(300, 3).astype(np.float32)
    v[0] = 0.0
    (want,), (got,) = _both(jgeom.normalize, pgeom.normalize, v)
    _close(got, want)
    (want,), (got,) = _both(lambda a: jgeom.normalize(a, axis=0),
                            lambda a: pgeom.normalize(a, axis=0), v)
    _close(got, want)


def _rays(n=2000, seed=7):
    rng = np.random.RandomState(seed)
    origin = (rng.rand(n, 3) * 4 - 2).astype(np.float32)
    direction = rng.randn(n, 3).astype(np.float32)
    direction[:3] = [[0, 0, 1], [1, 0, 0], [0, 0, -1]]  # axis-parallel rays
    return origin, direction


def test_ray_box():
    origin, direction = _rays()
    box = (np.float32([-0.5, -0.25, 0.0]), np.float32([0.75, 1.0, 0.5]))
    want, got = _both(lambda o, d: jisect.ray_box(o, d, *box),
                      lambda o, d: pisect.ray_box(o, d, *(torch.from_numpy(b) for b in box)),
                      origin, direction)
    assert np.array_equal(got[0], want[0]) and 0 < got[0].sum() < len(origin)
    for g, w in zip(got[1:], want[1:]):
        _close(g, w)


def test_ray_triangle():
    origin, direction = _rays()
    v = np.random.RandomState(8).randn(3, len(origin), 3).astype(np.float32) * 0.5
    v[:, :, 2] -= 1.0
    origin[:, 2] = 1.0
    direction[:, 2] = -np.abs(direction[:, 2]) - 0.5
    want, got = _both(jisect.ray_triangle, pisect.ray_triangle, origin, direction, *v)
    assert np.array_equal(got[0], want[0]) and 0 < got[0].sum() < len(origin)
    for g, w in zip(got[1:], want[1:]):
        _close(g, w)


def test_point_in_box():
    p = (np.random.RandomState(9).rand(1000, 3) * 2 - 0.5).astype(np.float32)
    p[0], p[1] = 0.0, 1.0  # on the faces: inclusive
    lo, hi = np.zeros(3, np.float32), np.ones(3, np.float32)
    (want,), (got,) = _both(lambda a: jisect.point_in_box(a, lo, hi),
                            lambda a: pisect.point_in_box(a, torch.from_numpy(lo),
                                                          torch.from_numpy(hi)), p)
    assert np.array_equal(got, want) and got[0] and got[1] and 0 < got.sum() < len(p)


def test_curves():
    cp = np.random.RandomState(10).rand(8, 3)
    t = np.linspace(0, 1, 33)
    for name in ("bezier", "bspline_uniform_cubic"):
        want = getattr(jcurve, name)(cp, t)
        got = getattr(pcurve, name)(cp, t)
        assert np.array_equal(got, want)
    assert np.array_equal(pcurve.bezier(cp[:4], 0.5), jcurve.bezier(cp[:4], 0.5))


def _sphere(n=24, r=0.35):
    zz, yy, xx = np.mgrid[0:n, 0:n, 0:n] / (n - 1.0)
    return (np.sqrt((xx - 0.5) ** 2 + (yy - 0.5) ** 2 + (zz - 0.5) ** 2) - r).astype(np.float32)


def _random_volume(seed):
    d = np.random.default_rng(seed).standard_normal((10, 10, 10)).astype(np.float32)
    return np.pad(d, 1, constant_values=2.0)


VOLUMES = {"sphere": _sphere, "sphere_16": lambda: _sphere(16, 0.3),
           "random_11": lambda: _random_volume(11), "random_12": lambda: _random_volume(12)}


def _same_mesh(a, b):
    assert np.array_equal(a.vertices, b.vertices) and np.array_equal(a.faces, b.faces)


@pytest.mark.parametrize("name", sorted(VOLUMES))
def test_marching_cubes_and_tets(name):
    data = VOLUMES[name]()
    jv, pv = jvolume.Volume(data), pvolume.Volume(data)
    mesh = pmc.marching_cubes(pv)
    assert mesh.num_faces() > 0
    _same_mesh(mesh, jmc.marching_cubes(jv))
    _same_mesh(pvolume.marching_tets(pv, iso=0.1), jvolume.marching_tets(jv, iso=0.1))
    assert np.array_equal(pmc.MC_TRI_TABLE, jmc.MC_TRI_TABLE)


def test_marching_cubes_accessor():
    vals = _sphere(12, 0.3)
    Z, Y, X = vals.shape

    class DenseAccessor:
        def __init__(self):
            self.it = iter(np.ndindex(Z - 1, Y - 1, X - 1))
            self.sdf = np.zeros(8)
            self.vid = np.zeros(8, np.int64)
            self.pos = np.zeros((8, 3))

        def next(self):
            try:
                z, y, x = next(self.it)
            except StopIteration:
                return False
            for i in range(8):
                dx, dy, dz = i & 1, (i >> 1) & 1, (i >> 2) & 1
                self.sdf[i] = vals[z + dz, y + dy, x + dx]
                self.vid[i] = ((z + dz) * Y + (y + dy)) * X + (x + dx)
                self.pos[i] = ((x + dx) / (X - 1.0), (y + dy) / (Y - 1.0), (z + dz) / (Z - 1.0))
            return True

    got = pmc.marching_cubes_accessor(DenseAccessor())
    assert got.num_faces() == pmc.marching_cubes(pvolume.Volume(vals)).num_faces() > 0
    _same_mesh(got, jmc.marching_cubes_accessor(DenseAccessor()))


def test_matching_helpers():
    rng = np.random.RandomState(12)

    def result(n1, n2):
        m12 = np.where(rng.rand(n1) < 0.7, rng.randint(0, n2, n1), -1).astype(np.int32)
        m21 = np.where(rng.rand(n2) < 0.7, rng.randint(0, n1, n2), -1).astype(np.int32)
        m21[m12[m12 >= 0][:5]] = np.nonzero(m12 >= 0)[0][:5]  # a few mutual pairs
        return m12, m21

    sift, surf = result(40, 30), result(25, 35)
    for m12, m21 in (sift, surf):
        want = jmatching.count_consistent_matches(jmatching.MatchingResult(m12, m21))
        got = pmatching.count_consistent_matches(pmatching.MatchingResult(m12, m21))
        assert got == want >= 5
    want = jmatching.combine_results(jmatching.MatchingResult(*sift),
                                     jmatching.MatchingResult(*surf), 30, 40, 30)
    got = pmatching.combine_results(pmatching.MatchingResult(*sift),
                                    pmatching.MatchingResult(*surf), 30, 40, 30)
    assert np.array_equal(got.matches_1_2, want.matches_1_2)
    assert np.array_equal(got.matches_2_1, want.matches_2_1)
    assert got.matches_1_2.dtype == np.int32


@pytest.mark.parametrize("n", [0, 37])
def test_bundle_features_as_mesh(n):
    """The same features give identical vertex and RGBA colour arrays,
    float32, alpha 1, and no faces."""
    rng = np.random.RandomState(n)
    pos, col = rng.randn(n, 3), rng.rand(n, 3)

    def mesh(mod):
        b = mod.Bundle()
        b.features = [mod.Feature3D(p, c) for p, c in zip(pos, col)]
        return b.get_features_as_mesh()

    want, got = mesh(jbundle), mesh(pbundle)
    for key in ("vertices", "vertex_colors", "faces"):
        a, b = getattr(want, key), getattr(got, key)
        assert a.dtype == b.dtype and np.array_equal(a, b), key
    assert got.vertices.shape == (n, 3) and got.vertex_colors.shape == (n, 4)
    assert got.vertex_colors.dtype == np.float32 and np.all(got.vertex_colors[:, 3] == 1)
    assert got.num_faces() == 0
