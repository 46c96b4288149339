"""The port's MVS modules (mve_tpu_torch/mvs) against mve_tpu's, on the CPU.

Host copies (view preparation, sparse fill, pyramid level, global view
selection, rectification) must be identical. Device primitives get the
same seeded inputs in both packages; they agree to 1e-5 absolute, and
many bit for bit: the port rounds as XLA's CPU code rounds mve_tpu's
(mve_tpu_torch/mvs/patch.py). Where the NCC is computed from warped
samples, XLA fuses the projection's multiply-adds in a way that depends
on the surrounding program and the port matches it only in part: warped
coordinates agree to 1e-6 relative, and the NCC, whose variance terms
cancel, to 1e-4 (measured at most 3.8e-5). The sweep cubes and tables
agree within two bf16 ulps at 1.0 (measured 2^-6 on some cube entries)
on about 1% of the entries and are otherwise identical; given mve_tpu's
cube the table is bit-identical, and the table lookup is bit-identical
given the same table.

Whole solvers run on the 5-view 96x72 plane scene of tests/synthetic.py,
and on a forward-motion scene whose pairs do not rectify (the warp
solver in both packages). Tolerances: fill within 0.005 of mve_tpu's per
view; median relative depth difference on pixels both accept at most
1e-3 for the warp solver, and at most 2e-3 for the sweep solver. The
sweep solver's bound is wider than 1e-3 because the solver itself is
that sensitive: its PatchMatch picks and parabolic steps turn one-ulp
differences (exp and arccos in view selection, fused roundings XLA picks
per expression) into moves of a polish step. Measured here: 1.1e-3 and
1.5e-3 on the plane and tilted-plane scenes' view 0, and the port's own
result moves by a median 9.4e-4 when its seed depth map changes by one
ulp.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mve_tpu.core import CameraInfo as JCamera, Scene as JScene, View as JView
from mve_tpu.core.bundle import Bundle as JBundle, Feature2D as JF2, Feature3D as JF3
from mve_tpu.mvs import dmrecon as jdm, patch as jpatch, pyramid as jpyr
from mve_tpu.mvs import solver as jsolver, sweep_solver as jsweep
from mve_tpu.mvs import view_selection as jvs
from mve_tpu.mvs.settings import Settings as JSettings

from mve_tpu_torch.core import Scene
from mve_tpu_torch.interop import mvs_settings_from_dict
from mve_tpu_torch.mvs import dmrecon as pdm, patch as ppatch, pyramid as ppyr
from mve_tpu_torch.mvs import solver as psolver, sweep_solver as psweep
from mve_tpu_torch.mvs import view_selection as pvs

from tests.synthetic import PLANE_Z, make_plane_scene, make_texture, render_view
from tests.torch_legacy_grid import legacy_grid

# Test workers run side by side: one intra-op thread each.
torch.set_num_threads(1)

FW = 5


def T(a):
    return torch.from_numpy(np.array(a))


def N(t):
    return np.asarray(t)


def make_forward_scene(path):
    """Cameras along +z toward the plane: the pairs' baselines run along
    the viewing direction and cannot rectify (the scene of
    tests/test_sweep_solver.py's fallback test)."""
    tex = make_texture(seed=5)
    scene = JScene.create(path)
    cams = []
    for i in range(5):
        cam = JCamera()
        cam.flen = 0.9
        cam.rot = np.eye(3, dtype=np.float32)
        center = np.array([0.0, 0.0, 0.35 * i], np.float64)
        cam.trans = (-cam.rot.astype(np.float64) @ center).astype(np.float32)
        cams.append(cam)
        view = JView.create(scene.view_dir_for_id(i), i)
        view.set_image("undistorted", render_view(tex, cam, 96, 72))
        view.set_camera(cam)
        view.save_view()
        scene.add_view(view)
    scene.save_views()
    bundle = JBundle()
    bundle.cameras = cams
    rng = np.random.RandomState(0)
    for pi in range(60):
        p = np.array([rng.uniform(-1.5, 1.5), rng.uniform(-1.1, 1.1), PLANE_Z])
        refs = []
        for vi, cam in enumerate(cams):
            pc = cam.rot.astype(np.float64) @ p + cam.trans
            refs.append(JF2(vi, pi, (pc[:2] / pc[2] * cam.flen).astype(np.float32)))
        bundle.features.append(JF3(p.astype(np.float32), np.full(3, 0.5, np.float32), refs))
    scene.set_bundle(bundle)
    scene.save_scene()


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    root = tmp_path_factory.mktemp("mvs")
    make_plane_scene(str(root / "plane"), n_views=5, width=96, height=72)
    make_forward_scene(str(root / "forward"))
    return root


SMALL = dict(num_sweep_planes=8, num_propagation_iters=2, num_refine_steps=1,
             max_iterations=4)


def _prepare(dm, scene_cls, settings, path, vid):
    scene = scene_cls(path)
    views = scene.get_views()
    bundle = scene.get_bundle()
    vis = dm._feature_visibility(bundle, len(views), settings.aabb_min, settings.aabb_max)
    sizes = [v.get_image_size(settings.image_embedding) for v in views]
    return dm._prepare_view(scene, dataclasses.replace(settings, ref_view_nr=vid), views,
                            bundle.feature_positions(), vis, sizes, vid)


def _both(path, vids, **kw):
    js = JSettings(scale=0, quiet=True, **kw)
    ps = mvs_settings_from_dict(dataclasses.asdict(js))
    jp = [_prepare(jdm, JScene, js, path, v) for v in vids]
    pp = [_prepare(pdm, Scene, ps, path, v) for v in vids]
    return js, jp, ps, pp


@pytest.fixture(scope="module")
def plane_prep(scenes):
    return _both(str(scenes / "plane"), [0, 2])


# ---------------------------------------------------------------------------
# host copies: identical
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", [0, 1])
def test_prepare_view_identical(plane_prep, which):
    _, jp, _, pp = plane_prep
    j, p = jp[which], pp[which]
    assert set(j) == set(p)
    for key in j:
        if key == "neigh":
            assert all(np.array_equal(a, b) for a, b in zip(j[key], p[key]))
        elif key == "rect":
            for a, b in zip(j[key], p[key]):
                assert set(a) == set(b)
                for f in a:
                    assert np.array_equal(np.asarray(a[f]), np.asarray(b[f])), f
        else:
            assert np.array_equal(np.asarray(j[key]), np.asarray(p[key])), key


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fill_sparse_identical(seed):
    rng = np.random.RandomState(seed)
    H, W = 37 + seed, 53 - seed
    depth = rng.uniform(1, 5, (H, W))
    mask = rng.rand(H, W) < (0.02 if seed else 0.0005)
    mask[0, 0] = True
    depth = np.where(mask, depth, 0.0)
    assert np.array_equal(jdm._fill_sparse(depth, mask), pdm._fill_sparse(depth, mask))


@pytest.mark.parametrize("shape", [(36, 48), (37, 49, 3), (1, 5)])
def test_half_size_gaussian_identical(shape):
    img = np.random.RandomState(3).rand(*shape).astype(np.float32)
    assert np.array_equal(jpyr.half_size_gaussian_np(img), ppyr.half_size_gaussian_np(img))


def test_global_view_selection_identical(scenes):
    scene = JScene(str(scenes / "plane"))
    views = scene.get_views()
    bundle = scene.get_bundle()
    s = JSettings()
    vis = jdm._feature_visibility(bundle, len(views), s.aabb_min, s.aabb_max)
    sizes = [v.get_image_size("undistorted") for v in views]
    cams = [v.camera for v in views]
    pcams = [v.camera for v in Scene(str(scenes / "plane")).get_views()]
    for ref in range(len(views)):
        for max_views in (2, 20):
            a = jvs.global_view_selection(bundle.feature_positions(), vis, cams, sizes, ref,
                                          max_views=max_views)
            b = pvs.global_view_selection(bundle.feature_positions(), vis, pcams, sizes, ref,
                                          max_views=max_views)
            assert a == b


def _random_pair(seed):
    from mve_tpu.math.rotation import rodrigues_to_matrix

    rng = np.random.RandomState(seed)
    W, H, f = 64, 48, 0.9
    K = np.array([[f * W, 0, W / 2.0], [0, f * W, H / 2.0], [0, 0, 1.0]])
    R_j = rodrigues_to_matrix(rng.randn(3) * 0.05)
    C_j = np.array([0.6, 0.1, 0.0]) + rng.randn(3) * 0.05
    return K, np.eye(3), np.zeros(3), K, np.asarray(R_j), -np.asarray(R_j) @ C_j, (W, H)


@pytest.mark.parametrize("seed,legacy", [(0, False), (1, False), (2, False), (3, False),
                                         (0, True), (1, True)],
                         ids=["0", "1", "2", "3", "margin-0", "margin-1"])
def test_rectify_pair_identical(seed, legacy):
    """The fitted grid (image_wh) and the legacy fixed margins
    (margin_yx = rect_margins, rect_wh None)."""
    args = _random_pair(seed)
    if legacy:
        W, H = args[6]
        assert psweep.rect_margins(H, W) == jsweep.rect_margins(H, W) == (6, 8)
        a = jsweep.rectify_pair(*args[:6], margin_yx=jsweep.rect_margins(H, W))
        b = psweep.rectify_pair(*args[:6], margin_yx=psweep.rect_margins(H, W))
        assert a["rect_wh"] is b["rect_wh"] is None
    else:
        a = jsweep.rectify_pair(*args[:6], image_wh=args[6])
        b = psweep.rectify_pair(*args[:6], image_wh=args[6])
    assert set(a) == set(b)
    for key in a:
        assert np.array_equal(np.asarray(a[key]), np.asarray(b[key])), key
    K = np.array([[60.0, 0, 32], [0, 60.0, 24], [0, 0, 1]])
    assert psweep.rectify_pair(K, np.eye(3), np.zeros(3), K, np.eye(3),
                               np.array([0, 0, -0.5]), image_wh=(64, 48)) is None


# ---------------------------------------------------------------------------
# device primitives on seeded inputs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(3, 72, 96), (2, 7, 300), (5, 7)])
def test_box_sum_bitwise(shape):
    x = np.random.RandomState(0).rand(*shape).astype(np.float32)
    want = N(jax.jit(lambda t: jpatch._box_sum(t, FW))(x))
    assert np.array_equal(ppatch._box_sum(T(x), FW).numpy(), want)


def test_frac_shift_x():
    img = np.random.RandomState(0).rand(6, 12).astype(np.float32)
    shifts = np.array([0.0, 1.25, 3.0, 7.6, 11.9, 20.0], np.float32)
    want = jax.jit(jax.vmap(lambda s: jsweep._frac_shift_x(jnp.asarray(img), s)))(shifts)
    out, valid = psweep._frac_shift_x(T(img), T(shifts))
    np.testing.assert_allclose(out.numpy(), N(want[0]), rtol=0, atol=1e-5)
    assert np.array_equal(valid.numpy(), N(want[1]))
    one, one_valid = psweep._frac_shift_x(T(img), torch.tensor(1.25))
    assert one.shape == (6, 12) and one_valid.shape == (1, 12)
    np.testing.assert_allclose(one.numpy(), out[1].numpy(), rtol=0, atol=0)


@pytest.fixture(scope="module")
def textured(plane_prep):
    """View 0's geometry with uniform-noise images (high-contrast windows,
    so NCC is well conditioned) and candidate depths around the plane."""
    _, jp, _, _ = plane_prep
    p = jp[0]
    rng = np.random.RandomState(7)
    H, W = p["ref"].shape
    J = len(p["neigh"])
    ref = rng.rand(H, W).astype(np.float32)
    neigh = rng.rand(J, H, W).astype(np.float32)
    depth = p["init_depth"][None] * rng.uniform(0.95, 1.05, (3, H, W)).astype(np.float32)
    dzx = rng.uniform(-0.02, 0.02, (3, H, W)).astype(np.float32)
    dzy = rng.uniform(-0.02, 0.02, (3, H, W)).astype(np.float32)
    sel = np.stack([rng.permutation(J) for _ in range(H * W)], -1)[:3].reshape(3, H, W)
    return dict(p=p, ref=ref, neigh=neigh, depth=depth, dzx=dzx, dzy=dzy,
                nvalid=np.array([True] * (J - 1) + [False]), sel=sel,
                sel_valid=rng.rand(3, H, W) < 0.9)


def test_homography_warp(textured):
    r = textured["p"]["rect"][0]
    for img, M in ((textured["ref"], r["M_ref"]), (textured["neigh"][0], r["M_nei"])):
        Hr, Wr = r["rect_wh"][1], r["rect_wh"][0]
        want = jax.jit(lambda a, m: jsweep._homography_warp(a, m, Hr, Wr))(img, M)
        got = psweep._homography_warp(T(img), T(M), Hr, Wr)
        np.testing.assert_allclose(got[0].numpy(), N(want[0]), rtol=0, atol=1e-5)
        assert np.array_equal(got[1].numpy(), N(want[1]))


def test_warp_bilinear(textured):
    t, p = textured, textured["p"]
    H, W = t["ref"].shape
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    z = t["depth"] * p["ray_z"][None]
    args = (p["T"][:, None, None, None], p["tvec"][:, None, None, None], z[None], xs + 0.5, ys + 0.5)
    want = jax.jit(lambda n, *a: jpatch._warp_bilinear(n, *a))(t["neigh"], *args)
    got = ppatch._warp_bilinear(T(t["neigh"]), *(T(a) for a in args))
    assert np.array_equal(got[4].numpy(), N(want[4]))
    # The warped coordinates (corner + fraction) agree to 1e-6 relative,
    # two float32 ulps: XLA fuses the projection's multiply-adds in
    # places the port does not reproduce exactly.
    for i, j in ((0, 2), (1, 3)):
        np.testing.assert_allclose(got[i].numpy() + got[j].numpy().astype(np.float64),
                                   N(want[i]) + N(want[j]).astype(np.float64), rtol=1e-6, atol=2e-6)


def test_corner_indices_survive_nan_and_inf(textured):
    """A NaN depth and an infinite coordinate give in-range corner indices
    (marked out of bounds) instead of an index fault."""
    t, p = textured, textured["p"]
    H, W = t["ref"].shape
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    z = (t["depth"] * p["ray_z"][None])[:1].copy()
    z[0, 3, 4] = np.nan
    z[0, 5, 6] = np.inf
    xs = xs.copy()
    xs[7, 8] = np.inf
    J, Hn, Wn = t["neigh"].shape
    u0, v0, fu, fv, inb = ppatch._warp_bilinear(
        T(t["neigh"]), T(p["T"])[:, None, None, None], T(p["tvec"])[:, None, None, None],
        T(z)[None], T(xs) + 0.5, T(ys) + 0.5)
    assert int(u0.min()) >= 0 and int(u0.max()) <= Wn - 2
    assert int(v0.min()) >= 0 and int(v0.max()) <= Hn - 2
    assert not bool(inb[:, 0, 3, 4].any()) and not bool(inb[:, 0, 7, 8].any())
    depths = T(t["depth"][:1].copy())
    depths[0, 3, 4] = float("nan")
    rs = psolver._ref_box_stats(T(t["ref"]), FW)
    ncc, ok = psolver._ncc_box_all(T(t["ref"]), rs, T(t["neigh"]), T(t["nvalid"]), T(p["T"]),
                                   T(p["tvec"]), T(p["ray_z"]), depths, FW)
    assert not bool(ok[:, 0, 3, 4].any()) and bool(torch.isfinite(ncc).all())
    tab = torch.zeros((J, H, W, 8), dtype=torch.bfloat16)
    L = torch.full((1, H, W), float("nan"))
    ncc, ok = psweep._lookup(tab, torch.ones(J, H, W), torch.zeros(J), torch.ones(J),
                             torch.ones(J, dtype=torch.bool), L)
    assert not bool(ok.any()) and bool((ncc == -1.0).all())


def test_ncc_box_all_and_sel(textured):
    t, p = textured, textured["p"]
    jr = jax.jit(lambda r: jsolver._ref_box_stats(r, FW))(t["ref"])
    pr = psolver._ref_box_stats(T(t["ref"]), FW)
    for a, b in zip(jr, pr):
        np.testing.assert_allclose(b.numpy(), N(a), rtol=0, atol=1e-5)
    geo = (p["T"], p["tvec"], p["ray_z"], t["depth"])
    want = jax.jit(lambda r, rs, n, nv, *g: jsolver._ncc_box_all(r, rs, n, nv, *g, FW))(
        t["ref"], jr, t["neigh"], t["nvalid"], *geo)
    got = psolver._ncc_box_all(T(t["ref"]), pr, T(t["neigh"]), T(t["nvalid"]), *(T(g) for g in geo), FW)
    np.testing.assert_allclose(got[0].numpy(), N(want[0]), rtol=0, atol=1e-4)
    assert np.array_equal(got[1].numpy(), N(want[1]))
    want = jax.jit(lambda r, rs, n, *g: jsolver._ncc_box_sel(r, rs, n, *g, FW))(
        t["ref"], jr, t["neigh"], *geo, t["sel"], t["sel_valid"])
    got = psolver._ncc_box_sel(T(t["ref"]), pr, T(t["neigh"]), *(T(g) for g in geo),
                               T(t["sel"]), T(t["sel_valid"]), FW)
    np.testing.assert_allclose(got[0].numpy(), N(want[0]), rtol=0, atol=1e-4)
    assert np.array_equal(got[1].numpy(), N(want[1]))


def test_plane_ncc(textured):
    t, p = textured, textured["p"]
    geo = (p["T"], p["tvec"], p["ray_z"], t["depth"], t["dzx"], t["dzy"])
    want = jax.jit(lambda r, n, nv, *g: jsolver._ncc_plane_all(r, n, nv, *g, FW, 4))(
        t["ref"], t["neigh"], t["nvalid"], *geo)
    got = psolver._ncc_plane_all(T(t["ref"]), T(t["neigh"]), T(t["nvalid"]),
                                 *(T(g) for g in geo), FW, 4)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), N(w), rtol=0, atol=1e-5)
    want = jax.jit(lambda r, n, *g: jsolver._ncc_plane_sel(r, n, *g, FW))(
        t["ref"], t["neigh"], *geo, t["sel"], t["sel_valid"])
    got = psolver._ncc_plane_sel(T(t["ref"]), T(t["neigh"]), *(T(g) for g in geo),
                                 T(t["sel"]), T(t["sel_valid"]), FW)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), N(w), rtol=0, atol=1e-5)


def test_combine(textured):
    rng = np.random.RandomState(2)
    ncc = rng.uniform(-1, 1, (5, 3, 8, 9)).astype(np.float32)
    ncc[:, 0, 0, 0] = 0.25                      # ties
    ok = rng.rand(5, 3, 8, 9) < 0.8
    for k in (2, 4, 7):
        want = jax.jit(lambda a, o: jsolver._combine_topk(a, o, k))(ncc, ok)
        got = psolver._combine_topk(T(ncc), T(ok), k)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), N(w), rtol=0, atol=1e-5)
    want = jax.jit(jsolver._combine_sel)(ncc, ok)
    got = psolver._combine_sel(T(ncc), T(ok))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), N(w), rtol=0, atol=1e-5)


def test_view_selection(textured):
    """Local selection, its top-k fallback (ties: lower view index first,
    as jax.lax.top_k) and the plane normals."""
    t, p = textured, textured["p"]
    rng = np.random.RandomState(4)
    J = len(p["neigh"])
    H, W = t["ref"].shape
    ncc = rng.uniform(-0.2, 1, (J, H, W)).astype(np.float32)
    ncc[:, :4, :4] = 0.5                         # ties
    d = t["depth"][0]
    sc = np.array([0.3, 10.0], np.float32)
    args = (ncc, t["nvalid"], d, p["ray_world"], p["cam_rel"])
    for name in ("_local_view_selection", "_reselect_with_fallback"):
        want = jax.jit(lambda *a: getattr(jsolver, name)(*a, 4, sc[0], sc[1]))(*args)
        got = getattr(psolver, name)(*(T(a) for a in args), 4, T(sc)[0], T(sc)[1])
        assert np.array_equal(got[1].numpy(), N(want[1]))
        same = got[0].numpy() == N(want[0])
        # A selection can only differ where two weights tie to the last
        # bit after exp/arccos, which the two libraries round apart.
        assert same.mean() >= 0.999, f"{name}: {same.mean():.5f}"
    want = jax.jit(lambda *a: jsolver._topk_views(*a, 3))(ncc, t["nvalid"])
    got = psolver._topk_views(T(ncc), T(t["nvalid"]), 3)
    assert np.array_equal(got[0].numpy(), N(want[0])) and np.array_equal(got[1].numpy(), N(want[1]))
    want = jax.jit(lambda *a: jsolver._plane_normals(*a, 2))(d, t["dzx"][0], t["dzy"][0], p["ray_world"])
    got = psolver._plane_normals(T(d), T(t["dzx"][0]), T(t["dzy"][0]), T(p["ray_world"]), 2)
    np.testing.assert_allclose(got.numpy(), N(want), rtol=0, atol=1e-5)


def test_argmax_ties_pick_the_first():
    """Every candidate fold keeps the incumbent (index 0) on a tie."""
    x = torch.full((5, 4, 3), -1.0)
    assert bool((torch.argmax(x, dim=0) == 0).all())
    assert np.array_equal(torch.argmax(x, dim=0).numpy(), N(jnp.argmax(jnp.full((5, 4, 3), -1.0), 0)))


# ---------------------------------------------------------------------------
# cube, table and lookup
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tables(plane_prep):
    """View 0's per-pair cubes and tables in both packages (D=64)."""
    _, jp, _, _ = plane_prep
    p = jp[0]
    H, W = p["ref"].shape
    D = 64
    rect_w = max(r["rect_wh"][0] for r in p["rect"])
    rect_h = max(r["rect_wh"][1] for r in p["rect"])
    Hr, Wr = -(-rect_h // 32) * 32, -(-rect_w // 32) * 32

    def jax_pair(ref, nei, Mr, Mn, Hf, fb, w0, dw):
        rr, rok = jsweep._homography_warp(ref, Mr, Hr, Wr)
        rn, nok = jsweep._homography_warp(nei, Mn, Hr, Wr)
        cube = jsweep._build_cube(rr, rok, rn, nok, fb, w0, dw, D, FW)
        return cube, jsweep._reindex_cube(cube, Hf, H, W)

    jpair = jax.jit(jax_pair)
    out = []
    for j, r in enumerate(p["rect"]):
        geo = (r["M_ref"], r["M_nei"], r["H_fwd"], np.float32(r["fB"]), np.float32(r["w0"]),
               np.float32(r["dw"] / (D - 1)))
        jc, jt = jpair(p["ref"], p["neigh"][j], *geo)
        rr, rok = psweep._homography_warp(T(p["ref"]), T(geo[0]), Hr, Wr)
        rn, nok = psweep._homography_warp(T(p["neigh"][j]), T(geo[1]), Hr, Wr)
        pc = psweep._build_cube(rr, rok, rn, nok, *(torch.tensor(g) for g in geo[3:]), D, FW)
        # The port's reindex of mve_tpu's cube isolates the reindex.
        jcube = torch.from_numpy(N(jc.astype(jnp.float32))).to(torch.bfloat16)
        out.append(dict(jc=N(jc.astype(jnp.float32)), jt=N(jt.astype(jnp.float32)),
                        pc=pc.float().numpy(), pt=psweep._reindex_cube(pc, T(geo[2]), H, W),
                        pt_j=psweep._reindex_cube(jcube, T(geo[2]), H, W).float().numpy(),
                        w0=geo[4], dw=geo[5], e3=r["e3"]))
    return p, out


def test_cube_and_table_within_two_bf16_ulps(tables):
    _, out = tables
    for o in out:
        for a, b in ((o["jc"], o["pc"]), (o["jt"], o["pt"].float().numpy())):
            # Measured: at most 2^-6 apart (two bf16 ulps at 1.0) on under
            # 1.3% of the entries.
            d = np.abs(a - b)
            assert d.max() <= 2.0 ** -6 and (d > 0).mean() <= 0.015, (d.max(), (d > 0).mean())
        # Given mve_tpu's cube, the reindexed table is bit-identical.
        assert np.array_equal(o["pt_j"], o["jt"])


def test_lookup_bitwise_given_the_same_table(tables):
    p, out = tables
    H, W = p["ref"].shape
    J = len(out)
    tab = np.stack([o["jt"] for o in out])
    e3 = np.stack([o["e3"] for o in out])
    c_j = N(jax.jit(lambda e, r: jnp.einsum("jc,hwc->jhw", e, r))(e3, p["ray_world"]))
    p_cj = pvs._dot3(T(e3)[:, None, None, :], T(p["ray_world"])[None])
    assert np.array_equal(p_cj.numpy(), c_j)
    w0 = np.array([o["w0"] for o in out], np.float32)
    dw = np.array([o["dw"] for o in out], np.float32)
    nvalid = np.array([True] * (J - 1) + [False])
    L = p["init_depth"][None] * np.array([0.9, 1.0, 1.07], np.float32)[:, None, None]
    want = jax.jit(jsweep._lookup)(jnp.asarray(tab, jnp.bfloat16), c_j, w0, dw, nvalid, L)
    got = psweep._lookup(T(tab).to(torch.bfloat16), T(c_j), T(w0), T(dw), T(nvalid), T(L))
    assert np.array_equal(got[0].numpy(), N(want[0]))
    assert np.array_equal(got[1].numpy(), N(want[1]))


# ---------------------------------------------------------------------------
# whole solvers
# ---------------------------------------------------------------------------

def _compare(jout, pout, H, W, median_bound):
    jd, pd = jout[0], pout[0]
    for b in range(jd.shape[0]):
        jf, pf = (jd[b] > 0).mean(), (pd[b] > 0).mean()
        assert abs(jf - pf) <= 0.005, (b, jf, pf)
        assert abs(float(jout[3][b]) / (H * W) - float(pout[3][b]) / (H * W)) <= 0.005
        both = (jd[b] > 0) & (pd[b] > 0)
        rel = np.abs(jd[b][both] - pd[b][both]) / jd[b][both]
        assert np.median(rel) <= median_bound, (b, np.median(rel))
        assert jf > 0.3
    for a, c in zip(jout, pout):
        assert a.shape == c.shape and a.dtype == c.dtype


def test_solve_batch_sweep(plane_prep):
    js, jp, ps, pp = plane_prep
    assert all(jdm._sweep_capable(p, js) for p in jp)
    jout = jdm._run_batch(jp, js)
    pout = pdm._run_batch(pp, ps, "cpu")
    H, W = jp[0]["ref"].shape
    _compare(jout, pout, H, W, 2e-3)


def test_solve_batch_sweep_legacy_grid(scenes, plane_prep):
    """solve_batch_sweep(rect_hw=None) on plane_prep's views, the pairs
    rectified with rectify_pair(margin_yx=rect_margins(H, W))."""
    with legacy_grid(jsweep, psweep) as handed:
        js, jp, ps, pp = _both(str(scenes / "plane"), [0, 2])
        assert all(jdm._sweep_capable(p, js) for p in jp)
        H, W = jp[0]["ref"].shape
        fitted = plane_prep[3][0]["rect"][0]["H_fwd"]
        assert not np.array_equal(pp[0]["rect"][0]["H_fwd"], fitted)
        _compare(jdm._run_batch(jp, js), pdm._run_batch(pp, ps, "cpu"), H, W, 2e-3)
    assert len(handed) == 2


@pytest.mark.parametrize("solver", ["sweep", "warp"])
def test_chunk_bounds_memory_only(scenes, plane_prep, monkeypatch, solver):
    """The candidates scored at a time (solver._CHUNK, mve_tpu's `chunk`
    keyword, a stated departure) change no result of either solver."""
    if solver == "sweep":
        _, _, ps, pp = plane_prep
        mod = psweep
    else:
        _, _, ps, pp = _both(str(scenes / "plane"), [0], use_sweep=False)
        mod = psolver
    want = pdm._run_batch(pp, ps, "cpu")
    monkeypatch.setattr(mod, "_CHUNK", 3)
    got = pdm._run_batch(pp, ps, "cpu")
    assert all(np.array_equal(x, y) for x, y in zip(got, want))


@pytest.mark.parametrize("exact", [False, True])
def test_solve_batch_warp(scenes, exact):
    js, jp, ps, pp = _both(str(scenes / "plane"), [0], use_sweep=False, exact_ncc=exact,
                           **(SMALL if exact else {}))
    assert not jdm._sweep_capable(jp[0], js) and not pdm._sweep_capable(pp[0], ps)
    _compare(jdm._run_batch(jp, js), pdm._run_batch(pp, ps, "cpu"), *jp[0]["ref"].shape, 1e-3)


def test_forward_motion_goes_to_the_warp_solver(scenes):
    js, jp, ps, pp = _both(str(scenes / "forward"), [2], nr_recon_neighbors=2,
                           num_sweep_planes=8, num_propagation_iters=2)
    assert any(r is None for r in pp[0]["rect"])
    assert not jdm._sweep_capable(jp[0], js) and not pdm._sweep_capable(pp[0], ps)
    _compare(jdm._run_batch(jp, js), pdm._run_batch(pp, ps, "cpu"), *jp[0]["ref"].shape, 1e-3)


def test_settings_from_dict():
    js = JSettings(scale=2, min_ncc=0.4, num_lookup_planes=32)
    ps = mvs_settings_from_dict(dataclasses.asdict(js))
    assert dataclasses.asdict(ps).keys() == dataclasses.asdict(js).keys()
    for key, value in dataclasses.asdict(js).items():
        assert np.array_equal(np.asarray(getattr(ps, key)), np.asarray(value)), key
    with pytest.raises(ValueError, match="unknown fields"):
        mvs_settings_from_dict({"no_such_field": 1})


@pytest.mark.parametrize("name", ["ncc_score_box", "ncc_score_multi", "ncc_score",
                                  "ncc_score_plane", "ncc_score_plane_sel",
                                  "ncc_per_view_box", "ncc_score_box_sel",
                                  "local_view_selection"])
def test_public_scorers(textured, name):
    """mvs/patch.py's and mvs/view_selection.py's public functions, within
    the primitives' limits (NCC to 1e-4, selections identical on 99.9% of
    the pixels)."""
    t, p = textured, textured["p"]
    J = len(p["neigh"])
    geo = (t["ref"], t["neigh"], p["T"], p["tvec"], p["ray_z"])
    d3 = t["depth"]
    args = {
        "ncc_score_box": (d3,), "ncc_score_multi": (d3[:2],), "ncc_score": (d3[0],),
        "ncc_score_plane": (d3, t["dzx"], t["dzy"]),
        "ncc_score_plane_sel": (d3, t["dzx"], t["dzy"], t["sel"], t["sel_valid"]),
        "ncc_per_view_box": (d3[0],), "ncc_score_box_sel": (d3, t["sel"], t["sel_valid"]),
    }
    if name == "local_view_selection":
        rng = np.random.RandomState(5)
        ncc = rng.uniform(-0.2, 1, (J,) + d3.shape[1:]).astype(np.float32)
        centers = rng.randn(J, 3).astype(np.float32)
        ref_pos = np.array([0.1, -0.2, 0.05], np.float32)
        a = (ncc, d3[0], p["ray_world"], ref_pos, centers)
        want = jvs.local_view_selection(*a, k=3)
        got = pvs.local_view_selection(*(T(x) for x in a), k=3)
        assert np.array_equal(got[1].numpy(), N(want[1]))
        assert (got[0].numpy() == N(want[0])).mean() >= 0.999
        return
    want = getattr(jpatch, name)(*geo, *args[name])
    got = getattr(ppatch, name)(*(T(x) for x in geo + args[name]))
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        np.testing.assert_allclose(g.numpy(), N(w), rtol=0, atol=1e-4)
