"""The slanted-plane NCC kernel (csrc/plane_ncc.cu, ops/plane_ncc.py).

On the CPU: a scalar copy of the kernel's per-output program, written
here in numpy with the kernel's float32 operations and float64 multiply-
adds in the kernel's order, equals mvs/patch._plane_tap_sums_plain bit
for bit, for both forms of the view index (every view; per-pixel selected
views), with and without the neighbours' own sizes, on inputs whose taps
fall off the image and off a padded neighbour's own size, with ray lengths
at or below 0 and NaN and infinite depths and slopes. The wrapper's checks
that need no card raise, and a CPU tensor never reaches the wrapper.

On the card (marked `chip`, skipped without one; this file imports no
JAX: `python -m pytest --noconftest -m chip tests/test_torch_plane_ncc.py`
there): the kernel against the plain program on the card, bit for bit, at
those inputs and at the main path's forms (kitti00's S = 4, K = 10 at
1241x376 with J = 20; landmark36's padded neighbours with their own
sizes; the sweep solver's centre plane, J = 20, K = 1 at 400x300), and
the warp solver on one street view with the kernel and with the plain
program: the same depth, confidence, slopes and accepted count.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from mve_tpu_torch.mvs import patch
from mve_tpu_torch.ops import plane_ncc

torch.set_num_threads(1)

F32 = np.float32


def _load_inputs():
    """torch_plane_ncc_inputs.py beside this file, loaded from its path:
    where another installed package is named `tests`, `tests.<name>`
    finds that one."""
    path = Path(__file__).with_name("torch_plane_ncc_inputs.py")
    spec = importlib.util.spec_from_file_location("torch_plane_ncc_inputs", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_inputs = _load_inputs()
MAIN, TINY, case, to_torch = _inputs.MAIN, _inputs.TINY, _inputs.case, _inputs.to_torch


# -----------------------------------------------------------------------
# the kernel's per-output program, one scalar at a time
# -----------------------------------------------------------------------

def _fma64(a, b, c):
    return F32(float(a) * float(b) + float(c))


def _clamp(x, lo, hi):
    return x if x != x else min(max(x, lo), hi)


def _corner_index(c, hi):
    return min(max(0 if c != c else int(c), 0), max(hi, 0))


def torch_cpu_sqrt(x):
    """torch.sqrt of one float32 on the CPU. With AVX-512 it is not always
    the correctly rounded root (one ulp low on about 1 in 400 outputs of
    these inputs); on the card torch.sqrt and the kernel's __fsqrt_rn
    both are."""
    return F32(torch.sqrt(torch.tensor([x], dtype=torch.float32))[0])


def scalar_kernel(ref_img, neigh_imgs, T, tvec, hw, jidx, ray_z, depths, dzx, dzy, filter_width,
                  sqrt=np.sqrt):
    """What csrc/plane_ncc.cu's plane_ncc_kernel computes, output by output,
    its square root taken by `sqrt`."""
    K, H, W = depths.shape
    J, Hn, Wn = neigh_imgs.shape
    lead = jidx.shape[0]
    jx = np.broadcast_to(jidx, (lead, K, H, W))
    r = filter_width // 2
    inv_n = F32(1.0 / (filter_width * filter_width))
    one, half = F32(1.0), F32(0.5)
    ncc = np.full((lead, K, H, W), -1.0, F32)
    valid = np.zeros((lead, K, H, W), bool)
    for k in range(K):
        for y in range(H):
            for x in range(W):
                d, zx, zy = depths[k, y, x], dzx[k, y, x], dzy[k, y, x]
                pos_all, sum_r, sum_rr = True, F32(0), F32(0)
                for dy in range(-r, r + 1):
                    cy = min(max(y + dy, 0), H - 1)
                    for dx in range(-r, r + 1):
                        cx = min(max(x + dx, 0), W - 1)
                        rv = ref_img[cy, cx]
                        sum_r = sum_r + rv
                        sum_rr = _fma64(rv, rv, sum_rr)
                        L = (d + F32(dx) * zx) + F32(dy) * zy
                        pos_all = pos_all and bool(L > 0)
                if not pos_all:
                    continue
                mean_r = sum_r * inv_n
                var_r = _fma64(sum_rr, inv_n, -(mean_r * mean_r))
                for s in range(lead):
                    j = int(jx[s, k, y, x])
                    h, w = (F32(Hn), F32(Wn)) if hw is None else (hw[j, 0], hw[j, 1])
                    ok, sum_n, sum_nn, sum_rn = True, F32(0), F32(0), F32(0)
                    for dy in range(-r, r + 1):
                        cy = min(max(y + dy, 0), H - 1)
                        qy = F32(y + dy) + half
                        for dx in range(-r, r + 1):
                            cx = min(max(x + dx, 0), W - 1)
                            rv = ref_img[cy, cx]
                            L = (d + F32(dx) * zx) + F32(dy) * zy
                            z = L * ray_z[cy, cx]
                            qx = F32(x + dx) + half
                            hx, hy, hz = (_fma64((T[j, i, 0] * qx + T[j, i, 1] * qy) + T[j, i, 2],
                                                 z, tvec[j, i]) for i in range(3))
                            hz_safe = F32(1e-20) if abs(hz) < F32(1e-20) else hz
                            u = hx / hz_safe - half
                            v = hy / hz_safe - half
                            if not (u >= 0 and u <= w - one and v >= 0 and v <= h - one
                                    and hz > 0):
                                ok = False
                                break
                            u0 = _clamp(np.floor(u), F32(0), w - F32(2))
                            v0 = _clamp(np.floor(v), F32(0), h - F32(2))
                            fu = _clamp(u - u0, F32(0), one)
                            fv = _clamp(v - v0, F32(0), one)
                            ui, vi = _corner_index(u0, Wn - 2), _corner_index(v0, Hn - 2)
                            img = neigh_imgs[j]
                            p00, p01 = img[vi, ui], img[vi, ui + 1]
                            p10, p11 = img[vi + 1, ui], img[vi + 1, ui + 1]
                            gu, gv = one - fu, one - fv
                            nv = _fma64(p00 * gu, gv, (p01 * fu) * gv)
                            nv = _fma64(p10 * gu, fv, nv)
                            nv = _fma64(p11 * fu, fv, nv)
                            sum_n = sum_n + nv
                            sum_nn = _fma64(nv, nv, sum_nn)
                            sum_rn = _fma64(rv, nv, sum_rn)
                        if not ok:
                            break
                    if ok:
                        mean_n = sum_n * inv_n
                        var_n = _fma64(sum_nn, inv_n, -(mean_n * mean_n))
                        cov = _fma64(sum_rn, inv_n, -(mean_r * mean_n))
                        prod = var_r * var_n
                        denom = sqrt(prod if prod != prod else max(prod, F32(1e-12)))
                        ncc[s, k, y, x] = cov / denom
                        valid[s, k, y, x] = True
    return ncc, valid


def _same_bits(got, want):
    got_ncc, got_valid = (np.asarray(t.cpu()) for t in got)
    want_ncc, want_valid = want
    assert got_ncc.shape == want_ncc.shape and got_ncc.dtype == np.float32
    assert np.array_equal(got_valid, want_valid)
    diff = got_ncc.view(np.uint32) != want_ncc.view(np.uint32)
    assert not diff.any(), f"{int(diff.sum())} of {diff.size} NCC values differ"


@pytest.mark.parametrize("form", sorted(TINY))
def test_scalar_copy_is_the_plain_program(form):
    args = case(TINY[form])
    with np.errstate(all="ignore"):
        want = scalar_kernel(**args, sqrt=torch_cpu_sqrt)
    before = plane_ncc.launches
    got = patch._plane_tap_sums(**to_torch(args))
    assert plane_ncc.launches == before
    _same_bits(got, want)
    valid = want[1]
    # Both outcomes occur, with valid outputs at and off the image's edge
    # rows, and every special value leaves its outputs invalid.
    assert 0.2 < valid.mean() < 0.95
    bad = ~np.isfinite(args["depths"]) | ~np.isfinite(args["dzx"]) | ~np.isfinite(args["dzy"])
    bad |= args["depths"] <= 0
    assert bad.sum() >= 8 and not valid[:, bad].any()
    if args["hw"] is not None:
        # The neighbours' own sizes cut windows that the padding would keep.
        _, valid_padded = patch._plane_tap_sums(**to_torch({**args, "hw": None}))
        assert (valid_padded.numpy() & ~valid).any()


def _wrapper_args():
    return to_torch(case(TINY["sel-hw"]))


def _call(args):
    return plane_ncc.plane_ncc(args["ref_img"], args["neigh_imgs"], args["T"], args["tvec"],
                               args["hw"], args["jidx"], args["ray_z"], args["depths"],
                               args["dzx"], args["dzy"], args["filter_width"], 0.04)


CHECKS = {
    "cpu-tensors": (lambda a: a, ValueError, "CUDA tensors only"),
    "float64-depths": (lambda a: {**a, "depths": a["depths"].double()}, TypeError, "float32"),
    "int32-index": (lambda a: {**a, "jidx": a["jidx"].int()}, TypeError, "int64"),
    "index-dims": (lambda a: {**a, "jidx": a["jidx"][:, 0]}, ValueError, "4 dimensions"),
    "index-shape": (lambda a: {**a, "jidx": a["jidx"][..., :3]}, ValueError, "broadcast"),
    "slope-shape": (lambda a: {**a, "dzx": a["dzx"][:1]}, ValueError, "dzx"),
    "operator-shape": (lambda a: {**a, "T": a["T"][:2]}, ValueError, "T"),
    "sizes-shape": (lambda a: {**a, "hw": a["hw"][:, :1].contiguous()}, ValueError, "hw"),
    "sizes-dtype": (lambda a: {**a, "hw": a["hw"].double()}, TypeError, "hw"),
    "not-a-tensor": (lambda a: {**a, "ray_z": a["ray_z"].numpy()}, TypeError, "ray_z"),
    "even-window": (lambda a: {**a, "filter_width": 4}, ValueError, "odd"),
    "one-column": (lambda a: {**a, "neigh_imgs": a["neigh_imgs"][..., :1].contiguous(),
                              "hw": None}, ValueError, "two rows"),
    "too-many-views": (lambda a: {**a, "neigh_imgs": a["neigh_imgs"][:1].expand(
        plane_ncc.MAX_VIEWS + 1, -1, -1).contiguous(), "T": a["T"][:1].expand(
        plane_ncc.MAX_VIEWS + 1, -1, -1).contiguous(), "tvec": a["tvec"][:1].expand(
        plane_ncc.MAX_VIEWS + 1, -1).contiguous(), "hw": None}, ValueError, "at most"),
    "not-contiguous": (lambda a: {**a, "depths": a["depths"].transpose(1, 2).contiguous()
                                  .transpose(1, 2)}, ValueError, "contiguous"),
}


@pytest.mark.parametrize("name", sorted(CHECKS))
def test_wrapper_refuses(name):
    change, exc, words = CHECKS[name]
    before = plane_ncc.launches
    with pytest.raises(exc, match=words):
        _call(change(_wrapper_args()))
    assert plane_ncc.launches == before


# -----------------------------------------------------------------------
# on the card
# -----------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the plane NCC kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.chip
def test_kernel_is_the_plain_program_on_the_card(card):
    for name, form in {**TINY, **MAIN}.items():
        args = to_torch(case(form, seed=1), card)
        before = plane_ncc.launches
        got = patch._plane_tap_sums(**args)
        assert plane_ncc.launches == before + 1, name
        want = patch._plane_tap_sums_plain(**args)
        torch.cuda.synchronize()
        _same_bits(got, tuple(np.asarray(t.cpu()) for t in want))
        assert 0.2 < float(want[1].float().mean()) < 0.99, name


@pytest.mark.chip
def test_warp_solver_with_the_kernel_is_the_plain_program(card, tmp_path, monkeypatch):
    from mve_tpu_torch import synthetic_street as st
    from mve_tpu_torch.core import Bundle, CameraInfo, Feature2D, Feature3D, Scene, View
    from mve_tpu_torch.mvs import Settings
    from mve_tpu_torch.mvs import dmrecon as mvs

    # tests/test_torch_street.py's street: 10 frames of 248x76, seed 5.
    W, H, N, SEED = 248, 76, 10, 5
    cams = st.make_cameras(N, st.rng_for(SEED, 0))
    textures = st.textures_for(SEED)
    scene = Scene.create(str(tmp_path / "scene"))
    infos = []
    for i, cam in enumerate(cams):
        info = CameraInfo(flen=cam.flen)
        info.rot, info.trans = cam.R.astype(np.float32), cam.t.astype(np.float32)
        infos.append(info)
        view = View.create(scene.view_dir_for_id(i), i)
        view.set_camera(info)
        gray = st.render_gray(textures, cam, W, H, st.cross_wall_z(N), torch, "cpu")
        view.set_image("undistorted", np.repeat(gray[:, :, None], 3, axis=2))
        scene.add_view(view)
    scene.save_views()
    pts, vis = st.bundle_points(400, cams, W, H, st.rng_for(SEED, 3), torch)
    bundle = Bundle()
    bundle.cameras = infos
    for pi, p in enumerate(pts):
        refs = [Feature2D(int(v), pi, np.zeros(2, np.float32)) for v in np.nonzero(vis[:, pi])[0]]
        bundle.features.append(Feature3D(p.astype(np.float32), np.full(3, 0.5, np.float32), refs))
    scene.set_bundle(bundle)
    scene.save_scene()

    scene = Scene(str(tmp_path / "scene"))
    s = Settings(scale=0)
    views, positions, vis, full_sizes = mvs._scene_inputs(scene, s)
    prep = mvs._prepare_view(scene, s, views, positions, vis, full_sizes, 4, card)
    assert not mvs._sweep_capable(prep, s)
    # warp_plane's two first calls and one a round, warp_accept's one
    calls = 2 + mvs._solver_params(s)[0]["n_plane_rounds"] + 1
    before = plane_ncc.launches
    got = mvs._run_batch([prep], s, card)
    assert plane_ncc.launches - before == calls
    monkeypatch.setattr(plane_ncc, "plane_ncc",
                        lambda *a: patch._plane_tap_sums_plain(*a[:-1]))
    want = mvs._run_batch([prep], s, card)
    assert plane_ncc.launches - before == calls
    for name, g, w in zip(("depth", "conf", "dz", "n_accepted"), got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w), name
    assert got[3][0] > 0.2 * H * W
