"""The port's makescene, thumbnails, k2/k4 undistortion and bundle
importers against mve_tpu's, on the CPU.

Both packages import the same folder of photos (PNGs, and JPEGs with an
EXIF focal length) and the same SfM workspaces (NVM, COLMAP text, binary
and a workspace with depth maps, Photosynther, Bundler); a walk over the
two scene directories compares every file's bytes. The one exception
allowed is a thumbnail pixel one level apart where the resized value lies
within rounding of a half level: when downsampling, jax.image.resize sums
its weights in XLA's order and the port in numpy's, so a weight can differ
in its last bit. Each test states how many such pixels it met (one, in
test_thumbnail; none in the scene directories).
"""

import os
import struct

import numpy as np
import pytest
import torch

from mve_tpu.apps import makescene as japp
from mve_tpu.core import bundle_io as jbio
from mve_tpu.core import image_tools as jtools

from mve_tpu_torch import synthetic
from mve_tpu_torch.apps import makescene as papp
from mve_tpu_torch.core import bundle_io as pbio
from mve_tpu_torch.core import image_io
from mve_tpu_torch.core import image_tools as ptools
from mve_tpu_torch.core.bundle import Bundle, Feature2D, Feature3D
from mve_tpu_torch.core.camera import CameraInfo

torch.set_num_threads(1)

TIE = 1e-3  # a rounding tie: the float value within this of k + 0.5


def tie_pixels(img, a, b):
    """Pixels where thumbnails a and b differ; raises unless each is one
    level apart at a rounding tie of the port's float thumbnail of img."""
    diff = a.astype(int) - b.astype(int)
    bad = np.nonzero(diff)
    if not len(bad[0]):
        return 0
    assert np.abs(diff).max() == 1
    value = ptools.create_thumbnail(np.asarray(img, np.float32), device="cpu")
    frac = value[bad] - np.floor(value[bad])
    assert np.all(np.abs(frac - 0.5) < TIE), frac
    return len(bad[0])


def compare_trees(jdir, pdir):
    """Every file of the two trees byte for byte; thumbnails may differ at
    rounding ties. Returns the number of such thumbnail pixels."""
    def files(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs)

    assert files(jdir) == files(pdir)
    ties = 0
    for rel in files(jdir):
        with open(os.path.join(jdir, rel), "rb") as f:
            want = f.read()
        with open(os.path.join(pdir, rel), "rb") as f:
            got = f.read()
        if got == want:
            continue
        assert os.path.basename(rel) == "thumbnail.png", rel
        view = os.path.dirname(os.path.join(jdir, rel))
        orig = [f for f in os.listdir(view) if f.startswith("original.")][0]
        ties += tie_pixels(image_io.load_image(os.path.join(view, orig)),
                           image_io.load_image(os.path.join(jdir, rel)),
                           image_io.load_image(os.path.join(pdir, rel)))
    return ties


@pytest.fixture(scope="module")
def photos(tmp_path_factory):
    """Landscape and portrait views, even and odd sizes, PNG and JPEG."""
    root = tmp_path_factory.mktemp("photos")
    folder = root / "imgs"
    synthetic.make_photo_folder(str(folder), n_views=3, width=96, height=72, seed=3)
    extra = root / "extra"
    synthetic.make_photo_folder(str(extra), n_views=2, width=57, height=83, seed=4)
    for name in sorted(os.listdir(extra)):
        os.rename(extra / name, folder / f"portrait_{name}")
    return str(folder)


# ---------------------------------------------------------------------------
# image tools
# ---------------------------------------------------------------------------

# (h, w, thumbnail pixels at a rounding tie): both aspect branches, odd
# sizes, up- and downsampling, an unchanged axis. Of 45,000 pixels of
# noise, one (at 120x33) rounds the other way.
@pytest.mark.parametrize("h,w,ties", [(72, 96, 0), (83, 57, 0), (61, 61, 0), (37, 161, 0),
                                      (120, 33, 1), (48, 40, 0)])
def test_thumbnail(h, w, ties):
    img = (np.random.RandomState(h * w).rand(h, w, 3) * 255).astype(np.uint8)
    want = jtools.create_thumbnail(img)
    got = ptools.create_thumbnail(img, device="cpu")
    assert got.shape == want.shape == (50, 50, 3) and got.dtype == np.uint8
    assert tie_pixels(img, want, got) == ties


def test_thumbnail_float_and_gray():
    rng = np.random.RandomState(1)
    img = rng.rand(70, 90, 1).astype(np.float32)
    np.testing.assert_allclose(ptools.create_thumbnail(img, 20, 30, device="cpu"),
                               jtools.create_thumbnail(img, 20, 30), atol=2e-7)
    gray = (rng.rand(64, 48) * 255).astype(np.uint8)
    assert tie_pixels(gray[..., None], jtools.create_thumbnail(gray),
                      ptools.create_thumbnail(gray, device="cpu")) == 0


@pytest.mark.parametrize("flen,k2,k4", [(0.9, -0.12, 0.03), (1.3, 0.05, -0.01),
                                        (600.0, -0.2, 0.0), (0.9, 0.0, 0.0)])
def test_undistort_k2k4_single(flen, k2, k4):
    img = ptools.to_float((np.random.RandomState(2).rand(47, 63, 3) * 255).astype(np.uint8))
    want = np.asarray(jtools.image_undistort_k2k4(img, flen, k2, k4))
    got = ptools.image_undistort_k2k4(img, flen, k2, k4, device="cpu")
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-6)
    # makescene's rounding: the same bytes.
    np.testing.assert_array_equal(ptools.to_byte(got), jtools.to_byte(want))


def test_rescale_half_size_subsample():
    x = np.arange(35, dtype=np.float32).reshape(5, 7)
    np.testing.assert_array_equal(ptools.rescale_half_size_subsample(x),
                                  np.asarray(jtools.rescale_half_size_subsample(x)))


# ---------------------------------------------------------------------------
# makescene -i, -m, -a, -c
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flags", [[], ["-m", "1500"], ["-c", "0.92,0.01,-0.02,0.49,0.51,1.01"]])
def test_makescene_images(photos, tmp_path, flags):
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    assert japp.main(["-i", *flags, photos, jdir]) == 0
    assert papp.main(["-i", *flags, photos, pdir, "--device", "cpu"]) == 0
    assert len(os.listdir(os.path.join(pdir, "views"))) == 5
    assert compare_trees(jdir, pdir) == 0


def test_makescene_append(photos, tmp_path):
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    for argv in (["-i", photos], ["-i", "-a", "-m", "3000", photos]):
        assert japp.main([*argv, jdir]) == 0
        assert papp.main([*argv, pdir, "--device", "cpu"]) == 0
    assert len(os.listdir(os.path.join(pdir, "views"))) == 10
    assert compare_trees(jdir, pdir) == 0


def test_makescene_keeps_exif(photos, tmp_path):
    pdir = str(tmp_path / "port")
    papp.import_images(photos, pdir, device="cpu")
    blobs = [f for d, _, fs in os.walk(pdir) for f in fs if f == "exif.blob"]
    assert len(blobs) == 3   # the JPEGs


# ---------------------------------------------------------------------------
# bundle importers
# ---------------------------------------------------------------------------

def _images(folder, names, w=64, h=48, seed=5):
    os.makedirs(folder, exist_ok=True)
    rng = np.random.RandomState(seed)
    for name in names:
        image_io.save_image((rng.rand(h, w, 3) * 255).astype(np.uint8),
                            os.path.join(folder, name))


def _assert_bundles_equal(a, b):
    assert a.get_num_cameras() == b.get_num_cameras()
    assert a.get_num_features() == b.get_num_features()
    for ca, cb in zip(a.cameras, b.cameras):
        assert ca.flen == cb.flen
        for name in ("dist", "rot", "trans", "ppoint"):
            np.testing.assert_array_equal(getattr(ca, name), getattr(cb, name))
        assert ca.paspect == cb.paspect
    for fa, fb in zip(a.features, b.features):
        np.testing.assert_array_equal(fa.pos, fb.pos)
        np.testing.assert_array_equal(fa.color, fb.color)
        assert [(r.view_id, r.feature_id) for r in fa.refs] == \
            [(r.view_id, r.feature_id) for r in fb.refs]
        for ra, rb in zip(fa.refs, fb.refs):
            np.testing.assert_array_equal(ra.pos, rb.pos)


def _nvm(root):
    _images(str(root), ["img0.png", "img1.png"])
    path = root / "model.nvm"
    path.write_text(
        "NVM_V3\n\n2\n"
        "img0.png 80 1 0 0 0 0.5 0.2 4.0 0 0\n"
        "img1.png 80 0.9689124 0 0.2474 -0.4 0.1 4.1 0 0\n"
        "\n2\n"
        "0.1 0.2 3.0 200 100 50 2 0 0 0.1 0.2 1 0 -0.1 0.15\n"
        "-0.3 0.4 2.5 10 20 30 1 1 4 5.5 -3.25\n")
    return str(path)


def _colmap_txt(root):
    model = root / "model"
    model.mkdir(parents=True)
    (model / "cameras.txt").write_text(
        "# comment\n1 PINHOLE 64 48 50 52 32 24\n2 SIMPLE_RADIAL 64 48 55 31 23 -0.05\n")
    (model / "images.txt").write_text(
        "# comment\n"
        "1 1 0 0 0 0.1 0.2 0.3 1 img0.png\n"
        "10 20 7\n"
        "2 0.9689124 0 0.2474 0 0.0 0.1 0.3 2 img1.png\n"
        "\n")
    (model / "points3D.txt").write_text(
        "# comment\n7 1.0 2.0 3.0 200 150 100 0.5 1 0 2 1\n")
    _images(str(root / "images"), ["img0.png", "img1.png"])
    return str(model)


def _colmap_bin(model):
    model.mkdir(parents=True, exist_ok=True)
    with open(model / "cameras.bin", "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<Ii", 1, 1))  # id 1, PINHOLE
        f.write(struct.pack("<QQ", 64, 48))
        f.write(struct.pack("<4d", 50.0, 50.0, 32.0, 24.0))
    with open(model / "images.bin", "wb") as f:
        f.write(struct.pack("<Q", 2))
        for image_id, quat, name, pts in (
                (1, (1, 0, 0, 0), b"img0.png", [(10.0, 20.0, 7)]),
                (2, (0.9689124, 0, 0.2474, 0), b"img1.png", [])):
            f.write(struct.pack("<I", image_id))
            f.write(struct.pack("<7d", *quat, 0.1, 0.2, 0.3))
            f.write(struct.pack("<I", 1))
            f.write(name + b"\x00")
            f.write(struct.pack("<Q", len(pts)))
            for p in pts:
                f.write(struct.pack("<ddQ", *p))
    with open(model / "points3D.bin", "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<Q", 7))
        f.write(struct.pack("<3d", 1.0, 2.0, 3.0))
        f.write(struct.pack("<3B", 200, 150, 100))
        f.write(struct.pack("<d", 0.5))
        f.write(struct.pack("<Q", 2))
        f.write(struct.pack("<II", 1, 0))
        f.write(struct.pack("<II", 2, 1))


def _colmap_workspace(root):
    ws = root / "workspace"
    _colmap_bin(ws / "sparse" / "0")
    _images(str(ws / "images"), ["img0.png", "img1.png"])
    dm_dir = ws / "stereo" / "depth_maps"
    dm_dir.mkdir(parents=True)
    depth = (2.0 + np.random.RandomState(6).rand(48, 64)).astype(np.float32)
    with open(dm_dir / "img0.png.geometric.bin", "wb") as f:
        f.write(b"64&48&1&" + depth.astype("<f4").tobytes())
    return str(ws)


def _synthetic_bundle(n_cams, seed=7):
    rng = np.random.RandomState(seed)
    bundle = Bundle()
    for i in range(n_cams):
        cam = CameraInfo()
        cam.flen = 0.0 if i == 2 else float(0.8 + 0.1 * i)   # view 2 invalid
        cam.dist = np.array([-0.1 * (i + 1), 0.02], np.float32)
        cam.rot = synthetic.rodrigues_to_matrix(rng.randn(3) * 0.1).astype(np.float32)
        cam.trans = rng.randn(3).astype(np.float32)
        bundle.cameras.append(cam)
    for j in range(6):
        refs = [Feature2D(v, j, rng.rand(2).astype(np.float32)) for v in (0, 1)]
        bundle.features.append(Feature3D(rng.randn(3).astype(np.float32),
                                         rng.rand(3).astype(np.float32), refs))
    return bundle


def _photosynther(root):
    ws = root / "ps"
    (ws / "bundle").mkdir(parents=True)
    pbio.save_photosynther_bundle(_synthetic_bundle(3), str(ws / "bundle" / "synth_0.out"))
    _images(str(ws / "undistorted"), ["a.png", "b.png", "c.png"])
    return str(ws)


def _bundler(root, flen_scale=1.0):
    ws = root / "bundler"
    (ws / "bundle").mkdir(parents=True)
    bundle = _synthetic_bundle(3)
    lines = ["# Bundle file v0.3", f"{len(bundle.cameras)} {len(bundle.features)}"]
    for cam in bundle.cameras:
        r = cam.rot.reshape(-1)
        lines += [f"{cam.flen * flen_scale:.9g} {cam.dist[0]:.9g} {cam.dist[1]:.9g}",
                  *(" ".join(f"{v:.9g}" for v in r[k:k + 3]) for k in (0, 3, 6)),
                  " ".join(f"{v:.9g}" for v in cam.trans)]
    for feat in bundle.features:
        lines += [" ".join(f"{v:.9g}" for v in feat.pos),
                  " ".join(str(int(c * 255)) for c in feat.color),
                  f"{len(feat.refs)} " + " ".join(
                      f"{r.view_id} {r.feature_id} {r.pos[0]:.6g} {r.pos[1]:.6g}"
                      for r in feat.refs)]
    (ws / "bundle" / "bundle.out").write_text("\n".join(lines) + "\n")
    _images(str(ws / "images"), ["a.png", "b.png", "c.png"], w=61, h=45)
    (ws / "list.txt").write_text("images/a.png\nimages/b.png 0 800\nimages/c.png\n")
    return str(ws)


def test_nvm_and_colmap_readers(tmp_path):
    for load, path in ((lambda m: m.load_nvm_bundle, _nvm(tmp_path / "n")),
                       (lambda m: m.load_colmap_bundle, _colmap_txt(tmp_path / "t")),
                       (lambda m: m.load_colmap_bundle, _colmap_workspace(tmp_path / "w"))):
        jb, jmeta = load(jbio)(path)
        pb, pmeta = load(pbio)(path)
        _assert_bundles_equal(jb, pb)
        assert pmeta == jmeta


def test_photosynther_and_bundler_readers(tmp_path):
    for fn, path in (("load_photosynther_bundle", "ps/bundle/synth_0.out"),
                     ("load_bundler_bundle", "bundler/bundle/bundle.out")):
        _photosynther(tmp_path) if fn.startswith("load_ph") else _bundler(tmp_path)
        _assert_bundles_equal(getattr(jbio, fn)(str(tmp_path / path)),
                              getattr(pbio, fn)(str(tmp_path / path)))
    bundle = pbio.load_photosynther_bundle(str(tmp_path / "ps/bundle/synth_0.out"))
    pbio.save_photosynther_bundle(bundle, str(tmp_path / "p.out"))
    jbio.save_photosynther_bundle(bundle, str(tmp_path / "j.out"))
    assert (tmp_path / "p.out").read_bytes() == (tmp_path / "j.out").read_bytes()


def test_colmap_depth_map(tmp_path):
    ws = _colmap_workspace(tmp_path)
    path = os.path.join(ws, "stereo", "depth_maps", "img0.png.geometric.bin")
    np.testing.assert_array_equal(pbio.parse_colmap_depth_map(path),
                                  jbio.parse_colmap_depth_map(path))
    cam = pbio.load_colmap_bundle(ws)[0].cameras[0]
    for scale in (0, 1, 2):
        np.testing.assert_array_equal(pbio.load_colmap_depth_map(scale, cam, 64, 48, path),
                                      jbio.load_colmap_depth_map(scale, cam, 64, 48, path))


@pytest.mark.parametrize("kind,flags", [
    ("nvm", []), ("colmap_txt", []), ("colmap_ws", ["-s", "1"]), ("colmap_ws", ["-s", "0"]),
    ("photosynther", []), ("photosynther", ["-k"]),
    ("bundler", ["-o"]), ("bundler", ["-k"]), ("bundler_px", [])])
def test_makescene_importers(tmp_path, kind, flags):
    src = {"nvm": _nvm, "colmap_txt": _colmap_txt, "colmap_ws": _colmap_workspace,
           "photosynther": _photosynther, "bundler": _bundler,
           "bundler_px": lambda r: _bundler(r, flen_scale=700.0)}[kind](tmp_path / "in")
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    assert japp.main([*flags, src, jdir]) == 0
    assert papp.main([*flags, src, pdir, "--device", "cpu"]) == 0
    assert compare_trees(jdir, pdir) == 0
