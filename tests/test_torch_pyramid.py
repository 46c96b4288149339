"""The port's MVS image pyramid cache (mve_tpu_torch/mvs/pyramid.py).

mve_tpu's cache keys its level images on id(scene). A Scene made after
another was freed can take its address and then gets the freed scene's
images (in the 20 scenes below, mve_tpu's cache serves a stale image 19
times). The port holds a weak reference to the scene instead.

Level images: the CPU path (numpy) is held bit for bit to
half_size_gaussian_np applied `level` times to pyramid._to_gray, and so is
a numpy copy of the CUDA kernel's arithmetic (csrc/pyramid.cu: clamped
indices, dx then dy, each product and sum rounded). The kernel itself is
held to the numpy path by the test marked `chip`, which needs a card and
imports no JAX: on the card, `python -m pytest --noconftest -m chip
tests/test_torch_pyramid.py`.

Prefetch: a view's missing images are decoded together on host threads
(the decodes meet at a barrier that a serial decode never reaches), the
levels and everything _prepare_view returns are bit-identical with and
without it, a broken neighbour PNG raises what the inline decode raises
with no decode left running, and images_prefetched counts the images
that came from the pool.
"""

import functools
import os
import shutil
import threading

import numpy as np
import pytest
import torch

from mve_tpu_torch import synthetic
from mve_tpu_torch.core import Bundle, Feature2D, Feature3D, Scene, View, image_io
from mve_tpu_torch.mvs import Settings
from mve_tpu_torch.mvs import dmrecon as mvs_dmrecon
from mve_tpu_torch.mvs import pyramid as ppyr
from mve_tpu_torch.mvs.pyramid import _to_gray
from mve_tpu_torch.utils import tracing

# Test workers run side by side: one intra-op thread each.
torch.set_num_threads(1)


class _View:
    def __init__(self, img):
        self.img = img

    def get_image(self, embedding):
        return self.img


class _Scene:
    def __init__(self, *imgs):
        self.views = [_View(img) for img in imgs]

    def get_views(self):
        return self.views


def test_pyramid_cache_never_serves_a_freed_scene():
    """Scenes made and freed one after another, each with its own image:
    every scene gets its own level images."""
    ppyr.ImagePyramidCache.cleanup()
    try:
        for i in range(20):
            scene = _Scene(np.full((8, 8), float(i), np.float32))
            got = ppyr.ImagePyramidCache.get_level(scene, 0, "undistorted", 1, lambda img: img)
            assert got.shape == (4, 4) and np.allclose(got, i, rtol=1e-5)
            del scene
    finally:
        ppyr.ImagePyramidCache.cleanup()


# (dtype, channels) of the images image_tools.to_float takes, and sizes
# (H, W): odd by odd, one row, fountain-P11's 2048x3072 cut to 64x96, odd
# by even.
KINDS = {"uint8-rgb": (np.uint8, 3), "uint8-gray": (np.uint8, 1),
         "uint16-rgb": (np.uint16, 3), "float32-rgb": (np.float32, 3)}
SIZES = [(37, 53), (1, 5), (64, 96), (37, 54)]
LEVELS = [0, 1, 2, 3]


def _image(kind, hw, seed=0):
    dtype, c = KINDS[kind]
    rng = np.random.default_rng(seed)
    if dtype == np.float32:
        return rng.random((*hw, c), dtype=np.float32)
    return rng.integers(0, np.iinfo(dtype).max + 1, (*hw, c), dtype=dtype)


def _numpy_path(img, level):
    return functools.reduce(lambda x, _: ppyr.half_size_gaussian_np(x), range(level),
                            _to_gray(img))


def _kernel_order(img, level):
    """csrc/pyramid.cu's arithmetic in numpy float32, one rounding a step."""
    f32 = np.float32
    f = img.astype(f32)
    if img.dtype == np.uint8:
        f = f / f32(255.0)
    elif img.dtype == np.uint16:
        f = f / f32(65535.0)
    plane = f[:, :, 0]
    if img.shape[2] >= 3:
        plane = (f32(0.30) * f[:, :, 0] + f32(0.59) * f[:, :, 1]) + f32(0.11) * f[:, :, 2]
    taps = ppyr.half_size_taps(f32)
    for _ in range(level):
        h, w = plane.shape
        ys, xs = np.arange((h + 1) // 2), np.arange((w + 1) // 2)
        acc = np.zeros((len(ys), len(xs)), f32)
        for dy in range(4):
            rows = plane[np.clip(2 * ys + dy - 1, 0, h - 1)]
            inner = np.zeros_like(acc)
            for dx in range(4):
                inner = inner + taps[dx] * rows[:, np.clip(2 * xs + dx - 1, 0, w - 1)]
            acc = acc + taps[dy] * inner
        plane = acc
    return plane


def _same_bits(got, want):
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("hw", SIZES, ids=lambda hw: f"{hw[0]}x{hw[1]}")
@pytest.mark.parametrize("kind", list(KINDS))
def test_cpu_level_is_the_numpy_path(kind, hw, level):
    """get_level on the CPU, asked for every level up to `level` (so the
    finer ones come from its cache), against the numpy path."""
    img = _image(kind, hw)
    want = _numpy_path(img, level)
    assert want.shape == (-(-hw[0] // 2 ** level), -(-hw[1] // 2 ** level))
    ppyr.ImagePyramidCache.cleanup()
    try:
        scene = _Scene(img)
        for lv in range(level + 1):
            got = ppyr.ImagePyramidCache.get_level(scene, 0, "undistorted", lv, _to_gray,
                                                   device="cpu")
        _same_bits(got, want)
    finally:
        ppyr.ImagePyramidCache.cleanup()


@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("hw", SIZES, ids=lambda hw: f"{hw[0]}x{hw[1]}")
@pytest.mark.parametrize("kind", list(KINDS))
def test_kernel_arithmetic_is_the_numpy_path(kind, hw, level):
    img = _image(kind, hw, seed=1)
    _same_bits(_kernel_order(img, level), _numpy_path(img, level))


def test_cpu_counts():
    """images_decoded, halvings and level_hits as before the CUDA path;
    levels_built_on_device 0 on every build."""
    ppyr.ImagePyramidCache.cleanup()
    tracing.clear()
    scene = _Scene(_image("uint8-rgb", (37, 53)), _image("uint8-rgb", (37, 53), seed=2))
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            with tracing.span("test.outer"):
                for view_id, level in ((0, 2), (1, 2), (0, 2), (0, 1), (0, 3), (1, 0)):
                    ppyr.ImagePyramidCache.get_level(scene, view_id, "undistorted", level,
                                                     _to_gray, device="cpu")
        recs = tracing.records()
        loads = [r for r in recs if r.name == "mvs.load_level"]
        total = lambda key: sum(r.counters.get(key, 0) for r in recs)
        assert len(loads) == 3
        assert all(r.counters["levels_built_on_device"] == 0 for r in loads)
        assert (total("images_decoded"), total("halvings"), total("level_hits")) == (2, 5, 3)
    finally:
        tracing.clear()
        ppyr.ImagePyramidCache.cleanup()


def test_cuda_path_takes_only_dmrecons_gray():
    scene = _Scene(_image("uint8-rgb", (8, 8)))
    ppyr.ImagePyramidCache.cleanup()
    try:
        with pytest.raises(ValueError, match="_to_gray"):
            ppyr.ImagePyramidCache.get_level(scene, 0, "undistorted", 1, lambda img: img,
                                             device="cuda")
    finally:
        ppyr.ImagePyramidCache.cleanup()


N_VIEWS = 5


@pytest.fixture(scope="module")
def plane_scene(tmp_path_factory):
    """An on-disk scene of N_VIEWS views of 96x72 (undistorted PNGs of the
    two-plane render) and a bundle of 64 points on the far plane that
    every view sees."""
    path = str(tmp_path_factory.mktemp("prefetch") / "scene")
    tex_far = synthetic.make_texture(seed=0, smooth_sigma=3.0)
    tex_near = synthetic.make_texture(seed=100, smooth_sigma=3.0)
    cams = synthetic.make_cameras(N_VIEWS, spread=0.55)
    scene = Scene.create(path)
    for i, cam in enumerate(cams):
        view = View.create(scene.view_dir_for_id(i), i)
        view.set_camera(cam)
        view.set_image("undistorted",
                       synthetic.render_two_plane_view(tex_far, tex_near, cam, 96, 72))
        scene.add_view(view)
    scene.save_views()
    bundle = Bundle()
    bundle.cameras = cams
    g = np.linspace(-1.6, 1.6, 8)
    for pi, (x, y) in enumerate((x, y) for x in g for y in g):
        refs = [Feature2D(v, pi) for v in range(N_VIEWS)]
        bundle.features.append(Feature3D(np.array([x, y, synthetic.PLANE_Z], np.float32),
                                         np.full(3, 0.5, np.float32), refs))
    scene.set_bundle(bundle)
    scene.save_scene()
    return path


@pytest.fixture
def fresh_cache():
    ppyr.ImagePyramidCache.cleanup()
    tracing.clear()
    yield
    tracing.clear()
    ppyr.ImagePyramidCache.cleanup()


def _levels(scene, ids, level, prefetch):
    if prefetch:
        ppyr.ImagePyramidCache.prefetch(scene, ids, "undistorted", level)
    return [ppyr.ImagePyramidCache.get_level(scene, v, "undistorted", level, _to_gray)
            for v in ids]


def test_prefetched_decodes_overlap(plane_scene, fresh_cache, monkeypatch):
    """Every decode of a view's misses waits at a barrier of min(misses,
    CPUs) parties before it reads its file: a serial decode breaks it by
    the timeout."""
    ids = list(range(N_VIEWS))
    barrier = threading.Barrier(min(len(ids), len(os.sched_getaffinity(0))), timeout=30)
    load = image_io.load_image

    def meeting_load(path):
        barrier.wait()
        return load(path)

    monkeypatch.setattr(image_io, "load_image", meeting_load)
    got = _levels(Scene(plane_scene), ids, 1, prefetch=True)
    monkeypatch.setattr(image_io, "load_image", load)
    ppyr.ImagePyramidCache.cleanup()
    for a, b in zip(got, _levels(Scene(plane_scene), ids, 1, prefetch=False)):
        _same_bits(a, b)


@pytest.mark.parametrize("level", [0, 1])
def test_prepared_views_are_bit_identical_with_prefetch(plane_scene, level, monkeypatch):
    """_prepare_view of every view, each on a fresh cache and a newly
    opened scene, with and without the prefetch: every array and number
    it returns (the levels, and the operators in the order of the
    selected neighbours) bit for bit."""
    def prepare(view_id):
        ppyr.ImagePyramidCache.cleanup()
        scene = Scene(plane_scene)
        s = Settings(scale=level)
        views, positions, vis, full_sizes = mvs_dmrecon._scene_inputs(scene, s)
        return mvs_dmrecon._prepare_view(scene, s, views, positions, vis, full_sizes,
                                         view_id, "cpu")

    def same(a, b):
        if isinstance(a, dict):
            assert a.keys() == b.keys()
            for k in a:
                same(a[k], b[k])
        elif isinstance(a, (list, tuple)):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                same(x, y)
        elif isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
        else:
            assert a == b

    try:
        for view_id in range(N_VIEWS):
            with_prefetch = prepare(view_id)
            assert with_prefetch["n_selected"] == N_VIEWS - 1
            with monkeypatch.context() as mp:
                mp.setattr(ppyr.ImagePyramidCache, "prefetch", lambda *a: None)
                same(with_prefetch, prepare(view_id))
    finally:
        ppyr.ImagePyramidCache.cleanup()


@pytest.mark.parametrize("fault", ["missing", "corrupt"])
def test_a_broken_neighbour_raises_as_inline(plane_scene, fault, tmp_path, fresh_cache,
                                             monkeypatch):
    """Neighbour 1's PNG missing or corrupt: the prefetched load raises
    the inline decode's exception (type and message) at that view, and
    only after every other decode of the view has ended."""
    path = str(tmp_path / "scene")
    shutil.copytree(plane_scene, path)
    # Both scenes list the PNG before it breaks.
    inline_scene, scene = Scene(path), Scene(path)
    png = os.path.join(scene.view_dir_for_id(1), "undistorted.png")
    if fault == "missing":
        os.unlink(png)
    else:
        with open(png, "wb") as f:
            f.write(b"\\x89PNG\\r\\n\\x1a\\n not a PNG")
    load = image_io.load_image

    def slow_load(p):
        if p != png:
            threading.Event().wait(0.2)
        return load(p)

    monkeypatch.setattr(image_io, "load_image", slow_load)
    ids = list(range(N_VIEWS))
    with pytest.raises(Exception) as inline:
        _levels(inline_scene, ids, 1, prefetch=False)
    assert isinstance(inline.value, OSError)
    ppyr.ImagePyramidCache.cleanup()
    ppyr.ImagePyramidCache.prefetch(scene, ids, "undistorted", 1)
    futures = list(ppyr.ImagePyramidCache._pending.values())
    assert len(futures) == N_VIEWS
    with pytest.raises(type(inline.value)) as prefetched:
        _levels(scene, ids, 1, prefetch=False)
    assert str(prefetched.value) == str(inline.value)
    assert all(f.done() for f in futures) and not ppyr.ImagePyramidCache._pending


def test_images_prefetched_counts_the_pools_images(plane_scene, fresh_cache):
    """Three misses come from the pool; then a lone miss among four
    hits is decoded inline; a repeated id is one miss."""
    scene = Scene(plane_scene)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with tracing.span("test.outer"):
            _levels(scene, [0, 1, 2, 1], 1, prefetch=True)
        with tracing.span("test.outer"):
            _levels(scene, [0, 1, 2, 3], 1, prefetch=True)
    first, second = ([r for r in tracing.records() if r.call == outer.id]
                     for outer in tracing.records() if outer.name == "test.outer")
    for recs, decoded, prefetched, hits in ((first, 3, 3, 1), (second, 1, 0, 3)):
        total = lambda key: sum(r.counters.get(key, 0) for r in recs)  # noqa: E731
        loads = [r for r in recs if r.name == "mvs.load_level"]
        assert len(loads) == decoded
        assert all("images_prefetched" in r.counters for r in loads)
        assert (total("images_decoded"), total("images_prefetched"),
                total("level_hits")) == (decoded, prefetched, hits)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the level kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.chip
def test_kernel_is_the_numpy_path_on_the_card(card):
    """Every kind, size and level above, and both cells' image sizes at
    level 2: the kernels' levels bit for bit, the launch count rising, and
    get_level on the card counting levels_built_on_device per decode."""
    from mve_tpu_torch.ops import pyramid as pyramid_ops

    taps = ppyr.half_size_taps(np.float32)
    cases = [(k, hw, lv) for k in KINDS for hw in SIZES for lv in LEVELS]
    cases += [("uint8-rgb", (2048, 3072), 2), ("uint8-rgb", (1200, 1600), 2)]
    for kind, hw, level in cases:
        img = _image(kind, hw, seed=3)
        before = pyramid_ops.launches
        got = pyramid_ops.level_image(torch.from_numpy(img).to(card), level, taps)
        assert pyramid_ops.launches - before == max(level, 1)
        _same_bits(got.cpu().numpy(), _numpy_path(img, level))
    scene = _Scene(_image("uint8-rgb", (37, 53)), _image("uint16-rgb", (37, 54)))
    ppyr.ImagePyramidCache.cleanup()
    tracing.clear()
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            with tracing.span("test.outer"):
                for view_id in (0, 1, 0):
                    got = ppyr.ImagePyramidCache.get_level(scene, view_id, "undistorted", 2,
                                                           _to_gray, device=card)
        _same_bits(got, _numpy_path(scene.views[0].img, 2))
        recs = tracing.records()
        total = lambda key: sum(r.counters.get(key, 0) for r in recs)
        assert total("levels_built_on_device") == total("images_decoded") == 2
        assert total("level_hits") == 1 and total("images_prefetched") == 0
        # Prefetched: the pool decodes, the card builds each level in turn.
        imgs = [_image(kind, (37 + k, 53 - k), seed=4 + k) for k, kind in enumerate(KINDS)]
        scene = _Scene(*imgs)
        ppyr.ImagePyramidCache.cleanup()
        tracing.clear()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            with tracing.span("test.outer"):
                ppyr.ImagePyramidCache.prefetch(scene, range(len(imgs)), "undistorted", 2)
                for view_id, img in enumerate(imgs):
                    got = ppyr.ImagePyramidCache.get_level(scene, view_id, "undistorted", 2,
                                                           _to_gray, device=card)
                    _same_bits(got, _numpy_path(img, 2))
        recs = tracing.records()
        assert total("images_prefetched") == total("levels_built_on_device") == len(imgs)
    finally:
        tracing.clear()
        ppyr.ImagePyramidCache.cleanup()
