"""Parity of the port's SIFT, SURF and image tools with mve_tpu's, on
the CPU, on one 320x240 two-plane view.

Tolerances: at least 99% of mve_tpu's keypoints have a port keypoint
within 0.5 px (of those at the same position, the one with the nearest
orientation is its partner); over the partners the descriptor L2
difference has median <= 1e-3 and 99th percentile <= 0.05. The two
packages sum in different orders (XLA vs ATen), so equality is not
expected; the measured differences are around 1e-5.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mve_tpu.core import image_tools as jax_tools
from mve_tpu.sfm import sift as jax_sift, surf as jax_surf

from mve_tpu_torch import synthetic
from mve_tpu_torch.core import image_tools
from mve_tpu_torch.sfm import sift, surf

# Test workers run side by side: one intra-op thread each keeps torch's
# OpenMP pool from oversubscribing the cores.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def view():
    tex_far = synthetic.make_texture(seed=0, smooth_sigma=3.0)
    tex_near = synthetic.make_texture(seed=100, smooth_sigma=3.0)
    cam = synthetic.make_cameras(2, spread=0.55, seed=0)[1]
    return synthetic.render_two_plane_view(tex_far, tex_near, cam, 320, 240)


def _pair_up(ref, got):
    """Partner in `got` of each keypoint of `ref`: within 0.5 px, nearest
    orientation. Returns (recall, descriptor L2 differences)."""
    pr = np.stack([ref.x, ref.y], 1)
    pg = np.stack([got.x, got.y], 1)
    dist = np.linalg.norm(pr[:, None] - pg[None], axis=-1)
    near = dist < 0.5
    dori = np.abs(np.angle(np.exp(1j * (ref.orientation[:, None] - got.orientation[None]))))
    partner = np.argmin(np.where(near, dori, np.inf), axis=1)
    found = near.any(axis=1)
    diff = np.linalg.norm(ref.descriptors[found] - got.descriptors[partner[found]], axis=1)
    return float(found.mean()), diff


@pytest.mark.parametrize("module", ["sift", "surf"])
def test_features_match_jax(view, module):
    jax_mod, port_mod = {"sift": (jax_sift, sift), "surf": (jax_surf, surf)}[module]
    ref = jax_mod.detect_and_describe_batch([view])[0]
    got = port_mod.detect_and_describe_batch([view], device="cpu")[0]
    assert len(ref) > 100
    recall, diff = _pair_up(ref, got)
    assert recall >= 0.99, f"{module}: keypoint recall {recall:.4f}"
    assert np.median(diff) <= 1e-3, f"{module}: median descriptor diff {np.median(diff)}"
    assert np.percentile(diff, 99) <= 0.05, f"{module}: p99 descriptor diff"
    assert got.descriptors.shape[1] == ref.descriptors.shape[1]
    np.testing.assert_allclose(np.linalg.norm(got.descriptors, axis=1), 1.0, atol=1e-5)


@pytest.mark.parametrize("sigma", [0.7, 1.2262735, 2.5])
def test_blur_gaussian_matches_jax(sigma):
    """Separable blur with edge borders: within 1e-5 of mve_tpu."""
    img = np.random.RandomState(1).rand(37, 53, 2).astype(np.float32)
    ref = np.asarray(jax_tools.blur_gaussian(jnp.asarray(img), sigma))
    got = image_tools.blur_gaussian(torch.from_numpy(img), sigma).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)


@pytest.mark.parametrize("fn", ["rescale_half_size", "rescale_half_size_gaussian"])
def test_half_size_matches_jax(fn):
    img = np.random.RandomState(2).rand(37, 52, 3).astype(np.float32)
    ref = np.asarray(getattr(jax_tools, fn)(jnp.asarray(img)))
    got = getattr(image_tools, fn)(torch.from_numpy(img)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-6)


def test_byte_float_conversions_match_jax(view):
    np.testing.assert_array_equal(image_tools.to_float(view), jax_tools.to_float(view))
    f = image_tools.to_float(view)
    np.testing.assert_array_equal(image_tools.to_byte(f), jax_tools.to_byte(f))


@pytest.fixture(scope="module")
def small_view():
    tex_far = synthetic.make_texture(seed=0, smooth_sigma=3.0)
    tex_near = synthetic.make_texture(seed=100, smooth_sigma=3.0)
    cam = synthetic.make_cameras(2, spread=0.55, seed=0)[1]
    return synthetic.render_two_plane_view(tex_far, tex_near, cam, 160, 120)


def test_first_octave_upsampling_matches_jax(small_view):
    """min_octave=-1 (an octave -1 image of 320x240 from a 160x120 view)
    through mve_tpu's per-image path in both packages, with the keypoint
    agreement of test_features_match_jax, both ways; the upsampled octave
    adds keypoints to those of min_octave=0."""
    opts = dict(min_octave=-1)
    ref = jax_sift.detect_and_describe(small_view, jax_sift.SiftOptions(**opts))
    got = sift.detect_and_describe(small_view, sift.SiftOptions(**opts), device="cpu")
    assert len(ref) > 200
    recall, diff = _pair_up(ref, got)
    back, _ = _pair_up(got, ref)
    assert recall >= 0.99 and back >= 0.99, f"keypoint recall {recall:.4f} / {back:.4f}"
    assert np.median(diff) <= 1e-3 and np.percentile(diff, 99) <= 0.05
    np.testing.assert_allclose(np.linalg.norm(got.descriptors, axis=1), 1.0, atol=1e-5)
    base = sift.detect_and_describe_batch([small_view], device="cpu")[0]
    assert len(got) > len(base)
    assert (got.scale < 1.6).sum() > 0 and (base.scale < 1.6).sum() == 0


@pytest.mark.parametrize("shape", [(23, 31, 3), (31, 23, 3), (40, 40, 1), (17, 16, 2)])
def test_rescale_double_size_bit_identical(shape):
    """jax.image.resize(..., "linear") at 2x renormalises its kernel at
    the borders, where F.interpolate clamps: at exactly 2x both give the
    same weights, but F.interpolate rounds the two taps apart from XLA on
    about 30% of the pixels (1 ulp). The port's two-tap version rounds as
    XLA's CPU dots do and is bit-identical at these sizes."""
    img = np.random.RandomState(4).rand(*shape).astype(np.float32)
    ref = np.asarray(jax_tools.rescale_double_size(jnp.asarray(img)))
    got = image_tools.rescale_double_size(torch.from_numpy(img)).numpy()
    np.testing.assert_array_equal(got, ref)
    t = torch.from_numpy(img).permute(2, 0, 1)[None]
    interp = torch.nn.functional.interpolate(t, scale_factor=2, mode="bilinear",
                                             align_corners=False)[0].permute(1, 2, 0).numpy()
    np.testing.assert_allclose(interp, ref, atol=2e-7)


@pytest.mark.parametrize("fn, args, atol", [
    ("rescale_double_size_supersample", (), 0.0),
    ("resize", (11, 40, "linear"), 2e-7),     # antialiased downsampling rows
    ("resize", (50, 17, "linear"), 2e-7),
    ("resize", (46, 62, "linear"), 2e-7),
    ("resize", (11, 40, "nearest"), 0.0),
    ("resize", (50, 70, "nearest"), 0.0),
    ("blur_boxfilter", (1,), 2e-7),           # F.conv2d sums in another order
    ("blur_boxfilter", (3,), 2e-7),
    ("desaturate", ("luminosity",), 1e-7),
    ("desaturate", ("luminance",), 1e-7),
    ("desaturate", ("lightness",), 1e-7),
    ("desaturate", ("average",), 1e-7),
    ("gamma_correct", (2.2,), 1e-7),
    ("crop", (3, 4, 10, 7), 0.0),
    ("rotate90", (True,), 0.0),
    ("rotate90", (False,), 0.0),
    ("flip", (True, False), 0.0),
    ("flip", (False, True), 0.0),
])
def test_image_tools_match_jax(fn, args, atol):
    img = np.random.RandomState(3).rand(23, 31, 3).astype(np.float32) - 0.1
    ref = np.asarray(getattr(jax_tools, fn)(jnp.asarray(img), *args))
    got = getattr(image_tools, fn)(torch.from_numpy(img), *args).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=atol)


@pytest.mark.parametrize("fn, args, atol", [
    ("image_undistort_vsfm", (1.1, 0.3), 5e-6),    # six Newton steps, fused
    ("image_undistort_vsfm", (0.9, -0.2), 5e-6),   # multiply-adds in XLA
    ("image_undistort_vsfm", (0.9, 0.0), 0.0),
    ("image_undistort_msps", (0.05, -0.02), 1e-7),
    ("image_undistort_msps", (0.05, 0.05), 0.0),
])
def test_undistortion_and_sampling_match_jax(fn, args, atol):
    rng = np.random.RandomState(5)
    img = rng.rand(23, 31, 3).astype(np.float32)
    ref = np.asarray(getattr(jax_tools, fn)(img, *args))
    got = getattr(image_tools, fn)(img, *args, device="cpu")
    np.testing.assert_allclose(got, ref, rtol=0, atol=atol)
    xy = rng.uniform(-2, 33, (40, 2)).astype(np.float32)
    np.testing.assert_array_equal(
        image_tools.bilinear_sample(torch.from_numpy(img), torch.from_numpy(xy)).numpy(),
        np.asarray(jax_tools.bilinear_sample(img, jnp.asarray(xy))))
