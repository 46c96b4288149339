"""Parity of the port's matchers with mve_tpu's, on the CPU.

Both packages match the SAME features: descriptors computed by mve_tpu,
handed to the port through mve_tpu_torch.interop, so this does not
depend on feature parity. Both batched matchers (sfmrecon's default) and
both per-pair matchers run on a 3-view 320x240 two-plane scene.

Tolerance: the same connected pairs, and at least 99% of each pair's
verified matches identical. Identical is what is expected; the margin
covers LAPACK SVD differences between the two packages' builds for
points that sit on the Sampson threshold.
"""

import numpy as np
import pytest
import torch

from mve_tpu.sfm.bundler.features import Features as JaxFeatures
from mve_tpu.sfm.bundler.common import Viewport as JaxViewport
from mve_tpu.sfm.bundler.matching import Matching as JaxMatching
from mve_tpu.sfm.bundler.matching import MatchingOptions as JaxMatchingOptions
from mve_tpu.sfm.bundler.matching_batched import BatchedMatching as JaxBatchedMatching
from mve_tpu.sfm.ransac import _sample_indices as jax_sample_indices

from mve_tpu_torch import interop, synthetic
from mve_tpu_torch.sfm.bundler.matching import Matching, MatchingOptions
from mve_tpu_torch.sfm.bundler.matching_batched import BatchedMatching
from mve_tpu_torch.sfm.matching import use_bf16
from mve_tpu_torch.sfm.ransac import _sample_indices

# Test workers run side by side: one intra-op thread each keeps torch's
# OpenMP pool from oversubscribing the cores.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jax_viewports():
    tex_far = synthetic.make_texture(seed=3, smooth_sigma=3.0)
    tex_near = synthetic.make_texture(seed=103, smooth_sigma=3.0)
    cams = synthetic.make_cameras(3, spread=0.55, seed=3)
    imgs = [synthetic.render_two_plane_view(tex_far, tex_near, c, 320, 240) for c in cams]
    vps = [JaxViewport() for _ in imgs]
    JaxFeatures().compute_batched(imgs, vps)
    return vps


@pytest.fixture(scope="module")
def port_viewports(jax_viewports):
    return interop.viewports_from_numpy(
        [{k: getattr(vp, k) for k in interop.VIEWPORT_FIELDS} for vp in jax_viewports])


def _assert_same_matching(got, ref):
    assert [(m.view_1_id, m.view_2_id) for m in got] == \
        [(m.view_1_id, m.view_2_id) for m in ref]
    for g, r in zip(got, ref):
        gs, rs = set(map(tuple, g.matches)), set(map(tuple, r.matches))
        assert len(gs & rs) >= 0.99 * len(rs), (g.view_1_id, g.view_2_id)
        assert len(gs) <= 1.01 * len(rs) + 1


@pytest.mark.parametrize("lowres", [True, False])
def test_batched_matching_matches_jax(jax_viewports, port_viewports, lowres):
    ref = JaxBatchedMatching(JaxMatchingOptions(use_lowres_matching=lowres)).compute(
        jax_viewports, seed=0)
    matcher = BatchedMatching(MatchingOptions(use_lowres_matching=lowres), device="cpu")
    got = matcher.compute(port_viewports, seed=0)
    assert len(ref) == 3
    _assert_same_matching(got, ref)
    assert matcher.last_stats["n_pairs"] == 3
    assert matcher.last_stats["sift_bucket"] == max(len(v.descriptors) for v in port_viewports)


def test_per_pair_matching_matches_jax(jax_viewports, port_viewports):
    ref = JaxMatching(JaxMatchingOptions()).compute(jax_viewports, seed=0)
    got = Matching(MatchingOptions(), device="cpu").compute(port_viewports, seed=0)
    assert len(ref) == 3
    _assert_same_matching(got, ref)


@pytest.mark.parametrize("n,batch", [(9, 50), (12, 20), (300, 1000)])
def test_ransac_samples_drawn_draw_for_draw(n, batch):
    """Same seed, same minimal samples: the exact small-n path and the
    redraw-on-collision path of mve_tpu's _sample_indices."""
    got = _sample_indices(np.random.RandomState(5), n, 8, batch)
    ref = jax_sample_indices(np.random.RandomState(5), n, 8, batch)
    np.testing.assert_array_equal(got, ref)


def test_interop_round_trip(jax_viewports, port_viewports):
    for j, p in zip(jax_viewports, port_viewports):
        for k in interop.VIEWPORT_FIELDS:
            np.testing.assert_array_equal(np.asarray(getattr(p, k)), np.asarray(getattr(j, k)))
    sift_opts, surf_opts, mopts, *_ = interop.options_from_dict({
        "sift": {"max_keypoints_per_octave": 2048},
        "surf": {"contrast_threshold": 400.0},
        "matching": {"lowe_ratio": 0.7, "ransac_opts": {"threshold": 0.002}}})
    assert sift_opts.max_keypoints_per_octave == 2048
    assert surf_opts.contrast_threshold == 400.0
    assert mopts.lowe_ratio == 0.7 and mopts.ransac_opts.threshold == 0.002
    with pytest.raises(ValueError):
        interop.options_from_dict({"matching": {"use_cascade_hashing": True}})


@pytest.mark.parametrize("device,d,want", [("cuda", 128, True), ("cuda", 64, False),
                                           ("cpu", 128, False), ("cpu", 64, False)])
def test_per_pair_precision_choice(device, d, want):
    """The per-pair matcher scores in bf16 only on a CUDA device and for
    D % 128 == 0 (mve_tpu/sfm/matching.py:60); SURF's 64-D descriptors
    stay float32. A device object is enough: nothing is launched."""
    assert use_bf16(torch.device(device), d) is want
