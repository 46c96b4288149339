"""The port's cascade-hashing matcher against mve_tpu's, on the CPU.

A code bit is the sign of a float32 product, which the two packages sum
in different orders: a product within rounding of zero can flip. The
tests count such bits (and check that each flipped product is within
1e-5 of zero) instead of hiding them. The Hamming top-k must follow
jax.lax.top_k's order among ties (the lower index first), which a
constructed input of all-equal distances checks.

Tolerances: with no bit flipped, the matches of two sets of 400
descriptors are identical in both directions; the per-pair matcher with
use_cascade_hashing on a 3-view scene keeps the same connected pairs and
at least 99% of each pair's verified matches (the margin of
test_torch_matching.py, for RANSAC's Sampson threshold).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mve_tpu.sfm import cascade_hashing as jch
from mve_tpu.sfm.bundler.common import Viewport as JaxViewport
from mve_tpu.sfm.bundler.features import Features as JaxFeatures
from mve_tpu.sfm.bundler.matching import Matching as JaxMatching
from mve_tpu.sfm.bundler.matching import MatchingOptions as JaxMatchingOptions
from mve_tpu.sfm.matching import MatchingOptions as JMO

from mve_tpu_torch import interop, synthetic
from mve_tpu_torch.sfm import cascade_hashing as pch
from mve_tpu_torch.sfm.bundler.matching import Matching, MatchingOptions
from mve_tpu_torch.sfm.matching import MatchingOptions as PMO

torch.set_num_threads(1)


def _descriptor_sets(n=400, seed=0):
    """Two sets where set 2 is a permuted, noisy copy of set 1."""
    rng = np.random.RandomState(seed)
    d1 = rng.randn(n, 128).astype(np.float32)
    d1 /= np.linalg.norm(d1, axis=1, keepdims=True)
    perm = rng.permutation(n)
    d2 = d1[perm] + rng.randn(n, 128).astype(np.float32) * 0.05
    d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
    return d1, d2, perm


@pytest.fixture(scope="module")
def hashers():
    sets = _descriptor_sets()[:2]
    j = jch.CascadeHashing()
    j.init(list(sets))
    p = pch.CascadeHashing(device="cpu")
    p.init(list(sets))
    return sets, j, p


def test_projection_and_mean_are_mve_tpus(hashers):
    _, j, p = hashers
    np.testing.assert_array_equal(p.proj, j.proj)
    np.testing.assert_array_equal(p._mean, j._mean)


def test_codes_equal_but_for_counted_flips(hashers):
    sets, j, p = hashers
    flipped = 0
    for i, d in enumerate(sets):
        want, got = j._codes[i], p.codes(i)
        assert got.dtype == np.uint32 and got.shape == want.shape == (len(d), 4)
        x = got ^ want
        bits = (x[..., None] >> np.arange(32, dtype=np.uint32)) & 1
        rows, lanes, pos = np.nonzero(bits)
        flipped += len(rows)
        # each flipped bit's product is rounding noise around zero
        z = (d.astype(np.float64) - j._mean) @ j.proj.astype(np.float64)
        assert np.all(np.abs(z[rows, lanes * 32 + pos]) < 1e-5)
    # 102,400 bits: none flips on this input.
    assert flipped == 0


def test_popcount_and_hamming():
    rng = np.random.RandomState(4)
    x = rng.randint(0, 2**32, size=(200, 4), dtype=np.uint64).astype(np.int64)
    x[0] = 0
    x[1] = 2**32 - 1
    want = np.array([[bin(int(v)).count("1") for v in row] for row in x])
    np.testing.assert_array_equal(pch.popcount32(torch.from_numpy(x)).numpy(), want)
    c1, c2 = x[:50], x[50:]
    jham = np.asarray(jnp.sum(jax.lax.population_count(
        jnp.asarray(c1.astype(np.uint32))[:, None] ^ jnp.asarray(c2.astype(np.uint32))[None]),
        axis=-1))
    np.testing.assert_array_equal(
        pch.hamming(torch.from_numpy(c1), torch.from_numpy(c2)).numpy(), jham)


@pytest.mark.parametrize("k", [1, 5, 10])
def test_candidates_follow_top_k_on_ties(k):
    # All distances equal: the candidates are the k lowest indices.
    ham = torch.zeros((7, 37), dtype=torch.int64)
    want = np.asarray(jax.lax.top_k(-jnp.zeros((7, 37), jnp.int32), k)[1])
    got = pch.hamming_candidates(ham, k).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.broadcast_to(np.arange(k), (7, k)))
    # Few distinct distances: ties everywhere, the same order as lax.top_k.
    ham = np.random.RandomState(k).randint(0, 3, size=(50, 60))
    want = np.asarray(jax.lax.top_k(-jnp.asarray(ham, jnp.int32), k)[1])
    np.testing.assert_array_equal(pch.hamming_candidates(torch.from_numpy(ham), k).numpy(),
                                  want)


def test_pairwise_match(hashers):
    _, j, p = hashers
    for a, b in ((0, 1), (1, 0)):
        want = j.pairwise_match(a, b, JMO(lowe_ratio_threshold=0.8))
        got = p.pairwise_match(a, b, PMO(lowe_ratio_threshold=0.8))
        for g, w in ((got.matches_1_2, want.matches_1_2), (got.matches_2_1, want.matches_2_1)):
            assert (g >= 0).sum() > 0.9 * len(g)
            np.testing.assert_array_equal(g, w)


def _same_matching(got, ref):
    assert [(m.view_1_id, m.view_2_id) for m in got] == \
        [(m.view_1_id, m.view_2_id) for m in ref]
    for g, r in zip(got, ref):
        gs, rs = set(map(tuple, g.matches)), set(map(tuple, r.matches))
        assert len(gs & rs) >= 0.99 * len(rs), (g.view_1_id, g.view_2_id)
        assert len(gs) <= 1.01 * len(rs) + 1


def test_matching_with_cascade_hashing():
    tex_far = synthetic.make_texture(seed=5, smooth_sigma=3.0)
    tex_near = synthetic.make_texture(seed=105, smooth_sigma=3.0)
    imgs = [synthetic.render_two_plane_view(tex_far, tex_near, c, 240, 180)
            for c in synthetic.make_cameras(3, spread=0.55, seed=5)]
    jvps = [JaxViewport() for _ in imgs]
    JaxFeatures().compute_batched(imgs, jvps)
    pvps = interop.viewports_from_numpy(
        [{k: getattr(vp, k) for k in interop.VIEWPORT_FIELDS} for vp in jvps])
    for lowres in (False, True):
        ref = JaxMatching(JaxMatchingOptions(use_cascade_hashing=True,
                                             use_lowres_matching=lowres)).compute(jvps)
        got = Matching(MatchingOptions(use_cascade_hashing=True, use_lowres_matching=lowres),
                       device="cpu").compute(pvps)
        assert len(ref) == 3
        _same_matching(got, ref)
