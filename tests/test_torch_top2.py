"""Parity of the port's descriptor top-2 (mve_tpu_torch.ops) with
mve_tpu's, on the CPU.

The JAX side runs as tests/test_pallas_matching.py runs it:
ops.matching.descriptor_top2 (the XLA path) and, for the tile shapes,
descriptor_top2_pallas in interpret mode. The port's CUDA kernel itself
is held against its plain version on the card by chip_smoke.py; here the
wrappers route CPU tensors to that plain version, whose count masking and
tie order are checked directly.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mve_tpu.ops.matching import descriptor_top2 as jax_top2
from mve_tpu.ops.pallas_matching import descriptor_top2_pallas, TM, TN
from mve_tpu.sfm.matching import _pad_rows

import mve_tpu_torch
from mve_tpu_torch.ops import top2 as top2_mod
from mve_tpu_torch.ops.matching import descriptor_top2, descriptor_top2_pairs

# Test workers run side by side: one intra-op thread each keeps torch's
# OpenMP pool from oversubscribing the cores.
torch.set_num_threads(1)


def _unit_descriptors(n, d=128, seed=0):
    x = np.random.RandomState(seed).rand(n, d).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _port(q, r, n_refs=None, use_bf16=False):
    out = descriptor_top2(torch.from_numpy(q), torch.from_numpy(r),
                          n_refs=n_refs, use_bf16=use_bf16)
    return tuple(t.numpy() for t in out)


@pytest.mark.parametrize("n1,n2", [(TM, TN), (2 * TM, 2 * TN)])
def test_plain_top2_matches_jax_exact_tiles(n1, n2):
    """f32: identical indices, distances within 1e-5, against both the
    XLA path and the Pallas kernel (interpret mode)."""
    q = _unit_descriptors(n1, seed=1)
    r = _unit_descriptors(n2, seed=2)
    idx, d1, d2 = _port(q, r)
    for ref in (jax_top2(jnp.asarray(q), jnp.asarray(r)),
                descriptor_top2_pallas(jnp.asarray(q), jnp.asarray(r),
                                       interpret=True, bf16=False)):
        np.testing.assert_array_equal(idx, np.asarray(ref[0]))
        np.testing.assert_allclose(d1, np.asarray(ref[1]), atol=1e-5)
        np.testing.assert_allclose(d2, np.asarray(ref[2]), atol=1e-5)


@pytest.mark.parametrize("n1,n2", [(37, 91), (300, 700), (TM + 1, TN - 1)])
@pytest.mark.parametrize("d", [128, 64])
def test_plain_top2_matches_jax_ragged(n1, n2, d):
    """Padded references masked by count, as mve_tpu's CPU path does;
    f32: identical indices, distances within 1e-5."""
    q = _unit_descriptors(n1, d, seed=3)
    r = _unit_descriptors(n2, d, seed=4)
    qp, rp = _pad_rows(q), _pad_rows(r)
    ref = [np.asarray(a)[:n1] for a in jax_top2(jnp.asarray(qp), jnp.asarray(rp), n_refs=n2)]
    got = [a[:n1] for a in _port(qp, rp, n_refs=n2)]
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_allclose(got[1], ref[1], atol=1e-5)
    np.testing.assert_allclose(got[2], ref[2], atol=1e-5)


def test_plain_top2_single_real_reference():
    """One real reference among padding: idx 0 and an infinite runner-up
    distance in both packages (count masking, not zero vectors)."""
    q = _unit_descriptors(5, seed=5)
    rp = _pad_rows(q[:1] + 0.0)
    ref = [np.asarray(a)[:5] for a in jax_top2(jnp.asarray(_pad_rows(q)), jnp.asarray(rp), n_refs=1)]
    got = [a[:5] for a in _port(_pad_rows(q), rp, n_refs=1)]
    np.testing.assert_array_equal(got[0], 0)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_allclose(got[1], ref[1], atol=1e-5)
    assert np.isinf(got[2]).all() and np.isinf(ref[2]).all()
    np.testing.assert_allclose(got[1][0], 0.0, atol=1e-5)


@pytest.mark.parametrize("n1,n2", [(TM, TN), (300, 700)])
def test_plain_top2_bf16_matches_jax(n1, n2):
    """bf16 inputs with f32 accumulation (ops/matching.py:31-34): at
    least 99.5% identical nearest-neighbour indices."""
    q = _unit_descriptors(n1, seed=6)
    r = _unit_descriptors(n2, seed=7)
    ref = np.asarray(jax_top2(jnp.asarray(q), jnp.asarray(r), use_bf16=True)[0])
    got = _port(q, r, use_bf16=True)[0]
    assert (got == ref).mean() >= 0.995


@pytest.mark.parametrize("d", [128, 64])
def test_wrapper_on_cpu_routes_to_plain_version(d):
    """top2 on CPU tensors is the plain version: rows past n_refs never
    win even when they would score best, and an all-equal row picks
    index 0 with second == best."""
    q = torch.from_numpy(_unit_descriptors(40, d, seed=8))
    r = torch.cat([torch.from_numpy(_unit_descriptors(30, d, seed=9)), q[:10]])
    before = top2_mod.launches
    idx, d1, d2 = top2_mod.top2(q, r, 30, bf16=False)
    want = descriptor_top2(q, r, n_refs=30)
    for a, b in zip((idx, d1, d2), want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert int(idx.max()) < 30
    assert top2_mod.launches == before  # no kernel on the CPU

    same = torch.from_numpy(_unit_descriptors(1, d, seed=10)).repeat(25, 1)
    idx, d1, d2 = top2_mod.top2(q, same, 25, bf16=False)
    assert (idx == 0).all()
    torch.testing.assert_close(d1, d2, rtol=0, atol=0)


@pytest.mark.parametrize("d", [128, 64])
def test_top2_pairs_on_cpu_matches_jax_per_pair(d):
    """top2_pairs on CPU tensors equals mve_tpu's descriptor_top2 run per
    pair with n_refs = the reference view's count, in both directions."""
    V, N = 4, 150
    counts = [150, 97, 1, 120]
    desc = np.zeros((V, N, d), np.float32)
    for v, n in enumerate(counts):
        desc[v, :n] = _unit_descriptors(n, d, seed=20 + v)
    pairs = [(a, b) for b in range(V) for a in range(b)]
    pa = torch.tensor([a for a, _ in pairs], dtype=torch.int32)
    pb = torch.tensor([b for _, b in pairs], dtype=torch.int32)
    n_desc = torch.tensor(counts, dtype=torch.int32)
    for x, y in ((pa, pb), (pb, pa)):
        idx, d1, d2 = top2_mod.top2_pairs(torch.from_numpy(desc), n_desc, x, y, bf16=False)
        for k in range(len(pairs)):
            a, b = int(x[k]), int(y[k])
            ref = jax_top2(jnp.asarray(desc[a]), jnp.asarray(desc[b]), n_refs=counts[b])
            rows = slice(0, counts[a])
            np.testing.assert_array_equal(idx[k, rows].numpy(), np.asarray(ref[0])[rows])
            np.testing.assert_allclose(d1[k, rows].numpy(), np.asarray(ref[1])[rows], atol=1e-5)
            np.testing.assert_allclose(d2[k, rows].numpy(), np.asarray(ref[2])[rows], atol=1e-5)
    plain = descriptor_top2_pairs(torch.from_numpy(desc), n_desc, pa, pb)
    got = top2_mod.top2_pairs(torch.from_numpy(desc), n_desc, pa, pb, bf16=False)
    for a, b in zip(got, plain):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_devices_must_agree_and_cuda_is_never_implied():
    q = torch.zeros(4, 128)
    with pytest.raises(ValueError):
        top2_mod.top2(q, torch.zeros(4, 128, device="meta"), 4, bf16=False)
    if torch.cuda.is_available():
        return  # the CUDA default is legitimate where a card exists
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mve_tpu_torch.resolve_device("cuda")
    assert mve_tpu_torch.resolve_device("cpu").type == "cpu"
