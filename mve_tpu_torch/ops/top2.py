"""Wrapper of the CUDA top-2 kernel (csrc/top2.cu), the port of
mve_tpu/ops/pallas_matching.py:_top2_kernel.

A CUDA tensor launches the kernel or raises; a CPU tensor runs the plain
version in ops/matching.py. `launches` counts kernel launches (and
nothing else), so a run can show that its matching went through the
kernel.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .matching import descriptor_top2, descriptor_top2_pairs

launches = 0

_DIMS = (64, 128)
_MAX_PAIRS_PER_LAUNCH = 65535  # gridDim.y limit


def _lib():
    lib = cuda_build.load("top2")
    fn = lib.top2_launch
    if fn.argtypes is None:
        P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [P, P, P, P, P, I, I, I, I, LL, LL, I, P, P, P, P]
        fn.restype = ctypes.c_int
    return fn


def _check_desc(name, t):
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.shape[-1] not in _DIMS:
        raise ValueError(f"{name}: descriptor width {t.shape[-1]} not in {_DIMS}")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data must be 16-byte aligned")


def _launch(q, r, pa, pb, nd, n_refs, n_pairs, nq, d, q_stride, r_stride,
            bf16, idx, d1, d2):
    global launches
    err = _lib()(q, r, pa, pb, nd, n_refs, n_pairs, nq, d, q_stride, r_stride,
                 int(bf16), idx, d1, d2, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"top2 kernel launch failed: CUDA error {err}")
    launches += 1


def top2(query: torch.Tensor, refs: torch.Tensor, n_refs: int, bf16: bool):
    """Best reference per query row among the first n_refs rows of refs.

    query (N1, D), refs (N2, D), D in {64, 128}. Returns (idx int32,
    dist1, dist2), each (N1,): dist = 2 - 2*dot, ties to the lowest index.
    bf16 rounds the inputs to bf16 and accumulates in float32.
    """
    if query.device != refs.device:
        raise ValueError("query and refs must be on the same device")
    if not query.is_cuda:
        return descriptor_top2(query, refs, n_refs=n_refs, use_bf16=bf16)
    _check_desc("query", query)
    _check_desc("refs", refs)
    if query.dim() != 2 or refs.dim() != 2 or query.shape[1] != refs.shape[1]:
        raise ValueError(f"shapes {tuple(query.shape)} and {tuple(refs.shape)} do not match")
    n_refs = int(n_refs)
    if not 0 <= n_refs <= refs.shape[0]:
        raise ValueError(f"n_refs={n_refs} outside [0, {refs.shape[0]}]")
    n1, d = query.shape
    idx = torch.empty(n1, dtype=torch.int32, device=query.device)
    d1 = torch.empty(n1, dtype=torch.float32, device=query.device)
    d2 = torch.empty(n1, dtype=torch.float32, device=query.device)
    _launch(query.data_ptr(), refs.data_ptr(), None, None, None, n_refs, 1, n1, d,
            0, 0, bf16, idx.data_ptr(), d1.data_ptr(), d2.data_ptr())
    return idx, d1, d2


def top2_pairs(desc: torch.Tensor, n_desc: torch.Tensor, pair_a: torch.Tensor,
               pair_b: torch.Tensor, bf16: bool):
    """top2 for every pair p: desc[pair_a[p]] against desc[pair_b[p]],
    whose rows past n_desc[pair_b[p]] are excluded. Query rows past
    n_desc[pair_a[p]] are computed and left to the caller.

    desc (V, N, D) float32, n_desc (V,), pair_a/pair_b (P,) int32.
    Returns (idx int32, dist1, dist2), each (P, N).
    """
    if not (desc.device == n_desc.device == pair_a.device == pair_b.device):
        raise ValueError("desc, n_desc and the pair lists must be on one device")
    if not desc.is_cuda:
        return descriptor_top2_pairs(desc, n_desc, pair_a, pair_b, use_bf16=bf16)
    _check_desc("desc", desc)
    if desc.dim() != 3:
        raise ValueError(f"desc must be (V, N, D), got {tuple(desc.shape)}")
    V, N, D = desc.shape
    for name, t, n in (("n_desc", n_desc, V), ("pair_a", pair_a, None),
                       ("pair_b", pair_b, None)):
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous 1-D int32 tensor")
        if n is not None and t.shape[0] != n:
            raise ValueError(f"{name}: expected {n} entries, got {t.shape[0]}")
    P = pair_a.shape[0]
    if pair_b.shape[0] != P:
        raise ValueError("pair_a and pair_b differ in length")
    # Out-of-range values would read outside desc: check on the host.
    if V and (int(n_desc.min()) < 0 or int(n_desc.max()) > N):
        raise ValueError(f"n_desc outside [0, {N}]")
    if P and (min(int(pair_a.min()), int(pair_b.min())) < 0
              or max(int(pair_a.max()), int(pair_b.max())) >= V):
        raise ValueError(f"pair index outside [0, {V})")
    idx = torch.empty((P, N), dtype=torch.int32, device=desc.device)
    d1 = torch.empty((P, N), dtype=torch.float32, device=desc.device)
    d2 = torch.empty((P, N), dtype=torch.float32, device=desc.device)
    for c0 in range(0, P, _MAX_PAIRS_PER_LAUNCH):
        n = min(_MAX_PAIRS_PER_LAUNCH, P - c0)
        out = c0 * N
        _launch(desc.data_ptr(), desc.data_ptr(), pair_a[c0:].data_ptr(),
                pair_b[c0:].data_ptr(), n_desc.data_ptr(), 0, n, N, D, N * D, N * D,
                bf16, idx.data_ptr() + 4 * out, d1.data_ptr() + 4 * out,
                d2.data_ptr() + 4 * out)
    return idx, d1, d2
