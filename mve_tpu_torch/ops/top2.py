"""Wrapper of the CUDA top-2 kernels (csrc/top2.cu), the port of
mve_tpu/ops/pallas_matching.py:_top2_kernel.

A call runs two kernels: the split pre-pass, which puts the operands in
the type the tensor cores read (TF32 hi/lo parts for float32, bf16 for
bf16), and the product with its top-2 fold on the tensor cores. A CUDA
tensor launches them or raises; a CPU tensor runs the plain version in
ops/matching.py. `launches` counts launches of the product kernel and
`split_launches` those of the pre-pass (and nothing else), so a run can
show that its matching went through the kernels.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from . import cuda_build
from .matching import descriptor_top2, descriptor_top2_pairs

launches = 0
split_launches = 0

_DIMS = (64, 128)
_MAX_PAIRS_PER_LAUNCH = 65535  # gridDim.y limit
_OWN_ERRORS = {10001: "cuTensorMapEncodeTiled not found in the driver",
               10002: "cuTensorMapEncodeTiled refused the tensor map",
               10003: "unsupported descriptor width"}


class Operands(NamedTuple):
    """A descriptor array as the product kernel reads it."""

    hi: torch.Tensor             # TF32 hi parts (float32), or the bf16 values
    lo: Optional[torch.Tensor]   # TF32 lo parts; None in bf16
    bf16: bool


def _lib():
    lib = cuda_build.load("top2")
    if lib.top2_launch.argtypes is None:
        P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.top2_split_launch.argtypes = [P, LL, P, LL, I, P, P, P, P, P]
        lib.top2_split_launch.restype = ctypes.c_int
        lib.top2_launch.argtypes = [P, P, LL, P, P, LL, P, P, P, I, I, I, I, I, I, P, P, P, P]
        lib.top2_launch.restype = ctypes.c_int
    return lib


def _check(err, what):
    if err != 0:
        raise RuntimeError(f"{what} launch failed: "
                           f"{_OWN_ERRORS.get(err, f'CUDA error {err}')}")


def _check_desc(name, t):
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.shape[-1] not in _DIMS:
        raise ValueError(f"{name}: descriptor width {t.shape[-1]} not in {_DIMS}")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data must be 16-byte aligned")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _alloc(t, bf16):
    if bf16:
        return Operands(torch.empty(t.shape, dtype=torch.bfloat16, device=t.device), None, True)
    return Operands(torch.empty_like(t), torch.empty_like(t), False)


def split(x: torch.Tensor, y: Optional[torch.Tensor] = None, bf16: bool = False):
    """The operands of x (and y) for the product kernel, from one launch of
    the split kernel: TF32 (hi, lo) for float32 (plain version:
    ops/matching.split_tf32), bf16 values for bf16. Returns (ops_x, ops_y),
    ops_y None without y. CUDA tensors only."""
    global split_launches
    for name, t in (("x", x), ("y", y)):
        if t is not None:
            if not t.is_cuda:
                raise ValueError(f"{name}: split runs on CUDA tensors only")
            _check_desc(name, t)
    if y is not None and y.device != x.device:
        raise ValueError("x and y must be on the same device")
    ox = _alloc(x, bf16)
    oy = None if y is None else _alloc(y, bf16)
    with torch.cuda.device(x.device):
        err = _lib().top2_split_launch(
            x.data_ptr(), x.numel(), _ptr(y), 0 if y is None else y.numel(), int(bf16),
            ox.hi.data_ptr(), _ptr(ox.lo), oy and oy.hi.data_ptr(), oy and _ptr(oy.lo),
            torch.cuda.current_stream().cuda_stream)
    _check(err, "top2 split kernel")
    split_launches += 1
    return ox, oy


def _product(qo, ro, q_rows, r_rows, pa, pb, nd, n_refs, n_pairs, nq, d, view_rows,
             idx, d1, d2):
    global launches
    with torch.cuda.device(qo.hi.device):
        err = _lib().top2_launch(
            qo.hi.data_ptr(), _ptr(qo.lo), q_rows, ro.hi.data_ptr(), _ptr(ro.lo), r_rows,
            pa, pb, nd, n_refs, n_pairs, nq, d, view_rows, int(qo.bf16), idx, d1, d2,
            torch.cuda.current_stream().cuda_stream)
    _check(err, "top2 kernel")
    launches += 1


def top2(query: torch.Tensor, refs: torch.Tensor, n_refs: int, bf16: bool):
    """Best reference per query row among the first n_refs rows of refs.

    query (N1, D), refs (N2, D), D in {64, 128}. Returns (idx int32,
    dist1, dist2), each (N1,): dist = 2 - 2*dot, ties to the lowest index.
    float32 is computed as 3xTF32 on the card; bf16 rounds the inputs to
    bf16 and accumulates in float32.
    """
    if query.device != refs.device:
        raise ValueError("query and refs must be on the same device")
    if not query.is_cuda:
        return descriptor_top2(query, refs, n_refs=n_refs, use_bf16=bf16)
    if query.dim() != 2 or refs.dim() != 2 or query.shape[1] != refs.shape[1]:
        raise ValueError(f"shapes {tuple(query.shape)} and {tuple(refs.shape)} do not match")
    qo, ro = split(query, refs, bf16)
    return top2_on(qo, ro, n_refs)


def top2_on(qo: Operands, ro: Operands, n_refs: int):
    """top2 on operands made by split()."""
    n1, d = qo.hi.shape
    n2 = ro.hi.shape[0]
    n_refs = int(n_refs)
    if not 0 <= n_refs <= n2:
        raise ValueError(f"n_refs={n_refs} outside [0, {n2}]")
    if qo.bf16 != ro.bf16 or ro.hi.shape[1] != d:
        raise ValueError("query and reference operands differ in type or width")
    dev = qo.hi.device
    idx = torch.empty(n1, dtype=torch.int32, device=dev)
    d1 = torch.empty(n1, dtype=torch.float32, device=dev)
    d2 = torch.empty(n1, dtype=torch.float32, device=dev)
    _product(qo, ro, n1, n2, None, None, None, n_refs, 1, n1, d, 0,
             idx.data_ptr(), d1.data_ptr(), d2.data_ptr())
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
    if desc.dim() != 3:
        raise ValueError(f"desc must be (V, N, D), got {tuple(desc.shape)}")
    ops, _ = split(desc, None, bf16)
    return top2_pairs_on(ops, n_desc, pair_a, pair_b)


def top2_pairs_on(ops: Operands, n_desc: torch.Tensor, pair_a: torch.Tensor,
                  pair_b: torch.Tensor):
    """top2_pairs on the operands of a (V, N, D) stack made by split()."""
    V, N, D = ops.hi.shape
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
    dev = ops.hi.device
    idx = torch.empty((P, N), dtype=torch.int32, device=dev)
    d1 = torch.empty((P, N), dtype=torch.float32, device=dev)
    d2 = torch.empty((P, N), dtype=torch.float32, device=dev)
    for c0 in range(0, P, _MAX_PAIRS_PER_LAUNCH):
        n = min(_MAX_PAIRS_PER_LAUNCH, P - c0)
        out = c0 * N
        _product(ops, ops, V * N, V * N, pair_a[c0:].data_ptr(), pair_b[c0:].data_ptr(),
                 n_desc.data_ptr(), 0, n, N, D, N, idx.data_ptr() + 4 * out,
                 d1.data_ptr() + 4 * out, d2.data_ptr() + 4 * out)
    return idx, d1, d2
