"""The work sfmrecon's top-2 passes need, counted from their inputs,
whatever implements them (kernel B1, mve_tpu_torch/csrc/top2.cu, today).

A pass matches each pair (a, b) both ways: for every descriptor of a its
two nearest descriptors of b by squared distance, then the same from b
to a. Each direction is one product of the two descriptor blocks,
2 n_a n_b D operations (a multiply-add counts two), counted with the
views' real descriptor counts, not the padded row count the program
launches with. Bytes: each direction reads both blocks once (float32)
and writes, for each row of its first block, the index and the two
distances (three 4-byte outputs).

The product must be accurate to float32; three TF32 products on the
tensor cores are the H100's fastest route to that, so the operations
run at best at a third of the TF32 tensor rate.
"""

from __future__ import annotations

from mvebench.harness import peaks

#: Dense TF32 on the tensor cores of one H100 SXM (NVIDIA's data sheet, without
#: sparsity, at 700 W).
TF32_TENSOR_FLOPS = 494.7e12
#: The float32-accurate product: three TF32 products.
F32_VIA_TF32_FLOPS = TF32_TENSOR_FLOPS / 3
OUTPUT_BYTES = 3 * 4


def pass_work(counts, pair_a, pair_b, dim: int):
    """(operations, bytes) of one pass over the pairs (pair_a[k],
    pair_b[k]) of views with counts[v] descriptors of width dim, both
    directions."""
    ops = nbytes = 0
    for a, b in zip(pair_a, pair_b):
        na, nb = int(counts[a]), int(counts[b])
        ops += 2 * (2 * na * nb * dim)
        nbytes += 2 * (na + nb) * dim * 4 + (na + nb) * OUTPUT_BYTES
    return ops, nbytes


def least_seconds(ops: int, nbytes: int, flops: float = F32_VIA_TF32_FLOPS,
                  bytes_per_s: float = peaks.HBM_BYTES):
    """(seconds, which bound) the device needs at best for this work."""
    t_ops, t_mem = ops / flops, nbytes / bytes_per_s
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")
