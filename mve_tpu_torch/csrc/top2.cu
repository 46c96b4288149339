// Fused descriptor top-2 nearest-neighbour search for Hopper (sm_90a).
//
// Replaces mve_tpu/ops/pallas_matching.py:_top2_kernel (the Pallas TPU
// kernel behind descriptor_top2_pallas). For every query row it returns
// the index of the best reference by inner product, and the squared L2
// distances 2 - 2*best and 2 - 2*second (unit descriptors), without ever
// storing the N1 x N2 score matrix in device memory.
//
// What bounds it: 2*N1*N2*D operations on about (N1 + N2)*D*4 bytes read,
// i.e. ~N/4 operations per byte (hundreds at matching sizes), so it is
// compute-bound on the card at any size the pipeline uses. This first
// version runs on the CUDA cores in float32 FMA (the float32 path must
// match the plain float32 version, and TF32 tensor cores would not):
//   * one block per (pair, 64-query tile), 256 threads;
//   * the block streams 64-reference tiles; query and reference slices of
//     32 dimensions are staged in shared memory (k-major), and each thread
//     keeps a 4x4 register tile of scores;
//   * after each reference tile every thread folds its 4x4 scores into
//     running (best, second, argbest) for its 4 queries, visiting its
//     columns in increasing order, so a strict '>' keeps the lowest index;
//   * at the end the 16 threads that share a query merge their triples
//     with warp shuffles: ties go to the lower index, and equal bests give
//     second == best, the semantics of argmax + masked max.
// Each score is summed over k = 0..D-1 in order, so dot(a, b) is the same
// bits whichever of the two is the query: both matching directions see
// the same scores, as the single score matrix of the plain version does.
// bf16 mode rounds the inputs to bf16 on load and accumulates in float32.
// Making it fast (tensor cores with 3xTF32 / bf16x3 splitting for the
// float32 path, wgmma + TMA) is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <climits>

namespace {

constexpr int BQ = 64;       // queries per block
constexpr int BR = 64;       // references per tile
constexpr int KC = 32;       // dimensions per shared-memory slice
constexpr int THREADS = 256; // 16 x 16 threads, 4 x 4 scores each

template <bool BF16>
__device__ __forceinline__ float in_type(float v) {
    if (BF16) return __bfloat162float(__float2bfloat16_rn(v));
    return v;
}

// Merge (b2, s2, i2) into (b1, s1, i1): best by value, ties to the lower
// index; the loser's best competes for second place.
__device__ __forceinline__ void merge(float& b1, float& s1, int& i1,
                                      float b2, float s2, int i2) {
    if (b2 > b1 || (b2 == b1 && i2 < i1)) {
        s1 = fmaxf(b1, s2);
        b1 = b2;
        i1 = i2;
    } else {
        s1 = fmaxf(s1, b2);
    }
}

template <bool BF16>
__global__ void __launch_bounds__(THREADS) top2_kernel(
        const float* __restrict__ q, const float* __restrict__ r,
        const int* __restrict__ pair_a, const int* __restrict__ pair_b,
        const int* __restrict__ n_desc, int n_refs_fixed, int nq, int d,
        long long q_view_stride, long long r_view_stride,
        int* __restrict__ out_idx, float* __restrict__ out_d1,
        float* __restrict__ out_d2) {
    __shared__ __align__(16) float qs[KC][BQ];
    __shared__ __align__(16) float rs[KC][BR];

    const int p = blockIdx.y;
    const int q0 = blockIdx.x * BQ;
    int a = 0, b = 0, n_refs = n_refs_fixed;
    if (pair_a != nullptr) {
        a = pair_a[p];
        b = pair_b[p];
        n_refs = n_desc[b];
    }
    const float* qv = q + a * q_view_stride;
    const float* rv = r + b * r_view_stride;
    const int tid = threadIdx.x;
    const int tx = tid & 15;   // reference columns tx*4 .. tx*4+3 of a tile
    const int ty = tid >> 4;   // query rows ty*4 .. ty*4+3 of the block

    float best[4], second[4];
    int arg[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        best[i] = -CUDART_INF_F;
        second[i] = -CUDART_INF_F;
        arg[i] = INT_MAX;
    }

    for (int r0 = 0; r0 < n_refs; r0 += BR) {
        float acc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

        for (int k0 = 0; k0 < d; k0 += KC) {
            // 64 rows x 32 dims = 512 float4 per operand: 2 per thread.
#pragma unroll
            for (int it = 0; it < 2; ++it) {
                const int e = tid + it * THREADS;
                const int row = e >> 3;
                const int c = (e & 7) * 4;
                float4 vq = make_float4(0.f, 0.f, 0.f, 0.f);
                float4 vr = make_float4(0.f, 0.f, 0.f, 0.f);
                if (q0 + row < nq)
                    vq = *reinterpret_cast<const float4*>(
                        qv + (long long)(q0 + row) * d + k0 + c);
                if (r0 + row < n_refs)
                    vr = *reinterpret_cast<const float4*>(
                        rv + (long long)(r0 + row) * d + k0 + c);
                qs[c + 0][row] = in_type<BF16>(vq.x);
                qs[c + 1][row] = in_type<BF16>(vq.y);
                qs[c + 2][row] = in_type<BF16>(vq.z);
                qs[c + 3][row] = in_type<BF16>(vq.w);
                rs[c + 0][row] = in_type<BF16>(vr.x);
                rs[c + 1][row] = in_type<BF16>(vr.y);
                rs[c + 2][row] = in_type<BF16>(vr.z);
                rs[c + 3][row] = in_type<BF16>(vr.w);
            }
            __syncthreads();
#pragma unroll
            for (int k = 0; k < KC; ++k) {
                const float4 qa = *reinterpret_cast<const float4*>(&qs[k][ty * 4]);
                const float4 rb = *reinterpret_cast<const float4*>(&rs[k][tx * 4]);
                const float qk[4] = {qa.x, qa.y, qa.z, qa.w};
                const float rk[4] = {rb.x, rb.y, rb.z, rb.w};
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < 4; ++j)
                        acc[i][j] = fmaf(qk[i], rk[j], acc[i][j]);
            }
            __syncthreads();
        }

#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int col = r0 + tx * 4 + j;
            if (col < n_refs) {
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const float s = acc[i][j];
                    if (s > best[i]) {
                        second[i] = best[i];
                        best[i] = s;
                        arg[i] = col;
                    } else if (s > second[i]) {
                        second[i] = s;
                    }
                }
            }
        }
    }

    // The 16 threads of one query row group are 16 adjacent lanes.
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const float b2 = __shfl_xor_sync(0xffffffffu, best[i], off);
            const float s2 = __shfl_xor_sync(0xffffffffu, second[i], off);
            const int i2 = __shfl_xor_sync(0xffffffffu, arg[i], off);
            merge(best[i], second[i], arg[i], b2, s2, i2);
        }
    }
    if (tx == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int row = q0 + ty * 4 + i;
            if (row < nq) {
                const long long o = (long long)p * nq + row;
                out_idx[o] = arg[i] == INT_MAX ? 0 : arg[i];
                out_d1[o] = 2.f - 2.f * best[i];
                out_d2[o] = 2.f - 2.f * second[i];
            }
        }
    }
}

}  // namespace

// Plain C entry point, loaded with ctypes (mve_tpu_torch/ops/top2.py).
// pair_a == nullptr: one query set against one reference set whose first
// n_refs rows are real. Otherwise num_pairs pairs of views: queries from
// view pair_a[p], references from view pair_b[p] with n_desc[pair_b[p]]
// real rows. Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() as an int (0 on success).
extern "C" int top2_launch(const float* q, const float* r, const int* pair_a,
                           const int* pair_b, const int* n_desc, int n_refs,
                           int num_pairs, int nq, int d,
                           long long q_view_stride, long long r_view_stride,
                           int bf16, int* out_idx, float* out_d1,
                           float* out_d2, void* stream) {
    if (num_pairs <= 0 || nq <= 0) return 0;
    const dim3 grid((nq + BQ - 1) / BQ, num_pairs);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (bf16)
        top2_kernel<true><<<grid, THREADS, 0, s>>>(
            q, r, pair_a, pair_b, n_desc, n_refs, nq, d, q_view_stride,
            r_view_stride, out_idx, out_d1, out_d2);
    else
        top2_kernel<false><<<grid, THREADS, 0, s>>>(
            q, r, pair_a, pair_b, n_desc, n_refs, nq, d, q_view_stride,
            r_view_stride, out_idx, out_d1, out_d2);
    return static_cast<int>(cudaGetLastError());
}
