// Fused descriptor top-2 nearest-neighbour search for Hopper (sm_90a),
// on the tensor cores.
//
// Replaces mve_tpu/ops/pallas_matching.py:_top2_kernel (the Pallas TPU
// kernel behind descriptor_top2_pallas). For every query row it returns
// the index of the best reference by inner product, and the squared L2
// distances 2 - 2*best and 2 - 2*second (unit descriptors), without ever
// storing the N1 x N2 score matrix in device memory.
//
// What bounds it: 2*N1*N2*D operations on about (N1 + N2)*D*4 bytes, i.e.
// ~N/4 operations per byte (hundreds at matching sizes): it is bound by
// the tensor cores' rate at every size the pipeline uses. Two kernels:
//
//  * split_kernel, an elementwise pre-pass over the descriptor stack that
//    puts the operands in the type the tensor cores read. float32 path:
//    x -> (hi, lo), hi = x rounded to TF32 (to nearest, ties away from
//    zero, as cvt.rna.tf32.f32), lo = x - hi rounded the same way (the
//    3xTF32 scheme). bf16 path: x -> bf16 (to nearest even). Its plain
//    version is ops/matching.split_tf32 / Tensor.to(torch.bfloat16).
//  * top2_tc_kernel, the products on the tensor cores with wgmma, fed by
//    TMA, and the top-2 fold in the accumulators' own layout:
//      - float32 path: hi.hi + (hi.lo + lo.hi), three TF32 products with
//        float32 accumulation (lo.lo, below 2^-22 relative, is dropped).
//        Each product has its own accumulator and the two cross terms are
//        added first, so dot(a, b) has the same bits whichever of a and b
//        is the query: hi.lo of one direction is lo.hi of the other,
//        summed over the same k order, and a + b == b + a. Both matching
//        directions see the same scores, as the plain version's single
//        score matrix does. Float32 parity needs all three products: one
//        TF32 product keeps about three decimal digits. lo.hi takes its A
//        operand (the query's lo parts) from registers, loaded once a
//        block, so the query tile in shared memory is hi only.
//      - bf16 path: one bf16 product, float32 accumulation.
//      - one block per (query tile, pair), the query tile fastest in
//        blockIdx, so the query tiles of one pair run together and the
//        pair's references stay in the 50 MB L2;
//      - one producer warp issues TMA loads (2-D tensor maps over the
//        (V*N, D) stack, 128-byte swizzle, boxes of 128 bytes x rows) of
//        the query tile once and of reference tiles into a ring of
//        shared-memory stages, with full/empty mbarriers;
//      - one or two consumer warpgroups, each owning 64 query rows, run
//        m64nBR wgmma (both operands K-major, as TF32 wgmma requires:
//        descriptors are (N, D) row-major) and fold the scores into
//        running (best, second, arg). With two warpgroups one folds while
//        the other's wgmma runs (in bf16 the fold's compares are about a
//        quarter of the tensor-core time); a launch too small to give
//        every SM a block of two takes one (top2_launch);
//      - a thread of an m64nN accumulator holds 2 rows, its columns in
//        increasing order, so a strict '>' keeps the lowest index among
//        equals; the four lanes of a quad then merge with ties to the
//        lower index, the loser's best competing for second place (argmax
//        + masked max: an all-equal row gives idx 0 and second == best;
//        no real reference gives idx 0 and distance inf);
//      - rows of the next view that a box reads past n_desc[b] are masked
//        by column index in the fold; rows past the end of the stack are
//        zero-filled by TMA and masked the same way. Nothing is padded.
//
// Where trouble lies, and what the design does:
//  1. Shared memory for 3xTF32 at D=128: hi and lo are 8 bytes an element,
//     1 KB a descriptor. With the query's lo parts in registers the query
//     tile is hi only: 64 KB for two warpgroups' 128 rows, and 48-row
//     reference stages of 48 KB leave room for three (208 KB of the 227
//     KB). D=64 float32 and bf16 hold four stages (Traits below). Boxes
//     are 32 floats or 64 bf16 wide (128 bytes) to match the 128-byte
//     swizzle that the wgmma descriptors name. Shared-memory reads then
//     bound the float32 path: an m64n64k8 reads 4 KB of operands in the
//     32 cycles the tensor cores take for it, the 128 bytes a cycle that
//     shared memory gives, while TMA writes the next stage; lo.hi's A from
//     registers and two warpgroups sharing each reference stage (half the
//     stage bytes per product of one warpgroup) keep under that.
//  2. cuTensorMapEncodeTiled is a driver API function: it is reached
//     through cudaGetDriverEntryPoint[ByVersion], so the library links
//     against the runtime only (no -lcuda).
//  3. Direction symmetry: see the float32 path above; chip_smoke.py
//     checks it bit for bit on the card.
//  4. Registers: a block of two consumer warpgroups and the producer warp
//     gets 168 registers a thread. float32 needs three accumulators and
//     the lo A fragments (64 registers at D=128, 32 at D=64): three
//     m64n64 accumulators (96) fit at D=64, but at D=128 ptxas spilled and
//     serialised the wgmma, so two warpgroups there use m64n48 (72). One
//     warpgroup (255 registers) keeps m64n64. One m64n128 bf16 accumulator
//     is 64. ptxas must report 0 spill bytes (chip_smoke.py phase 2 fails
//     otherwise).
//  5. Ragged sizes: query rows past nq are computed and not written;
//     reference columns past n_refs never enter the fold.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <climits>
#include <cstdint>

namespace {

// ---------------------------------------------------------------- split

__device__ __forceinline__ float rna_tf32(float v) {
    // Round to the 10 explicit mantissa bits of TF32, to nearest with ties
    // away from zero (sign-magnitude: adding half an ulp to the bits rounds
    // the magnitude), the low 13 bits left zero.
    return __uint_as_float((__float_as_uint(v) + 0x1000u) & 0xFFFFE000u);
}

struct Seg {
    const float4* x;
    long long n4;  // float4 units
    void* hi;
    void* lo;
};

template <bool BF16>
__global__ void split_kernel(Seg s0, Seg s1) {
    const Seg s = blockIdx.y ? s1 : s0;
    for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < s.n4;
         i += (long long)gridDim.x * blockDim.x) {
        const float4 v = s.x[i];
        if (BF16) {
            __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(s.hi);
            o[2 * i] = __floats2bfloat162_rn(v.x, v.y);
            o[2 * i + 1] = __floats2bfloat162_rn(v.z, v.w);
        } else {
            float4 h, l;
            h.x = rna_tf32(v.x); l.x = rna_tf32(v.x - h.x);
            h.y = rna_tf32(v.y); l.y = rna_tf32(v.y - h.y);
            h.z = rna_tf32(v.z); l.z = rna_tf32(v.z - h.z);
            h.w = rna_tf32(v.w); l.w = rna_tf32(v.w - h.w);
            reinterpret_cast<float4*>(s.hi)[i] = h;
            reinterpret_cast<float4*>(s.lo)[i] = l;
        }
    }
}

// ------------------------------------------------------- configuration

// NWG consumer warpgroups of 64 query rows each (2, or 1 where a launch
// has too few query tiles to fill the card); BR reference rows per stage,
// the wgmma N (float32: 3 accumulators of BR/2 registers, and at D=128 with
// two warpgroups only 48 columns fit beside the A fragments in 168
// registers); as many stages in the ring as shared memory holds, at most 4.
template <bool F32, int D, int NWG_> struct Traits {
    static constexpr int NWG = NWG_;
    static constexpr int BR = !F32 ? 128 : (D == 128 && NWG == 2) ? 48 : 64;
    static constexpr int BQ = 64 * NWG;
    static constexpr int ESIZE = F32 ? 4 : 2;
    static constexpr int PARTS = F32 ? 2 : 1;       // hi, lo of a reference stage
    static constexpr int NACC = F32 ? 3 : 1;        // hi.hi, hi.lo, lo.hi
    static constexpr int CW = 128 / ESIZE;          // elements in a 128-byte chunk
    static constexpr int NC = D / CW;               // chunks in a row
    static constexpr int KSTEPS = 4;                // 32-byte wgmma k-steps a chunk
    static constexpr int KS = D / 8 * ESIZE / 4;    // wgmma k-steps a row
    static constexpr int Q_BYTES = BQ * D * ESIZE;  // query tile: hi (or bf16) only
    static constexpr int R_PART = BR * D * ESIZE;
    static constexpr int STAGE_BYTES = PARTS * R_PART;
    static constexpr int STAGES_FIT = (232448 - 1024 - 8 * (1 + 2 * 4) - Q_BYTES) / STAGE_BYTES;
    static constexpr int STAGES = STAGES_FIT < 4 ? STAGES_FIT : 4;
    static_assert(STAGES >= 2, "at least two reference stages");
    static constexpr int BAR_OFFSET = Q_BYTES + STAGES * STAGE_BYTES;
    static constexpr int SMEM = 1024 + BAR_OFFSET + 8 * (1 + 2 * STAGES);
    static constexpr int THREADS = NWG * 128 + 32;  // consumer warpgroups, producer warp
    static_assert(SMEM <= 232448, "shared memory");
};

// ----------------------------------------------------- PTX helpers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Wait until the phase of the given parity has completed. No wait in this
// kernel legitimately lasts more than microseconds: a lost phase traps (a
// launch error) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    uint32_t done;
    uint32_t tries = 0;
    do {
        if (++tries == (1u << 22)) __trap();
        asm volatile(
            "{\n .reg .pred p;\n"
            " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            " selp.u32 %0, 1, 0, p;\n}"
            : "=r"(done)
            : "r"(bar), "r"(parity)
            : "memory");
    } while (!done);
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            uint32_t bar) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%2, %3}], [%4];" ::"r"(dst),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
        : "memory");
}

// wgmma shared-memory descriptor: K-major, 128-byte swizzle, 8-row groups
// 1024 bytes apart. The tile base is 1024-byte aligned; a k-step inside a
// 128-byte chunk advances the start address by 32 bytes.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
    return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
           ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void fence_acc(float& r) { asm volatile("" : "+f"(r)::"memory"); }

#define F8(d, i)                                                                           \
    "+f"(d[(i) + 0]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3]), "+f"(d[(i) + 4]), \
        "+f"(d[(i) + 5]), "+f"(d[(i) + 6]), "+f"(d[(i) + 7])

template <bool F32, int N> struct Mma;

// m64n64k8, TF32 x TF32 -> float32.
template <> struct Mma<true, 64> {
    static __device__ __forceinline__ void run(float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
        asm volatile(
            "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
            " wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
            "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
            "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
            "%32, %33, p, 1, 1;\n}"
            : F8(d, 0), F8(d, 8), F8(d, 16), F8(d, 24)
            : "l"(a), "l"(b), "r"(scale_d));
    }
};

// m64n48k8, TF32 x TF32 -> float32.
template <> struct Mma<true, 48> {
    static __device__ __forceinline__ void run(float (&d)[24], uint64_t a, uint64_t b, int scale_d) {
        asm volatile(
            "{\n .reg .pred p;\n setp.ne.b32 p, %26, 0;\n"
            " wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 "
            "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, "
            "%24, %25, p, 1, 1;\n}"
            : F8(d, 0), F8(d, 8), F8(d, 16)
            : "l"(a), "l"(b), "r"(scale_d));
    }
};

// m64n128k16, bf16 x bf16 -> float32, both operands K-major.
template <> struct Mma<false, 128> {
    static __device__ __forceinline__ void run(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
        asm volatile(
            "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
            " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
            "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
            "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
            "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
            "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
            "%64, %65, p, 1, 1, 0, 0;\n}"
            : F8(d, 0), F8(d, 8), F8(d, 16), F8(d, 24), F8(d, 32), F8(d, 40), F8(d, 48), F8(d, 56)
            : "l"(a), "l"(b), "r"(scale_d));
    }
};

// m64nNk8, TF32 x TF32 -> float32, A from registers: a[0..3] hold
// (row, k) = (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4) of the warp's
// 16 rows, g = lane / 4, t = lane % 4.
template <int N> struct MmaRS;

template <> struct MmaRS<48> {
    static __device__ __forceinline__ void run(float (&d)[24], const uint32_t (&a)[4], uint64_t b,
                                               int scale_d) {
        asm volatile(
            "{\n .reg .pred p;\n setp.ne.b32 p, %29, 0;\n"
            " wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 "
            "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, "
            "{%24, %25, %26, %27}, %28, p, 1, 1;\n}"
            : F8(d, 0), F8(d, 8), F8(d, 16)
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
    }
};

template <> struct MmaRS<64> {
    static __device__ __forceinline__ void run(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                               int scale_d) {
        asm volatile(
            "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
            " wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
            "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
            "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
            "{%32, %33, %34, %35}, %36, p, 1, 1;\n}"
            : F8(d, 0), F8(d, 8), F8(d, 16), F8(d, 24)
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
    }
};

#undef F8

// Merge (b2, s2, i2) into (b1, s1, i1): best by value, ties to the lower
// index; the loser's best competes for second place.
__device__ __forceinline__ void merge(float& b1, float& s1, int& i1, float b2, float s2, int i2) {
    if (b2 > b1 || (b2 == b1 && i2 < i1)) {
        s1 = fmaxf(b1, s2);
        b1 = b2;
        i1 = i2;
    } else {
        s1 = fmaxf(s1, b2);
    }
}

// ----------------------------------------------------------- product

// Maps: query hi and reference hi / lo (lo unused in bf16); the query lo
// parts (q_lo, q_rows rows) are read into registers, the A operand of the
// lo.hi product. Pair p takes query rows from view pair_a[p] and reference
// rows from view pair_b[p] (n_desc[pair_b[p]] of them real), each
// view_rows rows into the stack; pair_a == nullptr: one query set against
// n_refs_fixed references.
template <bool F32, int D, int NWG>
__global__ void __launch_bounds__(Traits<F32, D, NWG>::THREADS, 1) top2_tc_kernel(
        __grid_constant__ const CUtensorMap mq_hi, __grid_constant__ const CUtensorMap mr_hi,
        __grid_constant__ const CUtensorMap mr_lo, const float* __restrict__ q_lo, int q_rows,
        const int* __restrict__ pair_a, const int* __restrict__ pair_b,
        const int* __restrict__ n_desc, int n_refs_fixed, int nq, int view_rows,
        int* __restrict__ out_idx, float* __restrict__ out_d1, float* __restrict__ out_d2) {
    using T = Traits<F32, D, NWG>;
    constexpr int BR = T::BR, STAGES = T::STAGES, NACC = T::NACC;

    extern __shared__ uint8_t smem_raw[];
    const uint32_t raw = smem_u32(smem_raw);
    const uint32_t pad = (1024u - (raw & 1023u)) & 1023u;
    const uint32_t sq = raw + pad;             // query tile: chunk, row
    const uint32_t sr = sq + T::Q_BYTES;       // stages: stage, part, chunk, row
    const uint32_t bar_q = sq + T::BAR_OFFSET;
    auto bar_full = [&](int s) { return bar_q + 8u * (1 + s); };
    auto bar_empty = [&](int s) { return bar_q + 8u * (1 + STAGES + s); };

    const int p = blockIdx.y;
    const int q0 = blockIdx.x * T::BQ;
    int a = 0, b = 0, n_refs = n_refs_fixed;
    if (pair_a != nullptr) {
        a = pair_a[p];
        b = pair_b[p];
        n_refs = n_desc[b];
    }
    const int n_tiles = (n_refs + BR - 1) / BR;

    if (threadIdx.x == 0) {
        mbar_init(bar_q, 1);
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(bar_full(s), 1);
            mbar_init(bar_empty(s), T::NWG * 128);
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();

    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;

    if (warp == T::NWG * 4) {
        // Producer warp: one lane issues every TMA load.
        if (lane == 0) {
            const int qrow = a * view_rows + q0;
            const int rrow = b * view_rows;
            mbar_expect_tx(bar_q, T::Q_BYTES);
#pragma unroll
            for (int c = 0; c < T::NC; ++c)
                tma_load_2d(sq + c * T::BQ * 128, &mq_hi, c * T::CW, qrow, bar_q);
            for (int t = 0; t < n_tiles; ++t) {
                const int s = t % STAGES;
                if (t >= STAGES) mbar_wait(bar_empty(s), ((t / STAGES) - 1) & 1);
                mbar_expect_tx(bar_full(s), T::STAGE_BYTES);
                const uint32_t st = sr + s * T::STAGE_BYTES;
#pragma unroll
                for (int part = 0; part < T::PARTS; ++part)
#pragma unroll
                    for (int c = 0; c < T::NC; ++c)
                        tma_load_2d(st + part * T::R_PART + c * BR * 128, part ? &mr_lo : &mr_hi,
                                    c * T::CW, rrow + t * BR, bar_full(s));
            }
        }
    } else {
        // Consumers: warpgroup wg owns query rows wg*64 .. wg*64+63 of the tile.
        const int wg = warp >> 2;
        const int w = warp & 3;
        const int quad = lane & 3;
        float best[2] = {-CUDART_INF_F, -CUDART_INF_F};
        float second[2] = {-CUDART_INF_F, -CUDART_INF_F};
        int arg[2] = {INT_MAX, INT_MAX};
        float acc[NACC][BR / 2] = {};

        // The lo parts of this thread's A fragments (float32 path), from device
        // memory, once: rows g and g + 8 of the warp's 16, k = t and t + 4 of
        // every 8-wide k-step. Rows past the stack read as zero.
        uint32_t alo[F32 ? T::KS : 1][4];
        if constexpr (F32) {
            const int row = a * view_rows + q0 + wg * 64 + w * 16 + (lane >> 2);
            const float* r0 = q_lo + (long long)row * D + quad;
            const float* r8 = r0 + 8 * D;
            const bool ok0 = row < q_rows, ok8 = row + 8 < q_rows;
#pragma unroll
            for (int ks = 0; ks < T::KS; ++ks) {
                alo[ks][0] = ok0 ? __float_as_uint(r0[8 * ks]) : 0u;
                alo[ks][1] = ok8 ? __float_as_uint(r8[8 * ks]) : 0u;
                alo[ks][2] = ok0 ? __float_as_uint(r0[8 * ks + 4]) : 0u;
                alo[ks][3] = ok8 ? __float_as_uint(r8[8 * ks + 4]) : 0u;
            }
        }

        mbar_wait(bar_q, 0);
        const uint32_t qa = sq + wg * 64 * 128;
        for (int t = 0; t < n_tiles; ++t) {
            const int s = t % STAGES;
            mbar_wait(bar_full(s), (t / STAGES) & 1);
            const uint32_t st = sr + s * T::STAGE_BYTES;
#pragma unroll
            for (int m = 0; m < NACC; ++m)
#pragma unroll
                for (int i = 0; i < BR / 2; ++i) fence_acc(acc[m][i]);
            asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
            for (int c = 0; c < T::NC; ++c) {
#pragma unroll
                for (int k = 0; k < T::KSTEPS; ++k) {
                    const int scale = (c | k) != 0;
                    const uint64_t dq = smem_desc(qa + c * T::BQ * 128) + 2 * k;
                    const uint64_t dr = smem_desc(st + c * BR * 128) + 2 * k;
                    Mma<F32, BR>::run(acc[0], dq, dr, scale);
                    if constexpr (F32) {
                        const uint64_t dr_lo = smem_desc(st + T::R_PART + c * BR * 128) + 2 * k;
                        Mma<F32, BR>::run(acc[1], dq, dr_lo, scale);
                        MmaRS<BR>::run(acc[2], alo[c * T::KSTEPS + k], dr, scale);
                    }
                }
            }
            asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
            asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
#pragma unroll
            for (int m = 0; m < NACC; ++m)
#pragma unroll
                for (int i = 0; i < BR / 2; ++i) fence_acc(acc[m][i]);
            mbar_arrive(bar_empty(s));

            // Fold. Accumulator i of this thread: row (i/2)%2 of its pair of
            // rows, column (i/4)*8 + quad*2 + i%2: increasing within a row.
            const int lim = n_refs - t * BR;
#pragma unroll
            for (int i = 0; i < BR / 2; ++i) {
                const int h = (i >> 1) & 1;
                const int col = (i >> 2) * 8 + quad * 2 + (i & 1);
                float sc;
                if constexpr (F32)
                    sc = acc[0][i] + (acc[1][i] + acc[2][i]);
                else
                    sc = acc[0][i];
                if (col < lim && sc > second[h]) {
                    if (sc > best[h]) {
                        second[h] = best[h];
                        best[h] = sc;
                        arg[h] = t * BR + col;
                    } else {
                        second[h] = sc;
                    }
                }
            }
        }

        // The four lanes of a quad share the two rows.
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
            for (int off = 1; off <= 2; off <<= 1) {
                const float b2 = __shfl_xor_sync(0xffffffffu, best[h], off);
                const float s2 = __shfl_xor_sync(0xffffffffu, second[h], off);
                const int i2 = __shfl_xor_sync(0xffffffffu, arg[h], off);
                merge(best[h], second[h], arg[h], b2, s2, i2);
            }
            const int row = q0 + wg * 64 + w * 16 + (lane >> 2) + 8 * h;
            if (quad == 0 && row < nq) {
                const long long o = (long long)p * nq + row;
                out_idx[o] = arg[h] == INT_MAX ? 0 : arg[h];
                out_d1[o] = 2.f - 2.f * best[h];
                out_d2[o] = 2.f - 2.f * second[h];
            }
        }
    }
}

// ------------------------------------------------------------- host

// Error codes beyond the CUDA runtime's.
constexpr int ERR_NO_ENCODER = 10001;    // cuTensorMapEncodeTiled not found
constexpr int ERR_ENCODE = 10002;        // cuTensorMapEncodeTiled refused the map
constexpr int ERR_ARGS = 10003;          // unsupported width

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
    static EncodeTiled fn = nullptr;
    if (fn == nullptr) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
        cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                         cudaEnableDefault, &q);
#else
        cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
        if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
    }
    return fn;
}

// A 2-D map over a row-major (rows, d) array; boxes of 128 bytes x box_rows.
int encode(CUtensorMap* m, const void* ptr, long long rows, int d, bool f32, int box_rows) {
    EncodeTiled fn = encoder();
    if (fn == nullptr) return ERR_NO_ENCODER;
    const int esize = f32 ? 4 : 2;
    const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)rows};
    const cuuint64_t strides[1] = {(cuuint64_t)d * esize};
    const cuuint32_t box[2] = {(cuuint32_t)(128 / esize), (cuuint32_t)box_rows};
    const cuuint32_t estr[2] = {1, 1};
    CUresult r = fn(m, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                    const_cast<void*>(ptr), dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                    CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                    CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : ERR_ENCODE;
}

template <bool F32, int D, int NWG>
int launch_tc(const void* q_hi, const void* q_lo, long long q_rows, const void* r_hi,
              const void* r_lo, long long r_rows, const int* pair_a, const int* pair_b,
              const int* n_desc, int n_refs, int num_pairs, int nq, int view_rows, int* out_idx,
              float* out_d1, float* out_d2, cudaStream_t stream) {
    using T = Traits<F32, D, NWG>;
    if (r_rows == 0) {  // no reference is read; any valid map will do
        r_hi = q_hi;
        r_lo = q_lo;
        r_rows = q_rows;
    }
    CUtensorMap mq_hi, mr_hi, mr_lo;
    int e;
    if ((e = encode(&mq_hi, q_hi, q_rows, D, F32, T::BQ))) return e;
    if ((e = encode(&mr_hi, r_hi, r_rows, D, F32, T::BR))) return e;
    mr_lo = mr_hi;
    if (F32 && (e = encode(&mr_lo, r_lo, r_rows, D, F32, T::BR))) return e;
    static bool attr = false;
    if (!attr) {
        cudaError_t ce = cudaFuncSetAttribute(top2_tc_kernel<F32, D, NWG>,
                                              cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
        if (ce != cudaSuccess) return static_cast<int>(ce);
        attr = true;
    }
    const dim3 grid((nq + T::BQ - 1) / T::BQ, num_pairs);
    top2_tc_kernel<F32, D, NWG><<<grid, T::THREADS, T::SMEM, stream>>>(
        mq_hi, mr_hi, mr_lo, static_cast<const float*>(q_lo), (int)q_rows, pair_a, pair_b, n_desc,
        n_refs, nq, view_rows, out_idx, out_d1, out_d2);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, loaded with ctypes (mve_tpu_torch/ops/top2.py).
// Both launch on `stream`, do not synchronise, and return
// cudaGetLastError() as an int (0 on success; 10001-10003 are the tensor
// map's and the arguments' own errors).

// The pre-pass over one or two float32 arrays of n0 and n1 elements
// (multiples of 4; x1 may be null): float32 path x -> TF32 (hi, lo),
// bf16 path x -> bf16 in hi (lo unused).
extern "C" int top2_split_launch(const float* x0, long long n0, const float* x1, long long n1,
                                 int bf16, void* hi0, void* lo0, void* hi1, void* lo1,
                                 void* stream) {
    const Seg s0{reinterpret_cast<const float4*>(x0), n0 / 4, hi0, lo0};
    const Seg s1{reinterpret_cast<const float4*>(x1), x1 ? n1 / 4 : 0, hi1, lo1};
    const long long n4 = s0.n4 > s1.n4 ? s0.n4 : s1.n4;
    if (n4 <= 0) return 0;
    long long blocks = (n4 + 255) / 256;
    if (blocks > 132 * 16) blocks = 132 * 16;
    const dim3 grid((unsigned)blocks, x1 ? 2 : 1);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (bf16)
        split_kernel<true><<<grid, 256, 0, s>>>(s0, s1);
    else
        split_kernel<false><<<grid, 256, 0, s>>>(s0, s1);
    return static_cast<int>(cudaGetLastError());
}

// The product and top-2 on split operands. pair_a == nullptr: one query
// set (q_rows rows, nq of them computed) against one reference set whose
// first n_refs rows are real. Otherwise num_pairs pairs of views of
// view_rows rows each: queries from view pair_a[p], references from view
// pair_b[p] with n_desc[pair_b[p]] real rows. Outputs are (num_pairs, nq).
extern "C" int top2_launch(const void* q_hi, const void* q_lo, long long q_rows,
                           const void* r_hi, const void* r_lo, long long r_rows,
                           const int* pair_a, const int* pair_b, const int* n_desc, int n_refs,
                           int num_pairs, int nq, int d, int view_rows, int bf16, int* out_idx,
                           float* out_d1, float* out_d2, void* stream) {
    if (num_pairs <= 0 || nq <= 0) return 0;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    // Two consumer warpgroups (128 query rows a block) where that still
    // gives every SM a block, else one (64 rows), so that small launches,
    // a single query set of a few thousand rows, keep the card full. Each
    // count wins where it is picked (PERF.md, the warpgroup A/B on one
    // H100): two take the main path's six calls in 48 ms against 73 ms for
    // one; one takes 8192 x 8192 x 128 float32 in 0.24 ms against 0.31 ms
    // for two, and the per-pair matcher's sizes 8-10% faster.
    static int sms = 0;
    if (sms == 0) {
        int dev = 0;
        cudaGetDevice(&dev);
        if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
            return static_cast<int>(cudaGetLastError());
    }
    const bool two = (long long)((nq + 127) / 128) * num_pairs >= sms;
#define TOP2_ARGS                                                                                \
    q_hi, q_lo, q_rows, r_hi, r_lo, r_rows, pair_a, pair_b, n_desc, n_refs, num_pairs, nq,        \
        view_rows, out_idx, out_d1, out_d2, s
#define TOP2_DISPATCH(F32, D)                                                                    \
    return two ? launch_tc<F32, D, 2>(TOP2_ARGS) : launch_tc<F32, D, 1>(TOP2_ARGS)
    if (d == 128) {
        if (bf16) TOP2_DISPATCH(false, 128);
        TOP2_DISPATCH(true, 128);
    }
    if (d == 64) {
        if (bf16) TOP2_DISPATCH(false, 64);
        TOP2_DISPATCH(true, 64);
    }
#undef TOP2_DISPATCH
#undef TOP2_ARGS
    return ERR_ARGS;
}
