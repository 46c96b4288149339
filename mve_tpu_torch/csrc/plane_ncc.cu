// Slanted-plane NCC on the card: the tap loop of mvs/patch._plane_tap_sums
// in one kernel, for Hopper (sm_90a).
//
// Replaces no TPU kernel: mve_tpu scores slanted patches with plain XLA
// (mve_tpu/mvs/patch.py), and the port's tensor program
// (mve_tpu_torch/mvs/patch._plane_tap_sums_plain) is this kernel's plain
// version. That program runs some 40 element-wise kernels a tap over the
// whole (lead, K, H, W) stack, most of them float64 casts and adds of its
// emulated fused multiply-adds; the warp solver spent about half its
// device time there.
//
// For each output (s, k, y, x) -- view jidx[s, k, y, x] of the lead, plane
// k of the stack, pixel (y, x) -- it computes what the plain program
// computes there, bit for bit:
//  * for each tap (dy, dx) of the fw x fw window, row by row: the tap's ray
//    length L = (depth + dx*dzx) + dy*dzy, L > 0, z = L * ray_z at the
//    edge-replicated tap, the reprojection rows
//    _fma((T[i][0]*qx + T[i][1]*qy) + T[i][2], z, t[i]), the 1e-20 guard,
//    u = hx / hz - 0.5 and v, the bounds against the view's own (h, w),
//    the clipped corner, the fractions, the corner index clamped to the
//    padded (Hn, Wn), the four texels and _bilinear's three _fmas, then
//    the sums of the neighbour values, their squares and their products
//    with the reference;
//  * the reference's sums over the same taps, its mean and variance, the
//    covariance, sqrt(clamp(var_r * var_n, 1e-12)) and cov / denom.
// Every float32 multiply and add is __fmul_rn / __fadd_rn (nvcc contracts
// a*b + c into one rounding by default); every _fma is one float64 fused
// multiply-add rounded back to float32, which is the plain program's
// float64 multiply and add to the bit (see fma64);
// divisions and the square root are IEEE; clamps let NaN through as
// torch.clamp and torch.minimum do. Once a tap is out of bounds, or any
// tap's L is not above 0, the output is (-1, false) whatever the other
// taps hold, so the rest is skipped.
//
// What bounds it: float64 work, not bytes. At the warp solver's K = 10
// call (S = 4 views, 1241x376) it reads the planes and the view index (71
// MB) and writes 94 MB, about 0.05 ms at 3.35 TB/s, and runs 18.7 M windows
// of up to 25 taps, each tap 8 float64 fused multiply-adds, or 16
// operations (up to 7.5 G: 0.22 ms at 34 TFLOP/s), some 25 conversions
// between float32 and float64 (a quarter of the float64 rate) and 4 texel
// reads that hit L1 or L2 (the neighbours are 37 MB). One thread a (k, y, x) loops
// over the lead, so the reference's sums are taken once for all the lead's
// views; blocks are 32x4 pixel tiles of one plane, so one view's texels
// stay in L1 for the tile; the views' operators and sizes sit in shared
// memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// _fma: float64 a * b + c rounded to float32. The plain program multiplies
// and then adds in float64; one fused multiply-add gives the same bits,
// because the product of two float32 values is exact in float64 (at most
// 48 significant bits, and its exponent stays inside float64's normal
// range), so rounding a*b + c once is rounding the plain program's sum.
__device__ __forceinline__ float fma64(float a, float b, float c) {
    return __double2float_rn(__fma_rn((double)a, (double)b, (double)c));
}

// torch.clamp(x, lo, hi): min(max(x, lo), hi), NaN passed through.
__device__ __forceinline__ float clamp_nan(float x, float lo, float hi) {
    return x != x ? x : fminf(fmaxf(x, lo), hi);
}

// torch.clamp(x, min=lo).
__device__ __forceinline__ float clamp_min_nan(float x, float lo) {
    return x != x ? x : fmaxf(x, lo);
}

// _index: a corner (NaN or inside [min(0, hi), hi]) cast to an integer
// and clamped to [0, max(hi, 0)]; the cast takes NaN to 0.
__device__ __forceinline__ int corner_index(float c, int hi) {
    return min(max(__float2int_rz(c), 0), max(hi, 0));
}

// A tap's ray length on the plane: (depth + dx*dzx) + dy*dzy.
__device__ __forceinline__ float ray_length(float d, float zx, float zy, int dx, int dy) {
    return __fadd_rn(__fadd_rn(d, __fmul_rn((float)dx, zx)), __fmul_rn((float)dy, zy));
}

constexpr int kView = 14;   // T (9), t (3), h, w

__global__ void plane_ncc_kernel(const float* __restrict__ ref, const float* __restrict__ ray_z,
                                 int H, int W, const float* __restrict__ neigh, int J, int Hn,
                                 int Wn, const float* __restrict__ T,
                                 const float* __restrict__ tvec,
                                 const float* __restrict__ hw, const int64_t* __restrict__ jidx,
                                 long long js0, long long js1, long long js2, long long js3,
                                 const float* __restrict__ depths, const float* __restrict__ dzx,
                                 const float* __restrict__ dzy, int K, int lead, int fw,
                                 float inv_n, float* __restrict__ ncc, bool* __restrict__ valid) {
    extern __shared__ float views[];
    for (int i = threadIdx.y * blockDim.x + threadIdx.x; i < J; i += blockDim.x * blockDim.y) {
        float* v = views + i * kView;
        for (int e = 0; e < 9; ++e) v[e] = T[i * 9 + e];
        for (int e = 0; e < 3; ++e) v[9 + e] = tvec[i * 3 + e];
        v[12] = hw ? hw[i * 2] : (float)Hn;
        v[13] = hw ? hw[i * 2 + 1] : (float)Wn;
    }
    __syncthreads();

    const int x = blockIdx.x * blockDim.x + threadIdx.x;
    const int y = blockIdx.y * blockDim.y + threadIdx.y;
    const int k = blockIdx.z;
    if (x >= W || y >= H) return;
    const long long px = (long long)y * W + x;
    const long long plane = (long long)k * H * W + px;
    const long long out_stride = (long long)K * H * W;
    const float d = depths[plane], zx = dzx[plane], zy = dzy[plane];
    const int r = fw / 2;

    // pos_ok and the reference's sums do not depend on the view.
    bool pos_all = true;
    float sum_r = 0.0f, sum_rr = 0.0f;
    for (int dy = -r; dy <= r; ++dy) {
        const int cy = min(max(y + dy, 0), H - 1);
        for (int dx = -r; dx <= r; ++dx) {
            const int cx = min(max(x + dx, 0), W - 1);
            const float rv = ref[(long long)cy * W + cx];
            sum_r = __fadd_rn(sum_r, rv);
            sum_rr = fma64(rv, rv, sum_rr);
            pos_all = pos_all && (ray_length(d, zx, zy, dx, dy) > 0.0f);
        }
    }
    if (!pos_all) {
        for (int s = 0; s < lead; ++s) {
            ncc[s * out_stride + plane] = -1.0f;
            valid[s * out_stride + plane] = false;
        }
        return;
    }
    const float mean_r = __fmul_rn(sum_r, inv_n);
    const float var_r = fma64(sum_rr, inv_n, -__fmul_rn(mean_r, mean_r));
    const long long jpx = (long long)k * js1 + (long long)y * js2 + (long long)x * js3;

    for (int s = 0; s < lead; ++s) {
        const long long j = jidx[s * js0 + jpx];
        if (j < 0 || j >= J) __trap();   // an index the plain gather would refuse
        const float* v = views + j * kView;
        const float h = v[12], w = v[13];
        const float* img = neigh + j * (long long)Hn * Wn;
        bool ok = true;
        float sum_n = 0.0f, sum_nn = 0.0f, sum_rn = 0.0f;
        for (int dy = -r; dy <= r && ok; ++dy) {
            const int cy = min(max(y + dy, 0), H - 1);
            const float qy = __fadd_rn((float)(y + dy), 0.5f);
            for (int dx = -r; dx <= r; ++dx) {
                const int cx = min(max(x + dx, 0), W - 1);
                const long long c = (long long)cy * W + cx;
                const float rv = ref[c];
                const float z = __fmul_rn(ray_length(d, zx, zy, dx, dy), ray_z[c]);
                const float qx = __fadd_rn((float)(x + dx), 0.5f);
                float hrow[3];
#pragma unroll
                for (int i = 0; i < 3; ++i) {
                    const float* row = v + 3 * i;
                    const float a =
                        __fadd_rn(__fadd_rn(__fmul_rn(row[0], qx), __fmul_rn(row[1], qy)), row[2]);
                    hrow[i] = fma64(a, z, v[9 + i]);
                }
                const float hz = hrow[2];
                const float hz_safe = fabsf(hz) < 1e-20f ? 1e-20f : hz;
                const float u = __fsub_rn(__fdiv_rn(hrow[0], hz_safe), 0.5f);
                const float vv = __fsub_rn(__fdiv_rn(hrow[1], hz_safe), 0.5f);
                if (!((u >= 0.0f) && (u <= __fsub_rn(w, 1.0f)) && (vv >= 0.0f) &&
                      (vv <= __fsub_rn(h, 1.0f)) && (hz > 0.0f))) {
                    ok = false;
                    break;
                }
                const float u0 = clamp_nan(floorf(u), 0.0f, __fsub_rn(w, 2.0f));
                const float v0 = clamp_nan(floorf(vv), 0.0f, __fsub_rn(h, 2.0f));
                const float fu = clamp_nan(__fsub_rn(u, u0), 0.0f, 1.0f);
                const float fv = clamp_nan(__fsub_rn(vv, v0), 0.0f, 1.0f);
                const int ui = corner_index(u0, Wn - 2), vi = corner_index(v0, Hn - 2);
                const float* p = img + (long long)vi * Wn + ui;
                const float p00 = p[0], p01 = p[1], p10 = p[Wn], p11 = p[Wn + 1];
                const float gu = __fsub_rn(1.0f, fu), gv = __fsub_rn(1.0f, fv);
                float nv = fma64(__fmul_rn(p00, gu), gv, __fmul_rn(__fmul_rn(p01, fu), gv));
                nv = fma64(__fmul_rn(p10, gu), fv, nv);
                nv = fma64(__fmul_rn(p11, fu), fv, nv);
                sum_n = __fadd_rn(sum_n, nv);
                sum_nn = fma64(nv, nv, sum_nn);
                sum_rn = fma64(rv, nv, sum_rn);
            }
        }
        float out = -1.0f;
        if (ok) {
            const float mean_n = __fmul_rn(sum_n, inv_n);
            const float var_n = fma64(sum_nn, inv_n, -__fmul_rn(mean_n, mean_n));
            const float cov = fma64(sum_rn, inv_n, -__fmul_rn(mean_r, mean_n));
            const float denom = __fsqrt_rn(clamp_min_nan(__fmul_rn(var_r, var_n), 1e-12f));
            out = __fdiv_rn(cov, denom);
        }
        ncc[s * out_stride + plane] = out;
        valid[s * out_stride + plane] = ok;
    }
}

}  // namespace

// ncc, valid (lead, K, H, W) = the slanted-plane NCC of each plane of
// depths/dzx/dzy (K, H, W) in view jidx[s, k, y, x] of neigh (J, Hn, Wn),
// the view index read with element strides js0..js3 (0 along a broadcast
// dimension). T (J, 3, 3), tvec (J, 3); hw (J, 2) each view's own (height,
// width) inside (Hn, Wn), or null where every view fills it. Returns
// cudaGetLastError() after the launch (98 for shapes it does not take).
// Nothing is synchronised.
extern "C" int plane_ncc_launch(const float* ref, const float* ray_z, int H, int W,
                                const float* neigh, int J, int Hn, int Wn, const float* T,
                                const float* tvec, const float* hw, const int64_t* jidx,
                                long long js0, long long js1, long long js2, long long js3,
                                const float* depths, const float* dzx, const float* dzy, int K,
                                int lead, int fw, float inv_n, float* ncc, bool* valid,
                                void* stream) {
    const size_t shared = (size_t)J * kView * sizeof(float);
    if (H < 1 || W < 1 || K < 1 || K > 65535 || J < 1 || lead < 1 || fw < 1 || shared > 48 * 1024)
        return 98;
    const dim3 block(32, 4);
    const dim3 grid((W + 31) / 32, (H + 3) / 4, K);
    plane_ncc_kernel<<<grid, block, shared, static_cast<cudaStream_t>(stream)>>>(
        ref, ray_z, H, W, neigh, J, Hn, Wn, T, tvec, hw, jidx, js0, js1, js2, js3, depths, dzx,
        dzy, K, lead, fw, inv_n, ncc, valid);
    return static_cast<int>(cudaGetLastError());
}
