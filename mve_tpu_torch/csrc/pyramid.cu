// MVS level images on the card: the gray plane of a decoded image and its
// Gaussian half-size levels, for Hopper (sm_90a).
//
// Replaces no TPU kernel: mve_tpu builds level images in numpy on the
// host (mve_tpu/mvs/pyramid.py), and the port's numpy path
// (mve_tpu_torch/mvs/pyramid.py: half_size_gaussian_np applied `level`
// times to _to_gray) is this kernel's plain version. It was
// added because a level miss spent most of its time in float32 arithmetic
// over full-resolution planes on the host (3072x2048 at fountain-P11).
//
// The result is that numpy path bit for bit, so depth maps do not move:
//  * gray: x / 255 (uint8), x / 65535 (uint16) or x (float32), then
//    (0.30*r + 0.59*g) + 0.11*b in float32 with three or more channels,
//    channel 0 with fewer;
//  * a halving: out[y][x] = sum over dy of kern[dy] * (sum over dx of
//    kern[dx] * in[clamp(2y+dy-1)][clamp(2x+dx-1)]), dx then dy from 0 to
//    3, each sum started at 0, as numpy's edge padding and += loops do.
// Every multiply and add is __fmul_rn / __fadd_rn: nvcc contracts a*b + c
// into an FMA by default, which rounds once and changes the bits. The
// taps come from the caller (numpy's normalised float32 vector).
//
// What bounds it: bytes. A fountain-P11 image (3072x2048 RGB uint8, 18.9
// MB) to its 768x512 level reads the image once and writes 6.3 + 1.6 MB of
// levels, a few microseconds at 3.35 TB/s; the copy of the image over PCIe
// and its decode on the host are far larger. So the design is plain: one
// thread an output pixel over 32x8 tiles, edges clamped in the index, the
// gray step fused into the first halving (the gray plane is never
// stored), the four input rows a thread reads shared through L1 with its
// neighbours.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float unit(uint8_t v) { return __fdiv_rn((float)v, 255.0f); }
__device__ __forceinline__ float unit(uint16_t v) { return __fdiv_rn((float)v, 65535.0f); }
__device__ __forceinline__ float unit(float v) { return v; }

// One pixel of the gray plane of an (h, w, c) image.
template <typename T>
__device__ __forceinline__ float gray(const T* img, int w, int c, int y, int x) {
    const T* px = img + ((long long)y * w + x) * c;
    if (c < 3) return unit(px[0]);
    const float r = unit(px[0]), g = unit(px[1]), b = unit(px[2]);
    return __fadd_rn(__fadd_rn(__fmul_rn(0.30f, r), __fmul_rn(0.59f, g)), __fmul_rn(0.11f, b));
}

struct Taps {
    float k[4];
};

template <typename T>
__global__ void gray_kernel(const T* img, int h, int w, int c, float* out) {
    const int x = blockIdx.x * blockDim.x + threadIdx.x;
    const int y = blockIdx.y * blockDim.y + threadIdx.y;
    if (x >= w || y >= h) return;
    out[(long long)y * w + x] = gray(img, w, c, y, x);
}

// One halving of the gray plane of an (h, w, c) image; a float plane is
// the case T = float, c = 1.
template <typename T>
__global__ void half_kernel(const T* img, int h, int w, int c, Taps t, float* out) {
    const int ow = (w + 1) >> 1, oh = (h + 1) >> 1;
    const int x = blockIdx.x * blockDim.x + threadIdx.x;
    const int y = blockIdx.y * blockDim.y + threadIdx.y;
    if (x >= ow || y >= oh) return;
    int xs[4];
#pragma unroll
    for (int d = 0; d < 4; ++d) xs[d] = min(max(2 * x + d - 1, 0), w - 1);
    float acc = 0.0f;
#pragma unroll
    for (int dy = 0; dy < 4; ++dy) {
        const int yy = min(max(2 * y + dy - 1, 0), h - 1);
        float inner = 0.0f;
#pragma unroll
        for (int dx = 0; dx < 4; ++dx)
            inner = __fadd_rn(inner, __fmul_rn(t.k[dx], gray(img, w, c, yy, xs[dx])));
        acc = __fadd_rn(acc, __fmul_rn(t.k[dy], inner));
    }
    out[(long long)y * ow + x] = acc;
}

const dim3 kBlock(32, 8);

dim3 grid_for(int h, int w) { return dim3((w + 31) / 32, (h + 7) / 8); }

}  // namespace

// dtype: 0 uint8, 1 uint16, 2 float32. Each returns cudaGetLastError()
// after its launch (99 for an unknown dtype). Nothing is synchronised.

// out (h, w) = the gray plane of img (h, w, c).
extern "C" int pyramid_gray_launch(const void* img, int dtype, int h, int w, int c, float* out,
                                   void* stream) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const dim3 grid = grid_for(h, w);
    switch (dtype) {
        case 0: gray_kernel<<<grid, kBlock, 0, s>>>((const uint8_t*)img, h, w, c, out); break;
        case 1: gray_kernel<<<grid, kBlock, 0, s>>>((const uint16_t*)img, h, w, c, out); break;
        case 2: gray_kernel<<<grid, kBlock, 0, s>>>((const float*)img, h, w, c, out); break;
        default: return 99;
    }
    return static_cast<int>(cudaGetLastError());
}

// out ((h+1)/2, (w+1)/2) = one halving of the gray plane of img (h, w, c),
// with the taps k0..k3.
extern "C" int pyramid_half_launch(const void* img, int dtype, int h, int w, int c, float k0,
                                   float k1, float k2, float k3, float* out, void* stream) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const Taps t{{k0, k1, k2, k3}};
    const dim3 grid = grid_for((h + 1) >> 1, (w + 1) >> 1);
    switch (dtype) {
        case 0: half_kernel<<<grid, kBlock, 0, s>>>((const uint8_t*)img, h, w, c, t, out); break;
        case 1: half_kernel<<<grid, kBlock, 0, s>>>((const uint16_t*)img, h, w, c, t, out); break;
        case 2: half_kernel<<<grid, kBlock, 0, s>>>((const float*)img, h, w, c, t, out); break;
        default: return 99;
    }
    return static_cast<int>(cudaGetLastError());
}
