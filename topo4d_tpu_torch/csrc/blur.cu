// Separable Gaussian blur for SSIM (K5) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel topo4d_tpu/losses/blur_pallas.py
// _blur_kernel (:52), launched by _blur_padded (:87) under gauss_blur_pallas
// (:123), whose custom VJP (:154-163) is the same kernel on the cotangent.
//
// Contract. x is (C, H, W) float32, contiguous. For every channel, the
// 11-tap 1-D Gaussian (taps g[0..10], symmetric, given by the caller) runs
// down the columns and then along the rows, both "same" size with zero
// padding outside the image:
//   mid[y][x] = sum_k g[k] x[y + k - 5][x],  out[y][x] = sum_k g[k] mid[y][x + k - 5]
// Each sum is accumulated in the plain PyTorch version's order
// (losses/blur.py _shift_pass): acc = g0 * v0, then acc = acc + g_k * v_k for
// k = 1..10, every product and sum rounded on its own (--fmad=false), so the
// result equals the plain version bit for bit. Symmetric taps and zero
// padding make the blur its own transpose: the backward is this kernel on
// the cotangent.
//
// Bound on an H100 SXM. Each launch must read C*H*W floats and write as
// many: at the dense phase's 15 x 2160 x 3840 that is 497.7 MB each way,
// ~0.30 ms at 3.35 TB/s. The arithmetic is 42 FP32 operations per output
// (21 per pass), 5.2 GFLOP, ~0.08 ms at 67 TFLOP/s. So bytes bound it.
//
// Design. One block of 32 x 8 threads per (channel, 32 x 32 output tile).
// The block stages its (32 + 10) x (32 + 10) input halo in shared memory,
// zero outside the image (the "same" padding, with no padded copy in device
// memory), runs the vertical taps into a shared 32 x 42 buffer, then the
// horizontal taps into the output. The halo re-reads 72% more input than
// the tile (partly from L2); no TF32, no tensor cores.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int K = 11;  // taps
constexpr int HALF = K / 2;
constexpr int TW = 32;  // output tile width
constexpr int TH = 32;  // output tile height
constexpr int BX = 32;
constexpr int BY = 8;
constexpr int NT = BX * BY;
constexpr int IW = TW + 2 * HALF;  // staged columns
constexpr int IH = TH + 2 * HALF;  // staged rows

struct Taps {
  float g[K];
};

__global__ void __launch_bounds__(NT) gauss_blur_kernel(
    const float* __restrict__ x, float* __restrict__ out, int h, int w,
    Taps taps) {
  __shared__ float s_in[IH][IW];
  __shared__ float s_mid[TH][IW];
  const int64_t plane = (int64_t)h * w;
  const float* xc = x + (int64_t)blockIdx.z * plane;
  float* oc = out + (int64_t)blockIdx.z * plane;
  const int ox = blockIdx.x * TW;
  const int oy = blockIdx.y * TH;
  const int tid = threadIdx.y * BX + threadIdx.x;

  for (int i = tid; i < IH * IW; i += NT) {
    const int r = i / IW;
    const int q = i - r * IW;
    const int gy = oy - HALF + r;
    const int gx = ox - HALF + q;
    s_in[r][q] = (gy >= 0 && gy < h && gx >= 0 && gx < w)
                     ? xc[(int64_t)gy * w + gx]
                     : 0.0f;
  }
  __syncthreads();

  // vertical taps over every staged column (halo columns included)
  for (int i = tid; i < TH * IW; i += NT) {
    const int r = i / IW;
    const int q = i - r * IW;
    float acc = taps.g[0] * s_in[r][q];
#pragma unroll
    for (int k = 1; k < K; ++k) acc = acc + taps.g[k] * s_in[r + k][q];
    s_mid[r][q] = acc;
  }
  __syncthreads();

  // horizontal taps: one output column per thread lane
  const int q = threadIdx.x;
  const int gx = ox + q;
  for (int r = threadIdx.y; r < TH; r += BY) {
    float acc = taps.g[0] * s_mid[r][q];
#pragma unroll
    for (int k = 1; k < K; ++k) acc = acc + taps.g[k] * s_mid[r][q + k];
    const int gy = oy + r;
    if (gy < h && gx < w) oc[(int64_t)gy * w + gx] = acc;
  }
}

}  // namespace

// Launches K5 on ``stream`` with the K taps read from the host array
// ``taps``; returns cudaGetLastError() (0 = launched).
extern "C" int gauss_blur(const void* x, void* out, int c, int h, int w,
                          const float* taps, void* stream) {
  Taps t;
  for (int k = 0; k < K; ++k) t.g[k] = taps[k];
  if (c > 0 && h > 0 && w > 0) {
    const dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, c);
    const dim3 block(BX, BY);
    gauss_blur_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        (const float*)x, (float*)out, h, w, t);
  }
  return (int)cudaGetLastError();
}
