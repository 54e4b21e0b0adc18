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
// k = 1..10, every product and sum rounded on its own (--fmad=false; the
// symmetric taps are not folded, which would round differently), so the
// result equals the plain version bit for bit. Symmetric taps and zero
// padding make the blur its own transpose: the backward is this kernel on
// the cotangent.
//
// Bound on an H100 SXM. Each launch must read C*H*W floats and write as
// many: at the dense phase's 15 x 2160 x 3840 that is 497.7 MB each way,
// 0.297 ms at 3.35 TB/s. The arithmetic is 42 FP32 operations per output
// (21 per pass), 5.2 GFLOP, 0.078 ms at 67 TFLOP/s; as separate multiplies
// and adds it is ~0.16 ms of issue, which can hide under the bytes. So bytes
// bound it. Measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700.00 W):
// 0.461 ms through its wrapper at (15, 2160, 3840), 64.5% of its bound
// (the kernel alone 0.459 ms); at (15, 512, 375) the kernel alone takes
// 0.021-0.022 ms and the wrapper 0.022-0.036 ms over four runs, its host
// work per call as long as the kernel.
//
// Design. One block of 160 threads owns a strip of 128 output columns and a
// run of 80 output rows of one channel, and walks down the run in chunks of
// 10 rows. Vertical pass in registers: thread q < 138 owns input column
// ox - 5 + q (the strip and its 10-column halo) and keeps an 11-deep window
// of that column in registers; each row shifts one new value in and yields
// one mid value. The thread copies its own column's next rows into shared
// memory with 4-byte cp.async (zero-filled outside the image: the "same"
// padding on load, no padded copy in device memory), two chunks ahead in a
// three-deep ring, so a warp's copy is one coalesced 128-byte row segment
// and the loads of later rows overlap the taps of this one. Horizontal pass:
// the chunk's mid rows go to a double-buffered shared row buffer; each
// thread computes 4 consecutive outputs of a row from 16 values read with
// four float4 shared loads (16-byte stores when W is a multiple of 4). The
// halos re-read 8% more columns and 12.5% more rows than the block writes.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int K = 11;  // taps
constexpr int HALF = K / 2;
constexpr int SW = 128;            // output columns per strip
constexpr int IC = SW + 2 * HALF;  // input columns a strip reads
constexpr int NT = 160;            // threads: IC of them run the vertical pass
constexpr int CH = 10;             // rows per chunk
constexpr int RUN = 80;            // output rows per block
constexpr int RING = 3;            // chunks of input in flight or in use
constexpr int OPT = 4;             // outputs per thread in the horizontal pass
constexpr int GPR = SW / OPT;      // output groups per row
constexpr int MID_W = SW + 16;     // a mid row, padded for the last group's float4 reads
static_assert(IC <= NT && RUN % CH == 0 && (CH * GPR) % NT == 0, "block shape");

struct Taps {
  float g[K];
};

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__global__ void __launch_bounds__(NT) gauss_blur_kernel(
    const float* __restrict__ x, float* __restrict__ out, int h, int w,
    Taps taps) {
  __shared__ float s_in[RING][CH][IC];
  __shared__ __align__(16) float s_mid[2][CH][MID_W];
  const int64_t plane = (int64_t)h * w;
  const float* xc = x + (int64_t)blockIdx.z * plane;
  float* oc = out + (int64_t)blockIdx.z * plane;
  const int ox = blockIdx.x * SW;
  const int oy = blockIdx.y * RUN;
  const int t = threadIdx.x;
  const int rows = min(RUN, h - oy);          // output rows of this block
  const int chunks = 1 + (rows + CH - 1) / CH;  // chunk 0 only fills the window
  const int gx = ox - HALF + t;               // this thread's input column
  const bool col_in = t < IC && gx >= 0 && gx < w;
  const bool vec = (w & 3) == 0;              // 16-byte aligned output groups

  // chunk c holds input rows oy - 5 + 10c .. oy + 4 + 10c of this thread's column
  auto issue = [&](int c) {
    if (t < IC && c < chunks) {
#pragma unroll
      for (int i = 0; i < CH; ++i) {
        const int gy = oy - HALF + c * CH + i;
        const bool ok = col_in && gy >= 0 && gy < h;
        cp_async4(&s_in[c % RING][i][t], ok ? xc + (int64_t)gy * w + gx : xc, ok);
      }
    }
    cp_async_commit();  // an empty group past the last chunk keeps the count
  };

  float win[K];  // win[K - 1] is the newest row
#pragma unroll
  for (int k = 0; k < K; ++k) win[k] = 0.0f;
  issue(0);
  issue(1);
  for (int c = 0; c < chunks; ++c) {
    // the ring slot of chunk c + 2 was read in iteration c - 1, before its barrier
    issue(c + 2);
    cp_async_wait<2>();  // this thread's copies of chunk c have landed
    if (t < IC) {
      float* mid = &s_mid[c & 1][0][t];
#pragma unroll
      for (int i = 0; i < CH; ++i) {
#pragma unroll
        for (int k = 0; k < K - 1; ++k) win[k] = win[k + 1];
        win[K - 1] = s_in[c % RING][i][t];
        float acc = taps.g[0] * win[0];
#pragma unroll
        for (int k = 1; k < K; ++k) acc = acc + taps.g[k] * win[k];
        mid[i * MID_W] = acc;  // chunk 0's values are never read
      }
    }
    __syncthreads();  // chunk c's mids are visible; chunk c - 1's ring slot is free
    if (c == 0) continue;
    // chunk c's mids are output rows oy + 10 (c - 1) + m, m < CH
#pragma unroll
    for (int task = t; task < CH * GPR; task += NT) {
      const int m = task / GPR;
      const int x0 = (task % GPR) * OPT;  // within the strip
      const int r = CH * (c - 1) + m;     // within the run
      if (r >= rows || ox + x0 >= w) continue;
      const float4* src = reinterpret_cast<const float4*>(&s_mid[c & 1][m][x0]);
      float v[16];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 f = src[i];
        v[4 * i] = f.x;
        v[4 * i + 1] = f.y;
        v[4 * i + 2] = f.z;
        v[4 * i + 3] = f.w;
      }
      float o[OPT];
#pragma unroll
      for (int u = 0; u < OPT; ++u) {
        float acc = taps.g[0] * v[u];
#pragma unroll
        for (int k = 1; k < K; ++k) acc = acc + taps.g[k] * v[u + k];
        o[u] = acc;
      }
      float* dst = oc + (int64_t)(oy + r) * w + ox + x0;
      if (vec) {  // ox + x0 and w are multiples of 4: the group is whole
        *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
      } else {
#pragma unroll
        for (int u = 0; u < OPT; ++u)
          if (ox + x0 + u < w) dst[u] = o[u];
      }
    }
  }
  cp_async_wait<0>();
}

}  // namespace

// Launches K5 on ``stream`` with the K taps read from the host array
// ``taps``; returns cudaGetLastError() (0 = launched).
extern "C" int gauss_blur(const void* x, void* out, int c, int h, int w,
                          const float* taps, void* stream) {
  Taps t;
  for (int k = 0; k < K; ++k) t.g[k] = taps[k];
  if (c > 0 && h > 0 && w > 0) {
    const dim3 grid((w + SW - 1) / SW, (h + RUN - 1) / RUN, c);
    gauss_blur_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
        (const float*)x, (float*)out, h, w, t);
  }
  return (int)cudaGetLastError();
}
