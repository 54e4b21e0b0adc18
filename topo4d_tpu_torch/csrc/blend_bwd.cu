// Tile-blend backward (K2) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel topo4d_tpu/rasterizer/pallas_blend.py
// _bwd_kernel (:942, helpers _bwd_window_grads :1111, _bwd_one_tile :1196)
// and, through the identical contract, pallas_resident.py _res_bwd_kernel
// (:165).
//
// Contract. Given K1's inputs, K1's output ``fwd`` (T, 8, 256) and the
// cotangent ``g`` of that output (rows 0-2 rgb, 3 depth, 4 T_final; rows 5-7
// carry no gradient), write dL/d{x, y, conic a, b, c, opacity, r, g, b,
// depth} of every entry in a tile range into rows 0-5 and 8-11 of
// ``dpacked`` (16, E_pad). The caller zero-fills dpacked; entries outside
// every range and past every pixel's last contributor stay zero. The 0.99
// alpha clamp passes the gradient straight through (dalpha/dG = opacity
// even when clamped), as the reference's rasterizer backward does.
// Compact mode (tile_ids not null): block b walks the range tile_start[b],
// tile_count[b] of global tile tile_ids[b], with rows b of fwd and g; a
// padding row (count 0) writes nothing.
//
// Math, per pixel, back to front over its contributors i (those K1 blended):
//   T_i = T_{i+1} / (1 - alpha_i)          (T before entry i; T_last+1 = T_final)
//   w_i = alpha_i T_i,  s_i = g_rgb . c_i + g_depth d_i
//   dL/dalpha_i = T_i s_i - (S_i + g_T T_final) / (1 - alpha_i),
//   S_i = sum_{j > i} w_j s_j             (accumulated on the way back)
// Transmittance is rebuilt by DIVISION, T /= (1 - alpha). That is safe here:
// alpha <= 0.99 so 1 - alpha >= 0.01, and K1 never lets T fall below 1e-4,
// so the rebuilt T stays in [1e-4, 1] and each step adds one rounding. (The
// TPU kernel rebuilt T in log space because it summed log1p(-alpha) over
// whole 128-entry windows, past the termination point, where a product
// underflows and a division gives 0/0; a sequential per-pixel loop that
// starts at the saved last contributor never visits those entries.)
//
// Bound on an H100 SXM. Bytes: the ten field rows of the entries a tile
// visits (up to its pixels' furthest last contributor), read once and
// written once (0.8 MB each way at ~21k entries on a trained head-scale
// view), rows 4-5 of the forward output and rows 0-4 of its cotangent
// (5.5 MB): ~2.1 us at 3.35 TB/s. Arithmetic: 55 FP32 operations per
// contributing (pixel, entry) pair and 16 per other visited pair, ~100M
// operations: ~1.5 us at 67 TFLOP/s. Bytes bound the work; the kernel is
// latency- and shuffle-bound.
//
// Design. The same block/tile mapping as K1: one block of 256 threads per
// tile, one thread per pixel. The block walks its range back to front in
// batches of 128 entries staged in shared memory, starting from the largest
// saved last-contributor count of its pixels. For each entry, every thread
// computes its ten partial gradients (zero where the entry did not
// contribute to its pixel), each warp sums them with shuffles (skipped when
// no lane of the warp contributes), and lane 0 stores the warp's sum in a
// per-warp shared-memory slot. At the end of the batch the eight warp slots
// are added in a fixed order and each entry's column is written once. Every
// entry belongs to exactly one tile, so no reduction leaves the block: no
// global atomics, and the result is deterministic.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false, so the
// skip decisions recomputed here equal K1's bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 16;
constexpr int PX = TILE * TILE;
constexpr int BATCH = 128;
constexpr int WARPS = PX / 32;
constexpr int NG = 10;  // gradient fields per entry
constexpr float ALPHA_MAX = 0.99f;
constexpr float ALPHA_MIN = 1.0f / 255.0f;

// gradient field f -> packed row
__device__ __forceinline__ int grad_row(int f) { return f < 6 ? f : f + 2; }

__global__ void __launch_bounds__(PX) tile_blend_bwd_kernel(
    const float* __restrict__ packed, int64_t e_pad,
    const int32_t* __restrict__ tile_start,
    const int32_t* __restrict__ tile_count,
    const int32_t* __restrict__ tile_ids, int tiles_x,
    const float* __restrict__ fwd, const float* __restrict__ g_out,
    float* __restrict__ dpacked) {
  const int row = blockIdx.x;
  const int tile = tile_ids ? tile_ids[row] : row;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const float px = (float)((tile % tiles_x) * TILE + (p % TILE));
  const float py = (float)((tile / tiles_x) * TILE + (p / TILE));
  const int64_t start = tile_start[row];
  const int count = tile_count[row];

  const float* fo = fwd + (int64_t)row * 8 * PX + p;
  const float* go = g_out + (int64_t)row * 8 * PX + p;
  const float t_final = fo[4 * PX];
  const int last = min((int)fo[5 * PX], count);
  const float g_r = go[0 * PX], g_g = go[1 * PX], g_b = go[2 * PX];
  const float g_d = go[3 * PX];
  const float tail = go[4 * PX] * t_final;

  __shared__ float s_x[BATCH], s_y[BATCH], s_a[BATCH], s_b[BATCH];
  __shared__ float s_c[BATCH], s_o[BATCH];
  __shared__ float s_r[BATCH], s_g[BATCH], s_bl[BATCH], s_d[BATCH];
  __shared__ float s_acc[WARPS][NG][BATCH];
  __shared__ int s_max_last;

  if (p == 0) s_max_last = 0;
  __syncthreads();
  const int warp_max = __reduce_max_sync(0xffffffffu, last);
  if (lane == 0) atomicMax(&s_max_last, warp_max);
  __syncthreads();
  const int max_last = s_max_last;

  float T = t_final;  // transmittance after the current entry
  float S = 0.0f;     // sum over later contributors of w_j s_j

  for (int base = ((max_last + BATCH - 1) / BATCH - 1) * BATCH; base >= 0;
       base -= BATCH) {
    const int nb = min(BATCH, max_last - base);
    __syncthreads();  // the previous batch's shared data is consumed
    if (p < nb) {
      const float* e = packed + start + base + p;
      s_x[p] = e[0 * e_pad];
      s_y[p] = e[1 * e_pad];
      s_a[p] = e[2 * e_pad];
      s_b[p] = e[3 * e_pad];
      s_c[p] = e[4 * e_pad];
      s_o[p] = e[5 * e_pad];
      s_r[p] = e[8 * e_pad];
      s_g[p] = e[9 * e_pad];
      s_bl[p] = e[10 * e_pad];
      s_d[p] = e[11 * e_pad];
    }
    __syncthreads();
    for (int j = nb - 1; j >= 0; --j) {
      float gr[NG];
#pragma unroll
      for (int f = 0; f < NG; ++f) gr[f] = 0.0f;
      bool contrib = false;
      if (base + j < last) {
        const float dx = s_x[j] - px;
        const float dy = s_y[j] - py;
        const float power =
            -0.5f * (s_a[j] * dx * dx + s_c[j] * dy * dy) - s_b[j] * dx * dy;
        if (power <= 0.0f) {
          const float G = expf(power);
          const float op = s_o[j];
          const float alpha = fminf(ALPHA_MAX, op * G);
          if (alpha >= ALPHA_MIN) {
            contrib = true;
            const float one_m = 1.0f - alpha;
            const float t_i = T / one_m;
            const float w = alpha * t_i;
            const float s =
                g_r * s_r[j] + g_g * s_g[j] + g_b * s_bl[j] + g_d * s_d[j];
            const float dalpha = t_i * s - (S + tail) / one_m;
            S += w * s;
            T = t_i;
            const float dpow = dalpha * op * G;
            gr[0] = -dpow * (s_a[j] * dx + s_b[j] * dy);  // x
            gr[1] = -dpow * (s_c[j] * dy + s_b[j] * dx);  // y
            gr[2] = -0.5f * dpow * dx * dx;               // conic a
            gr[3] = -dpow * dx * dy;                      // conic b
            gr[4] = -0.5f * dpow * dy * dy;               // conic c
            gr[5] = dalpha * G;                           // opacity
            gr[6] = g_r * w;
            gr[7] = g_g * w;
            gr[8] = g_b * w;
            gr[9] = g_d * w;
          }
        }
      }
      if (__any_sync(0xffffffffu, contrib)) {
#pragma unroll
        for (int f = 0; f < NG; ++f) {
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            gr[f] += __shfl_down_sync(0xffffffffu, gr[f], off);
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int f = 0; f < NG; ++f) s_acc[warp][f][j] = gr[f];
      }
    }
    __syncthreads();
    for (int idx = p; idx < NG * nb; idx += PX) {
      const int f = idx / nb;
      const int j = idx - f * nb;
      float sum = 0.0f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) sum += s_acc[w][f][j];
      dpacked[grad_row(f) * e_pad + start + base + j] = sum;
    }
  }
}

}  // namespace

// Launches K2 over ``num_rows`` rows on ``stream`` (``tile_ids`` null:
// row r is tile r); returns cudaGetLastError() (0 = launched).
extern "C" int tile_blend_bwd(const void* packed, int64_t e_pad,
                              const void* tile_start, const void* tile_count,
                              const void* tile_ids, int tiles_x, int num_rows,
                              const void* fwd, const void* g_out,
                              void* dpacked, void* stream) {
  if (num_rows > 0) {
    tile_blend_bwd_kernel<<<num_rows, PX, 0, (cudaStream_t)stream>>>(
        (const float*)packed, e_pad, (const int32_t*)tile_start,
        (const int32_t*)tile_count, (const int32_t*)tile_ids, tiles_x,
        (const float*)fwd, (const float*)g_out, (float*)dpacked);
  }
  return (int)cudaGetLastError();
}
