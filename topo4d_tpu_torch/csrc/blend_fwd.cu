// Tile-blend forward (K1) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel topo4d_tpu/rasterizer/pallas_blend.py
// _fwd_kernel (:317, helpers _chunk_terms :253, _fwd_window :285,
// _fwd_general :423) and, through the identical contract, the VMEM-resident
// pallas_resident.py _res_fwd_kernel (:58).
//
// Contract. Entries are packed (16, E_pad) float32, sorted by (tile, depth);
// tile t blends entries [tile_start[t], tile_start[t] + tile_count[t]) front
// to back for each of its 16x16 pixels (pixel centers at integer
// coordinates):
//   power = -0.5 (a dx^2 + c dy^2) - b dx dy,   dx = x - px, dy = y - py
//   skip the entry if power > 0; alpha = min(0.99, opacity * exp(power));
//   skip if alpha < 1/255; stop BEFORE the entry whose T * (1 - alpha)
//   would fall below 1e-4; otherwise feature += f * alpha * T, T *= 1 - alpha.
// Output (T, 8, 256) float32: rows 0-2 rgb, 3 depth, 4 T_final, 5 the
// number of entries up to and including the pixel's last contributor (the
// backward's starting point; exact in float32 below 2^24), rows 6-7 zero.
// Compact mode (tile_ids not null, rasterizer/pallas.py:73-94): block b
// blends global tile tile_ids[b], which sets its pixel coordinates, over
// the range tile_start[b], tile_count[b], into output row b; padding rows
// carry the sentinel id tiles_x * tiles_y and count 0 and come out as
// T_final 1, all else 0.
//
// Bound on an H100 SXM. The kernel must read the ten field rows (40 B) of
// each entry of a tile's range up to where every pixel of the tile has
// stopped, and write the (T, 8, 256) output once: at the head-scale main
// path (768 tiles, ~21k entries in the ranges of a trained view) that is
// 0.8 MB of entries and 6.3 MB of output, ~2.1 us at 3.35 TB/s. The
// arithmetic is 16 FP32 operations per (pixel, entry) pair evaluated and
// 11 more per contributing pair, ~93M operations: ~1.4 us at 67 TFLOP/s.
// So the bound is bytes, and the real limit of this simple kernel is
// latency: a thread walks its tile's list sequentially.
//
// Design. One block of 256 threads per tile, one thread per pixel (the CUDA
// reference's mapping, not the TPU's matmul-over-windows). The block stages
// its own range in batches of 256 entries, read cooperatively and coalesced
// (one entry per thread, one field row at a time) into shared memory, so
// each entry is read from device memory once per tile. Every thread then
// runs the sequential loop over the batch from shared memory (broadcast
// reads). __syncthreads_count ends the block as soon as every pixel has
// terminated. No cumprod-as-matmul, bf16 splitting or window cache: those
// served the TPU's MXU and VMEM.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false.
// --fmad=false keeps every product and sum rounded on its own, in the same
// order as the plain PyTorch version, so skip and termination decisions
// match it bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 16;
constexpr int PX = TILE * TILE;
constexpr int BATCH = PX;
constexpr float ALPHA_MAX = 0.99f;
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float T_MIN = 1e-4f;

__global__ void __launch_bounds__(PX) tile_blend_fwd_kernel(
    const float* __restrict__ packed, int64_t e_pad,
    const int32_t* __restrict__ tile_start,
    const int32_t* __restrict__ tile_count,
    const int32_t* __restrict__ tile_ids, int tiles_x,
    float* __restrict__ out) {
  const int row = blockIdx.x;
  const int tile = tile_ids ? tile_ids[row] : row;
  const int p = threadIdx.x;
  const float px = (float)((tile % tiles_x) * TILE + (p % TILE));
  const float py = (float)((tile / tiles_x) * TILE + (p / TILE));
  const int64_t start = tile_start[row];
  const int count = tile_count[row];

  __shared__ float s_x[BATCH], s_y[BATCH], s_a[BATCH], s_b[BATCH];
  __shared__ float s_c[BATCH], s_o[BATCH];
  __shared__ float s_r[BATCH], s_g[BATCH], s_bl[BATCH], s_d[BATCH];

  float T = 1.0f;
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f, acc_d = 0.0f;
  int last = 0;
  bool done = false;

  for (int base = 0; base < count; base += BATCH) {
    // barrier: the previous batch is consumed before it is overwritten
    if (__syncthreads_count(done) == PX) break;
    const int k = base + p;
    if (k < count) {
      const float* e = packed + start + k;
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
    const int nb = min(BATCH, count - base);
    for (int j = 0; j < nb && !done; ++j) {
      const float dx = s_x[j] - px;
      const float dy = s_y[j] - py;
      const float power =
          -0.5f * (s_a[j] * dx * dx + s_c[j] * dy * dy) - s_b[j] * dx * dy;
      if (power > 0.0f) continue;
      const float alpha = fminf(ALPHA_MAX, s_o[j] * expf(power));
      if (alpha < ALPHA_MIN) continue;
      const float test_t = T * (1.0f - alpha);
      if (test_t < T_MIN) {
        done = true;
        break;
      }
      const float w = alpha * T;
      acc_r += s_r[j] * w;
      acc_g += s_g[j] * w;
      acc_b += s_bl[j] * w;
      acc_d += s_d[j] * w;
      T = test_t;
      last = base + j + 1;
    }
  }

  float* o = out + (int64_t)row * 8 * PX + p;
  o[0 * PX] = acc_r;
  o[1 * PX] = acc_g;
  o[2 * PX] = acc_b;
  o[3 * PX] = acc_d;
  o[4 * PX] = T;
  o[5 * PX] = (float)last;
  o[6 * PX] = 0.0f;
  o[7 * PX] = 0.0f;
}

}  // namespace

// Launches K1 over ``num_rows`` output rows on ``stream`` (``tile_ids``
// null: row r is tile r); returns cudaGetLastError() (0 = launched).
extern "C" int tile_blend_fwd(const void* packed, int64_t e_pad,
                              const void* tile_start, const void* tile_count,
                              const void* tile_ids, int tiles_x, int num_rows,
                              void* out, void* stream) {
  if (num_rows > 0) {
    tile_blend_fwd_kernel<<<num_rows, PX, 0, (cudaStream_t)stream>>>(
        (const float*)packed, e_pad, (const int32_t*)tile_start,
        (const int32_t*)tile_count, (const int32_t*)tile_ids, tiles_x,
        (float*)out);
  }
  return (int)cudaGetLastError();
}
