// Window-span tile-blend forward (K4f) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel topo4d_tpu/rasterizer/pallas_blend.py
// _fwd_kernel_v3 (:543), which _blend_fwd_impl picks for variant "v3"
// (:918).
//
// Contract: exactly K1's (csrc/blend_fwd.cu). Entries are packed (16, E_pad)
// float32, sorted by (tile, depth); output row r blends the range
// [tile_start[r], tile_start[r] + tile_count[r]) front to back for each
// pixel of tile tile_ids[r] (row r itself without a tile map):
//   power = -0.5 (a dx^2 + c dy^2) - b dx dy; skip if power > 0;
//   alpha = min(0.99, opacity * exp(power)); skip if alpha < 1/255; stop
//   BEFORE the entry whose T * (1 - alpha) would fall below 1e-4.
// Output (R, 8, 256): rows 0-2 rgb, 3 depth, 4 T_final, 5 the count of
// entries up to and including the last contributor, 6-7 zero. Padding rows
// (count 0) come out as T_final 1, all else 0.
//
// The TPU kernel's idea, kept: one block owns ``tps`` consecutive output
// rows and stages the UNION of their entry ranges through fast memory once
// for all of them, so the serial chain of batch visits is one walk of the
// union instead of one walk per row; and the block terminates collectively.
// Consecutive rows have contiguous ranges in the (tile, depth) sort (compact
// rows list ascending tile ids), so the union is one contiguous span.
// Padding rows (count 0) are left out of it (:589-596).
//
// The TPU devices left behind: the double-buffered window DMA, the SMEM
// window cache, the log-space transmittance carry, the (8, PX) transposed
// residual layout and the per-window residual rows (:663-677). Rows 5-7 keep
// K1's layout, so K2's and K4b's reverse sweeps start from the same row 5.
//
// Design. One block of 256 threads per group of TPS rows (a template
// parameter, 1-8): thread p owns pixel p of each of the TPS tiles and keeps
// their blend state (T, four sums, last contributor, done) in registers.
// (256 * TPS threads, one per pixel, would not fit a block at TPS 8.) The
// block stages the union span in batches of 256 entries, one entry per
// thread, coalesced, into shared memory. For each of its tiles a thread
// walks only the intersection of the batch with that tile's own range, in
// K1's order with K1's arithmetic: the TPU kernel masks foreign entries to
// alpha 0, but on a GPU a masked entry still costs its loop iteration. The
// block leaves the batch loop when __syncthreads_count says every pixel of
// every tile has either stopped or passed the end of its range; a pixel
// that has stopped stays stopped, so collective termination decides only
// when loading ends, never a pixel's result.
//
// Bound on an H100 SXM: the same work as K1 (the same entries read, the
// same output written, the same pairs evaluated), so K1's bound at the same
// shape. A block does TPS tiles' serial work with 256 threads, so at equal
// occupancy it has TPS times less parallelism than K1; the span walk saves
// barriers and batch loads only where tiles hold few entries.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false. With
// --fmad=false every product and sum is rounded on its own, so each pixel's
// rows 0-5 equal K1's bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 16;
constexpr int PX = TILE * TILE;
constexpr int BATCH = PX;
constexpr int MAX_TPS = 8;
constexpr float ALPHA_MAX = 0.99f;
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float T_MIN = 1e-4f;

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }
__device__ __forceinline__ int64_t max64(int64_t a, int64_t b) { return a > b ? a : b; }

template <int TPS>
__global__ void __launch_bounds__(PX) tile_blend_v3_fwd_kernel(
    const float* __restrict__ packed, int64_t e_pad,
    const int32_t* __restrict__ tile_start,
    const int32_t* __restrict__ tile_count,
    const int32_t* __restrict__ tile_ids, int tiles_x, int num_rows,
    float* __restrict__ out) {
  const int row0 = blockIdx.x * TPS;
  const int p = threadIdx.x;

  __shared__ float s_x[BATCH], s_y[BATCH], s_a[BATCH], s_b[BATCH];
  __shared__ float s_c[BATCH], s_o[BATCH];
  __shared__ float s_r[BATCH], s_g[BATCH], s_bl[BATCH], s_d[BATCH];
  __shared__ int64_t s_start[TPS];
  __shared__ int s_count[TPS], s_tile[TPS];
  __shared__ int64_t s_lo, s_hi;

  if (p < TPS) {
    const int r = row0 + p;
    const bool in = r < num_rows;
    s_start[p] = in ? (int64_t)tile_start[r] : 0;
    s_count[p] = in ? tile_count[r] : 0;
    s_tile[p] = in ? (tile_ids ? tile_ids[r] : r) : 0;
  }
  __syncthreads();
  if (p == 0) {
    // the union span of the non-empty rows' ranges
    int64_t lo = 0, hi = 0;
    bool any = false;
    for (int j = 0; j < TPS; ++j) {
      if (s_count[j] > 0) {
        lo = any ? min64(lo, s_start[j]) : s_start[j];
        hi = max64(hi, s_start[j] + s_count[j]);
        any = true;
      }
    }
    s_lo = lo;
    s_hi = hi;
  }
  __syncthreads();
  const int64_t lo = s_lo, hi = s_hi;

  float T[TPS], acc_r[TPS], acc_g[TPS], acc_b[TPS], acc_d[TPS];
  int last[TPS];
  bool done[TPS];
#pragma unroll
  for (int j = 0; j < TPS; ++j) {
    T[j] = 1.0f;
    acc_r[j] = acc_g[j] = acc_b[j] = acc_d[j] = 0.0f;
    last[j] = 0;
    done[j] = false;
  }

  for (int64_t base = lo; base < hi; base += BATCH) {
    // finished: every tile of this pixel has stopped or has no entry at or
    // past ``base``. The barrier also protects the previous batch.
    bool finished = true;
#pragma unroll
    for (int j = 0; j < TPS; ++j)
      finished = finished && (done[j] || s_start[j] + s_count[j] <= base);
    if (__syncthreads_count(finished) == PX) break;
    const int nb = (int)min64(BATCH, hi - base);
    if (p < nb) {
      const float* e = packed + base + p;
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
#pragma unroll
    for (int j = 0; j < TPS; ++j) {
      if (done[j]) continue;
      const int64_t t0 = s_start[j];
      // this tile's entries in the batch: [k0, k1) in batch positions
      const int k0 = (int)(max64(t0, base) - base);
      const int k1 = (int)(min64(t0 + s_count[j], base + nb) - base);
      const int tile = s_tile[j];
      const float px = (float)((tile % tiles_x) * TILE + (p % TILE));
      const float py = (float)((tile / tiles_x) * TILE + (p / TILE));
      for (int k = k0; k < k1; ++k) {
        const float dx = s_x[k] - px;
        const float dy = s_y[k] - py;
        const float power =
            -0.5f * (s_a[k] * dx * dx + s_c[k] * dy * dy) - s_b[k] * dx * dy;
        if (power > 0.0f) continue;
        const float alpha = fminf(ALPHA_MAX, s_o[k] * expf(power));
        if (alpha < ALPHA_MIN) continue;
        const float test_t = T[j] * (1.0f - alpha);
        if (test_t < T_MIN) {
          done[j] = true;
          break;
        }
        const float w = alpha * T[j];
        acc_r[j] += s_r[k] * w;
        acc_g[j] += s_g[k] * w;
        acc_b[j] += s_bl[k] * w;
        acc_d[j] += s_d[k] * w;
        T[j] = test_t;
        last[j] = (int)(base + k - t0) + 1;
      }
    }
  }

#pragma unroll
  for (int j = 0; j < TPS; ++j) {
    const int r = row0 + j;
    if (r >= num_rows) break;
    float* o = out + (int64_t)r * 8 * PX + p;
    o[0 * PX] = acc_r[j];
    o[1 * PX] = acc_g[j];
    o[2 * PX] = acc_b[j];
    o[3 * PX] = acc_d[j];
    o[4 * PX] = T[j];
    o[5 * PX] = (float)last[j];
    o[6 * PX] = 0.0f;
    o[7 * PX] = 0.0f;
  }
}

template <int TPS>
void launch(const float* packed, int64_t e_pad, const int32_t* start,
            const int32_t* count, const int32_t* ids, int tiles_x,
            int num_rows, float* out, cudaStream_t stream) {
  const int blocks = (num_rows + TPS - 1) / TPS;
  tile_blend_v3_fwd_kernel<TPS><<<blocks, PX, 0, stream>>>(
      packed, e_pad, start, count, ids, tiles_x, num_rows, out);
}

}  // namespace

// Launches K4f over ``num_rows`` output rows in blocks of ``tps`` rows on
// ``stream`` (``tile_ids`` null: row r is tile r); returns
// cudaGetLastError() (0 = launched), or cudaErrorInvalidValue for a ``tps``
// outside 1-8.
extern "C" int tile_blend_v3_fwd(const void* packed, int64_t e_pad,
                                 const void* tile_start, const void* tile_count,
                                 const void* tile_ids, int tiles_x,
                                 int num_rows, int tps, void* out,
                                 void* stream) {
  if (tps < 1 || tps > MAX_TPS) return (int)cudaErrorInvalidValue;
  if (num_rows > 0) {
    const float* pk = (const float*)packed;
    const int32_t* st = (const int32_t*)tile_start;
    const int32_t* ct = (const int32_t*)tile_count;
    const int32_t* id = (const int32_t*)tile_ids;
    float* o = (float*)out;
    cudaStream_t s = (cudaStream_t)stream;
    switch (tps) {
      case 1: launch<1>(pk, e_pad, st, ct, id, tiles_x, num_rows, o, s); break;
      case 2: launch<2>(pk, e_pad, st, ct, id, tiles_x, num_rows, o, s); break;
      case 3: launch<3>(pk, e_pad, st, ct, id, tiles_x, num_rows, o, s); break;
      case 4: launch<4>(pk, e_pad, st, ct, id, tiles_x, num_rows, o, s); break;
      case 5: launch<5>(pk, e_pad, st, ct, id, tiles_x, num_rows, o, s); break;
      case 6: launch<6>(pk, e_pad, st, ct, id, tiles_x, num_rows, o, s); break;
      case 7: launch<7>(pk, e_pad, st, ct, id, tiles_x, num_rows, o, s); break;
      default: launch<8>(pk, e_pad, st, ct, id, tiles_x, num_rows, o, s); break;
    }
  }
  return (int)cudaGetLastError();
}
