// Window-span tile-blend backward (K4b) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel topo4d_tpu/rasterizer/pallas_blend.py
// _bwd_kernel_v3 (:683), which _blend_bwd_impl picks for variant "v3"
// (:1345).
//
// Contract: exactly K2's (csrc/blend_bwd.cu). Given the forward's inputs,
// its output ``fwd`` (R, 8, 256) (K1's or K4f's: row 4 T_final, row 5 the
// count of entries up to each pixel's last contributor) and the cotangent
// ``g`` of rows 0-4, write dL/d{x, y, conic a, b, c, opacity, r, g, b, depth}
// of every entry in a row's processed range into rows 0-5 and 8-11 of
// ``dpacked`` (16, E_pad), which the caller zero-fills. The 0.99 alpha clamp
// passes the gradient straight through. Per pixel, back to front over the
// entries K1 blended, with transmittance rebuilt by division
// (T_i = T_{i+1} / (1 - alpha_i), safe because 1 - alpha >= 0.01 and T
// never fell below 1e-4), exactly as K2 does.
//
// The TPU kernel's idea, kept: one block owns ``tps`` consecutive output
// rows and walks the UNION of their processed spans (each row's
// [start, start + its pixels' largest row-5 count)) once, in reverse,
// staging each batch of entries for all of its rows. Left behind: the
// log-space transmittance, the per-window residuals, the double-buffered
// DMA and the window-accumulator flush.
//
// Design. One block of 256 threads per group of TPS rows (template, 1-8);
// thread p owns pixel p of each of the TPS tiles and carries each tile's
// transmittance T and back-to-front sum S in registers; the per-pixel
// cotangent and T_final are read back from device memory each time a tile
// is visited in a batch. The block walks the union span back to front in
// batches of 128 entries staged in shared memory; for each tile, in the
// batch's intersection with that tile's processed range (block-uniform
// bounds, so every lane of a warp takes the same loop), each thread
// computes its ten partial gradients, each warp sums them with shuffles, and
// lane 0 stores the warp's sums in a per-warp slot of the entry. At the end
// of the batch the eight warp slots of every entry inside some tile's
// processed range are added in a fixed order and written once. Every entry
// belongs to one tile, so its gradient is reduced among that tile's own
// warps: no global atomics, deterministic, and per entry the same sum in the
// same order as K2's (so equal to K2 bit for bit).
//
// Bound on an H100 SXM: the same work as K2 at the same shape (the entries
// up to each tile's furthest last contributor read and written once, rows
// 4-5 of the forward output and rows 0-4 of its cotangent read once), so
// K2's bound.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false, so the
// skip decisions recomputed here equal the forward's bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 16;
constexpr int PX = TILE * TILE;
constexpr int BATCH = 128;
constexpr int WARPS = PX / 32;
constexpr int NG = 10;  // gradient fields per entry
constexpr int MAX_TPS = 8;
constexpr float ALPHA_MAX = 0.99f;
constexpr float ALPHA_MIN = 1.0f / 255.0f;

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }
__device__ __forceinline__ int64_t max64(int64_t a, int64_t b) { return a > b ? a : b; }

// gradient field f -> packed row
__device__ __forceinline__ int grad_row(int f) { return f < 6 ? f : f + 2; }

template <int TPS>
__global__ void __launch_bounds__(PX) tile_blend_v3_bwd_kernel(
    const float* __restrict__ packed, int64_t e_pad,
    const int32_t* __restrict__ tile_start,
    const int32_t* __restrict__ tile_count,
    const int32_t* __restrict__ tile_ids, int tiles_x, int num_rows,
    const float* __restrict__ fwd, const float* __restrict__ g_out,
    float* __restrict__ dpacked) {
  const int row0 = blockIdx.x * TPS;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;

  __shared__ float s_x[BATCH], s_y[BATCH], s_a[BATCH], s_b[BATCH];
  __shared__ float s_c[BATCH], s_o[BATCH];
  __shared__ float s_r[BATCH], s_g[BATCH], s_bl[BATCH], s_d[BATCH];
  __shared__ float s_acc[WARPS][NG][BATCH];
  __shared__ int64_t s_start[TPS];
  __shared__ int s_count[TPS], s_tile[TPS], s_max_last[TPS];
  __shared__ int64_t s_lo, s_hi;

  if (p < TPS) {
    const int r = row0 + p;
    const bool in = r < num_rows;
    s_start[p] = in ? (int64_t)tile_start[r] : 0;
    s_count[p] = in ? tile_count[r] : 0;
    s_tile[p] = in ? (tile_ids ? tile_ids[r] : r) : 0;
    s_max_last[p] = 0;
  }
  __syncthreads();

  // each tile's processed range: up to its pixels' furthest last contributor
  float T[TPS], S[TPS];
#pragma unroll
  for (int j = 0; j < TPS; ++j) {
    const int r = row0 + j;
    int last = 0;
    T[j] = 1.0f;
    if (r < num_rows) {
      const float* fo = fwd + (int64_t)r * 8 * PX + p;
      T[j] = fo[4 * PX];  // transmittance after the current entry
      last = min((int)fo[5 * PX], s_count[j]);
    }
    S[j] = 0.0f;  // sum over later contributors of w_k s_k
    const int warp_max = __reduce_max_sync(0xffffffffu, last);
    if (lane == 0) atomicMax(&s_max_last[j], warp_max);
  }
  __syncthreads();
  if (p == 0) {
    int64_t lo = 0, hi = 0;
    bool any = false;
    for (int j = 0; j < TPS; ++j) {
      if (s_max_last[j] > 0) {
        lo = any ? min64(lo, s_start[j]) : s_start[j];
        hi = max64(hi, s_start[j] + s_max_last[j]);
        any = true;
      }
    }
    s_lo = lo;
    s_hi = hi;
  }
  __syncthreads();
  const int64_t lo = s_lo, hi = s_hi;

  const int64_t nbatch = (hi - lo + BATCH - 1) / BATCH;
  for (int64_t bi = nbatch - 1; bi >= 0; --bi) {
    const int64_t base = lo + bi * BATCH;
    const int nb = (int)min64(BATCH, hi - base);
    __syncthreads();  // the previous batch's shared data is consumed
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
      const int64_t t0 = s_start[j];
      // this tile's processed entries in the batch: [k0, k1), block-uniform
      const int k0 = (int)(max64(t0, base) - base);
      const int k1 = (int)(min64(t0 + s_max_last[j], base + nb) - base);
      if (k0 >= k1) continue;
      const int r = row0 + j;
      const int tile = s_tile[j];
      const float px = (float)((tile % tiles_x) * TILE + (p % TILE));
      const float py = (float)((tile / tiles_x) * TILE + (p / TILE));
      const float* fo = fwd + (int64_t)r * 8 * PX + p;
      const float* go = g_out + (int64_t)r * 8 * PX + p;
      const int last = min((int)fo[5 * PX], s_count[j]);
      const float g_r = go[0 * PX], g_g = go[1 * PX], g_b = go[2 * PX];
      const float g_d = go[3 * PX];
      const float tail = go[4 * PX] * fo[4 * PX];
      for (int k = k1 - 1; k >= k0; --k) {
        float gr[NG];
#pragma unroll
        for (int f = 0; f < NG; ++f) gr[f] = 0.0f;
        bool contrib = false;
        if (base + k - t0 < last) {
          const float dx = s_x[k] - px;
          const float dy = s_y[k] - py;
          const float power =
              -0.5f * (s_a[k] * dx * dx + s_c[k] * dy * dy) - s_b[k] * dx * dy;
          if (power <= 0.0f) {
            const float G = expf(power);
            const float op = s_o[k];
            const float alpha = fminf(ALPHA_MAX, op * G);
            if (alpha >= ALPHA_MIN) {
              contrib = true;
              const float one_m = 1.0f - alpha;
              const float t_i = T[j] / one_m;
              const float w = alpha * t_i;
              const float s =
                  g_r * s_r[k] + g_g * s_g[k] + g_b * s_bl[k] + g_d * s_d[k];
              const float dalpha = t_i * s - (S[j] + tail) / one_m;
              S[j] += w * s;
              T[j] = t_i;
              const float dpow = dalpha * op * G;
              gr[0] = -dpow * (s_a[k] * dx + s_b[k] * dy);  // x
              gr[1] = -dpow * (s_c[k] * dy + s_b[k] * dx);  // y
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
          for (int f = 0; f < NG; ++f) s_acc[warp][f][k] = gr[f];
        }
      }
    }
    __syncthreads();
    for (int idx = p; idx < NG * nb; idx += PX) {
      const int f = idx / nb;
      const int k = idx - f * nb;
      const int64_t g = base + k;
      // only entries inside some tile's processed range were reduced
      bool mine = false;
#pragma unroll
      for (int j = 0; j < TPS; ++j)
        mine = mine || (g >= s_start[j] && g < s_start[j] + s_max_last[j]);
      if (!mine) continue;
      float sum = 0.0f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) sum += s_acc[w][f][k];
      dpacked[grad_row(f) * e_pad + g] = sum;
    }
  }
}

template <int TPS>
void launch(const float* packed, int64_t e_pad, const int32_t* start,
            const int32_t* count, const int32_t* ids, int tiles_x,
            int num_rows, const float* fwd, const float* g_out,
            float* dpacked, cudaStream_t stream) {
  const int blocks = (num_rows + TPS - 1) / TPS;
  tile_blend_v3_bwd_kernel<TPS><<<blocks, PX, 0, stream>>>(
      packed, e_pad, start, count, ids, tiles_x, num_rows, fwd, g_out,
      dpacked);
}

}  // namespace

// Launches K4b over ``num_rows`` rows in blocks of ``tps`` rows on
// ``stream`` (``tile_ids`` null: row r is tile r); returns
// cudaGetLastError() (0 = launched), or cudaErrorInvalidValue for a ``tps``
// outside 1-8.
extern "C" int tile_blend_v3_bwd(const void* packed, int64_t e_pad,
                                 const void* tile_start, const void* tile_count,
                                 const void* tile_ids, int tiles_x,
                                 int num_rows, int tps, const void* fwd,
                                 const void* g_out, void* dpacked,
                                 void* stream) {
  if (tps < 1 || tps > MAX_TPS) return (int)cudaErrorInvalidValue;
  if (num_rows > 0) {
    const float* pk = (const float*)packed;
    const int32_t* st = (const int32_t*)tile_start;
    const int32_t* ct = (const int32_t*)tile_count;
    const int32_t* id = (const int32_t*)tile_ids;
    const float* fo = (const float*)fwd;
    const float* go = (const float*)g_out;
    float* dp = (float*)dpacked;
    cudaStream_t s = (cudaStream_t)stream;
    switch (tps) {
      case 1: launch<1>(pk, e_pad, st, ct, id, tiles_x, num_rows, fo, go, dp, s); break;
      case 2: launch<2>(pk, e_pad, st, ct, id, tiles_x, num_rows, fo, go, dp, s); break;
      case 3: launch<3>(pk, e_pad, st, ct, id, tiles_x, num_rows, fo, go, dp, s); break;
      case 4: launch<4>(pk, e_pad, st, ct, id, tiles_x, num_rows, fo, go, dp, s); break;
      case 5: launch<5>(pk, e_pad, st, ct, id, tiles_x, num_rows, fo, go, dp, s); break;
      case 6: launch<6>(pk, e_pad, st, ct, id, tiles_x, num_rows, fo, go, dp, s); break;
      case 7: launch<7>(pk, e_pad, st, ct, id, tiles_x, num_rows, fo, go, dp, s); break;
      default: launch<8>(pk, e_pad, st, ct, id, tiles_x, num_rows, fo, go, dp, s); break;
    }
  }
  return (int)cudaGetLastError();
}
