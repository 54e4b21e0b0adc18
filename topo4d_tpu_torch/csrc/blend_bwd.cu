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
// Transmittance is rebuilt by DIVISION, T /= (1 - alpha), as a multiply by
// the correctly rounded reciprocal, which also serves dL/dalpha. That is
// safe here: alpha <= 0.99 so 1 - alpha >= 0.01, and K1 never lets T fall
// below 1e-4, so the rebuilt T stays in [1e-4, 1] and each step adds two
// roundings. (The
// TPU kernel rebuilt T in log space because it summed log1p(-alpha) over
// whole 128-entry windows, past the termination point, where a product
// underflows and a division gives 0/0; a sequential per-pixel loop that
// starts at the saved last contributor never visits those entries.)
//
// Bound on an H100 SXM. Bytes: the ten field rows of the entries a tile
// visits (up to its pixels' furthest last contributor), read once and
// written once, rows 4-5 of the forward output and rows 0-4 of its
// cotangent. Arithmetic: 55 FP32 operations per contributing (pixel, entry)
// pair and 16 per other visited pair. At the 4K dense view (10,567 occupied
// tiles, 2.24M entries) the operations bound it, 0.118 ms at 67 TFLOP/s; at
// the head-scale geometry view (~21k entries) the bytes, ~2 us. What bounds
// this kernel is instruction issue and latency: each warp walks its entries
// in order, and 40% of the (entry, warp) steps at the 4K view have no
// contributing lane. Measured (chip_smoke.py, NVIDIA H100 80GB HBM3,
// 700.00 W): 1.363 ms at the 4K compact view, 8.7% of its bound; 0.050 ms
// at the geometry view.
//
// Design. One block of 256 / PPT threads per tile; each thread owns PPT
// vertically adjacent pixels of one column (PPT = 2: 128 threads, four
// warps, each on an 8 x 8 block of the tile, which shares contributors
// among its lanes more often than a 16 x 4 strip). The block walks its range
// back to front in batches of 96 entries staged in shared memory, starting
// from the largest saved last-contributor count of its pixels; a warp skips
// the groups above its own pixels' furthest last contributor. The entries go
// in groups of three. Per entry, the thread first evaluates the Gaussian at
// its pixels and skips the entry if no lane of the warp can contribute (a
// warp-uniform branch); otherwise it runs all its pixels' recurrences as
// one straight-line block, a pixel that does not contribute masked to alpha
// 0 (which leaves T, S and the sums unchanged), so the pixels' exp and
// reciprocal chains overlap. The pixels' partial gradients are added in
// registers, in pixel order, into the group's 30 slots (32 with two zero
// pads); the five conic-side slots hold dpow dx, dpow dy and their
// products, from which the x, y and conic gradients are formed per entry at
// the batch end. One butterfly reduce-scatter over __shfl_xor_sync (offsets
// 16, 8, 4, 2, 1: 31 shuffles, the slots chosen by compile-time unrolled
// selects, so nothing leaves the registers) leaves each lane with the
// warp's sum of one slot, stored with one shared store: ~41 shuffles per
// entry per tile, none when no lane of the group contributes. At the end of each batch the four warp slots of each value
// are added in a fixed order and each entry's column is written once. Every
// entry belongs to exactly one tile, so no reduction leaves the block: no
// global atomics, the same bits on every launch, and compact rows give the
// full canvas's dpacked bit for bit. PPT = 4 (64 threads) was timed too
// (the same source with PPT set to 4, through chip_smoke.py's K2 timing):
// no faster at the 4K view and slower at the geometry view, so PPT is 2.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false, so the
// skip decisions recomputed here equal K1's bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 16;
constexpr int PX = TILE * TILE;
constexpr int PPT = 2;                // pixels per thread, vertically adjacent
constexpr int NT = PX / PPT;          // threads per block, one block per tile
constexpr int WARPS = NT / 32;
constexpr int NG = 10;                // gradient fields per entry
constexpr int GROUP = 3;              // entries per reduce-scatter
constexpr int USED = GROUP * NG;      // 30 of a warp's 32 slots
constexpr int BATCH = 96;             // entries staged per batch
constexpr int GROUPS = BATCH / GROUP;
constexpr int WARP_W = 8;             // a warp's pixel block is 8 wide
constexpr int MIN_BLOCKS = 6;         // resident blocks per SM the registers must allow
constexpr unsigned FULL = 0xffffffffu;
constexpr float ALPHA_MAX = 0.99f;
constexpr float ALPHA_MIN = 1.0f / 255.0f;
static_assert(BATCH % GROUP == 0, "a batch holds whole groups");

// gradient field f -> packed row
__device__ __forceinline__ int grad_row(int f) { return f < 6 ? f : f + 2; }

// One butterfly step: lanes with bit O set keep the upper half of their O * 2
// live slots and send the lower half to their partner, the others the
// reverse. After the steps for O = 16, 8, 4, 2, 1, v[0] of lane l is the
// warp's sum of slot l.
template <int O>
__device__ __forceinline__ void reduce_scatter_step(float (&v)[32], int lane) {
  const bool up = (lane & O) != 0;
#pragma unroll
  for (int i = 0; i < O; ++i) {
    const float send = up ? v[i] : v[i + O];
    const float keep = up ? v[i + O] : v[i];
    v[i] = keep + __shfl_xor_sync(FULL, send, O);
  }
}

__global__ void __launch_bounds__(NT, MIN_BLOCKS) tile_blend_bwd_kernel(
    const float* __restrict__ packed, int64_t e_pad,
    const int32_t* __restrict__ tile_start,
    const int32_t* __restrict__ tile_count,
    const int32_t* __restrict__ tile_ids, int tiles_x,
    const float* __restrict__ fwd, const float* __restrict__ g_out,
    float* __restrict__ dpacked) {
  const int row = blockIdx.x;
  const int tile = tile_ids ? tile_ids[row] : row;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  // warp w covers an 8-column block of the tile, 32 / 8 * PPT rows tall
  const int col = (warp % (TILE / WARP_W)) * WARP_W + lane % WARP_W;
  const int prow = ((warp / (TILE / WARP_W)) * (32 / WARP_W) + lane / WARP_W) * PPT;  // first pixel row
  const float px = (float)((tile % tiles_x) * TILE + col);
  const int64_t start = tile_start[row];
  const int count = tile_count[row];

  float py[PPT], T[PPT], S[PPT], tail[PPT];
  float g_r[PPT], g_g[PPT], g_b[PPT], g_d[PPT];
  int last[PPT];
  int my_last = 0;
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int p = (prow + k) * TILE + col;
    const float* fo = fwd + (int64_t)row * 8 * PX + p;
    const float* go = g_out + (int64_t)row * 8 * PX + p;
    py[k] = (float)((tile / tiles_x) * TILE + prow + k);
    T[k] = fo[4 * PX];  // transmittance after the current entry
    S[k] = 0.0f;        // sum over later contributors of w_j s_j
    last[k] = min((int)fo[5 * PX], count);
    g_r[k] = go[0 * PX];
    g_g[k] = go[1 * PX];
    g_b[k] = go[2 * PX];
    g_d[k] = go[3 * PX];
    tail[k] = go[4 * PX] * T[k];
    my_last = max(my_last, last[k]);
  }

  __shared__ float s_x[BATCH], s_y[BATCH], s_a[BATCH], s_b[BATCH];
  __shared__ float s_c[BATCH], s_o[BATCH];
  __shared__ float s_r[BATCH], s_g[BATCH], s_bl[BATCH], s_d[BATCH];
  __shared__ float s_acc[WARPS][GROUPS][USED];
  __shared__ int s_max_last;

  if (t == 0) s_max_last = 0;
  __syncthreads();
  const int warp_last = __reduce_max_sync(FULL, my_last);
  if (lane == 0) atomicMax(&s_max_last, warp_last);
  __syncthreads();
  const int max_last = s_max_last;

  for (int base = ((max_last + BATCH - 1) / BATCH - 1) * BATCH; base >= 0;
       base -= BATCH) {
    const int nb = min(BATCH, max_last - base);
    __syncthreads();  // the previous batch's shared data is consumed
    // zero the last group's padding entries: the warp test reads them
    for (int i = nb + t; i < min(BATCH, nb + GROUP - 1); i += NT) {
      s_x[i] = s_y[i] = s_a[i] = s_b[i] = s_c[i] = s_o[i] = 0.0f;
      s_r[i] = s_g[i] = s_bl[i] = s_d[i] = 0.0f;
    }
    for (int i = t; i < nb; i += NT) {
      const float* e = packed + start + base + i;
      s_x[i] = e[0 * e_pad];
      s_y[i] = e[1 * e_pad];
      s_a[i] = e[2 * e_pad];
      s_b[i] = e[3 * e_pad];
      s_c[i] = e[4 * e_pad];
      s_o[i] = e[5 * e_pad];
      s_r[i] = e[8 * e_pad];
      s_g[i] = e[9 * e_pad];
      s_bl[i] = e[10 * e_pad];
      s_d[i] = e[11 * e_pad];
    }
    __syncthreads();
    for (int q = (nb + GROUP - 1) / GROUP - 1; q >= 0; --q) {
      float slot = 0.0f;
      if (base + GROUP * q < warp_last) {  // warp-uniform
        float v[32];
        bool any = false;
#pragma unroll
        for (int u = GROUP - 1; u >= 0; --u) {  // back to front
          const int j = GROUP * q + u;
          float* gr = v + u * NG;
#pragma unroll
          for (int f = 0; f < NG; ++f) gr[f] = 0.0f;
          const float ex = s_x[j], ey = s_y[j];
          const float ea = s_a[j], eb = s_b[j], ec = s_c[j];
          const float op = s_o[j];
          const bool small_op = op <= 1.0f;
          const float dx = ex - px;
          float power[PPT];
          bool ok[PPT];
          bool any_ok = false;
#pragma unroll
          for (int k = 0; k < PPT; ++k) {
            const float dy = ey - py[k];
            power[k] = -0.5f * (ea * dx * dx + ec * dy * dy) - eb * dx * dy;
            // exp(-5.6) < 1/255: with an opacity of at most 1 such an entry
            // cannot reach alpha 1/255, so K1 skipped it too
            ok[k] = base + j < last[k] && !(power[k] > 0.0f) && !(power[k] < -5.6f && small_op);
            any_ok |= ok[k];
          }
          if (!__any_sync(FULL, any_ok)) continue;  // warp-uniform
          const float er = s_r[j], eg = s_g[j], ebl = s_bl[j], ed = s_d[j];
#pragma unroll
          for (int k = 0; k < PPT; ++k) {
            const float dy = ey - py[k];
            const float G = expf(ok[k] ? power[k] : 0.0f);
            const float opg = op * G;
            const float alpha = fminf(ALPHA_MAX, opg);
            const bool c = ok[k] && alpha >= ALPHA_MIN;
            any |= c;
            const float a = c ? alpha : 0.0f;  // a masked pixel changes nothing below
            const float rcp = 1.0f / (1.0f - a);
            const float t_i = T[k] * rcp;
            const float w = a * t_i;
            const float s = g_r[k] * er + g_g[k] * eg + g_b[k] * ebl + g_d[k] * ed;
            const float dalpha = c ? t_i * s - (S[k] + tail[k]) * rcp : 0.0f;
            S[k] += w * s;
            T[k] = t_i;
            const float dpow = dalpha * opg;
            const float dpx = dpow * dx, dpy = dpow * dy;
            gr[0] += dpx;  // the conic-side sums: the gradients of x, y and
            gr[1] += dpy;  // the conic are formed from them at the batch end
            gr[2] += dpx * dx;
            gr[3] += dpx * dy;
            gr[4] += dpy * dy;
            gr[5] += dalpha * G;  // opacity
            gr[6] += g_r[k] * w;
            gr[7] += g_g[k] * w;
            gr[8] += g_b[k] * w;
            gr[9] += g_d[k] * w;
          }
        }
        if (__any_sync(FULL, any)) {
          v[USED] = 0.0f;
          v[USED + 1] = 0.0f;
          reduce_scatter_step<16>(v, lane);
          reduce_scatter_step<8>(v, lane);
          reduce_scatter_step<4>(v, lane);
          reduce_scatter_step<2>(v, lane);
          reduce_scatter_step<1>(v, lane);
          slot = v[0];
        }
      }
      if (lane < USED) s_acc[warp][q][lane] = slot;
    }
    __syncthreads();
    for (int idx = t; idx < NG * nb; idx += NT) {
      const int f = idx / nb;
      const int j = idx - f * nb;
      const int q = j / GROUP;
      const float* sums[WARPS];
#pragma unroll
      for (int w = 0; w < WARPS; ++w) sums[w] = &s_acc[w][q][(j - q * GROUP) * NG];
      // the block's sum of slot i of entry j, the warps added in order
      auto block_sum = [&](int i) {
        float sum = sums[0][i];
#pragma unroll
        for (int w = 1; w < WARPS; ++w) sum += sums[w][i];
        return sum;
      };
      float grad;
      if (f == 0) {         // x: -sum dpow (a dx + b dy)
        grad = -(s_a[j] * block_sum(0) + s_b[j] * block_sum(1));
      } else if (f == 1) {  // y: -sum dpow (c dy + b dx)
        grad = -(s_c[j] * block_sum(1) + s_b[j] * block_sum(0));
      } else if (f == 2 || f == 4) {  // conic a, c: -sum dpow dx^2 / 2, -sum dpow dy^2 / 2
        grad = -0.5f * block_sum(f);
      } else if (f == 3) {  // conic b: -sum dpow dx dy
        grad = -block_sum(3);
      } else {              // opacity, r, g, b, depth
        grad = block_sum(f);
      }
      dpacked[grad_row(f) * e_pad + start + base + j] = grad;
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
    tile_blend_bwd_kernel<<<num_rows, NT, 0, (cudaStream_t)stream>>>(
        (const float*)packed, e_pad, (const int32_t*)tile_start,
        (const int32_t*)tile_count, (const int32_t*)tile_ids, tiles_x,
        (const float*)fwd, (const float*)g_out, (float*)dpacked);
  }
  return (int)cudaGetLastError();
}
