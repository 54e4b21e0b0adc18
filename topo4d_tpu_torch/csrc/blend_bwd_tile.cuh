// The per-tile body of the tile-blend backward, shared by K2
// (csrc/blend_bwd.cu, one tile per block) and K4b (csrc/blend_v3_bwd.cu,
// ``tps`` tiles per block, one after another). The contract, the math and
// the design are K2's source note. One body means one order of every sum:
// the pixels of a thread, the butterfly over the warp, the four warps in
// order. So K4b's dpacked equals K2's bit for bit.
//
// kernels.py names a built library by a hash of its .cu source together with
// every csrc/ header it includes, so an edit here rebuilds both kernels.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace blend_bwd {

constexpr int TILE = 16;
constexpr int PX = TILE * TILE;
constexpr int PPT = 2;                // pixels per thread, vertically adjacent
constexpr int NT = PX / PPT;          // threads per block
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

// The block's shared memory: one batch of entries and its per-warp sums.
struct Smem {
  float x[BATCH], y[BATCH], a[BATCH], b[BATCH], c[BATCH], o[BATCH];
  float r[BATCH], g[BATCH], bl[BATCH], d[BATCH];
  float acc[WARPS][GROUPS][USED];
  int max_last;
};

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

// The gradient of every entry of output row ``row``'s range into dpacked,
// by a block of NT threads. The caller separates two calls on one ``sm``
// with a barrier.
__device__ __forceinline__ void bwd_tile(
    const float* __restrict__ packed, int64_t e_pad,
    const int32_t* __restrict__ tile_start,
    const int32_t* __restrict__ tile_count,
    const int32_t* __restrict__ tile_ids, int tiles_x, int row,
    const float* __restrict__ fwd, const float* __restrict__ g_out,
    float* __restrict__ dpacked, Smem& sm) {
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

  if (t == 0) sm.max_last = 0;
  __syncthreads();
  const int warp_last = __reduce_max_sync(FULL, my_last);
  if (lane == 0) atomicMax(&sm.max_last, warp_last);
  __syncthreads();
  const int max_last = sm.max_last;

  for (int base = ((max_last + BATCH - 1) / BATCH - 1) * BATCH; base >= 0;
       base -= BATCH) {
    const int nb = min(BATCH, max_last - base);
    __syncthreads();  // the previous batch's shared data is consumed
    // zero the last group's padding entries: the warp test reads them
    for (int i = nb + t; i < min(BATCH, nb + GROUP - 1); i += NT) {
      sm.x[i] = sm.y[i] = sm.a[i] = sm.b[i] = sm.c[i] = sm.o[i] = 0.0f;
      sm.r[i] = sm.g[i] = sm.bl[i] = sm.d[i] = 0.0f;
    }
    for (int i = t; i < nb; i += NT) {
      const float* e = packed + start + base + i;
      sm.x[i] = e[0 * e_pad];
      sm.y[i] = e[1 * e_pad];
      sm.a[i] = e[2 * e_pad];
      sm.b[i] = e[3 * e_pad];
      sm.c[i] = e[4 * e_pad];
      sm.o[i] = e[5 * e_pad];
      sm.r[i] = e[8 * e_pad];
      sm.g[i] = e[9 * e_pad];
      sm.bl[i] = e[10 * e_pad];
      sm.d[i] = e[11 * e_pad];
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
          const float ex = sm.x[j], ey = sm.y[j];
          const float ea = sm.a[j], eb = sm.b[j], ec = sm.c[j];
          const float op = sm.o[j];
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
          const float er = sm.r[j], eg = sm.g[j], ebl = sm.bl[j], ed = sm.d[j];
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
      if (lane < USED) sm.acc[warp][q][lane] = slot;
    }
    __syncthreads();
    for (int idx = t; idx < NG * nb; idx += NT) {
      const int f = idx / nb;
      const int j = idx - f * nb;
      const int q = j / GROUP;
      const float* sums[WARPS];
#pragma unroll
      for (int w = 0; w < WARPS; ++w) sums[w] = &sm.acc[w][q][(j - q * GROUP) * NG];
      // the block's sum of slot i of entry j, the warps added in order
      auto block_sum = [&](int i) {
        float sum = sums[0][i];
#pragma unroll
        for (int w = 1; w < WARPS; ++w) sum += sums[w][i];
        return sum;
      };
      float grad;
      if (f == 0) {         // x: -sum dpow (a dx + b dy)
        grad = -(sm.a[j] * block_sum(0) + sm.b[j] * block_sum(1));
      } else if (f == 1) {  // y: -sum dpow (c dy + b dx)
        grad = -(sm.c[j] * block_sum(1) + sm.b[j] * block_sum(0));
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

}  // namespace blend_bwd
