// The per-tile body of the tile-blend forward, shared by K1
// (csrc/blend_fwd.cu, one row per block) and K4f (csrc/blend_v3_fwd.cu,
// ``tps`` rows per block, one after another). The contract is K1's source
// note. One body means one sequence of batches, tests and operations per
// row: K4f's rows 0-5 equal K1's bit for bit by construction.
//
// kernels.py names a built library by a hash of its .cu source together with
// every csrc/ header it includes, so an edit here rebuilds both kernels.
//
// Design. A block of 128 threads runs the body on one output row (a 16 x 16
// tile); each thread owns PPT = 2 vertically adjacent pixels of one column,
// and each of the four warps an 8 x 8 pixel block (K2's layout,
// csrc/blend_bwd_tile.cuh), whose lanes share contributors more often than
// two full pixel rows do. The block stages its range in batches of 128
// entries, one entry per thread, with 4-byte cp.async into two shared
// buffers: the next batch is in flight while the warps consume this one,
// with one barrier per batch. The thread that copied an entry then stores
// its cull box (below) beside it. Per batch a warp runs two warp-uniform
// tests before any per-pixel work:
//   1. the bounding-box cull: each lane tests one entry in 32 against the
//      warp's block (four compares), and a ballot packs the positions of the
//      entries it keeps, in order, into the warp's list in shared memory;
//      the warp then walks only its list, so a culled entry costs it no
//      step at all;
//   2. per listed entry, the early cut shared with K2: each pixel's power,
//      and the entry is skipped unless a lane has a pixel that is not
//      stopped, has power <= 0 and is not below power -5.6 at opacity <= 1
//      (exp(-5.6) < 1/255).
// Then both pixels' evaluate-and-blend steps run as one straight-line
// block, so the two exp and blend chains overlap; a pixel that skips the
// entry keeps its T, sums and count through selects. A warp leaves the batch
// loop as soon as its 64 pixels have stopped (a vote after each blended
// entry); the block ends the row at the first batch boundary at which every
// warp has stopped (__syncthreads_count). Each pixel's operations are those
// of the sequential loop in the contract, in the same order.
//
// The cull. The box is given by half-widths (hx, hy) around the entry's
// centre, outside of which no pixel can pass the test of the contract; a
// warp drops the entry when px0 - x > hx, x - px1 > hx, py0 - y > hy or
// y - py1 > hy for its block [px0, px1] x [py0, py1], each difference
// rounded once. The box:
//   - cull nothing (hx = hy = +inf) unless |x|, |y| <= 2^20 and |a|, |b|,
//     |c| <= 2^40 (then, on a canvas under 2^20 pixels a side, no product
//     in power overflows, so power is never NaN); nor for an opacity above
//     1 or NaN, nor unless a, c >= 2^-40, det = ac - b^2 > 0 and K = (a +
//     c)^2 / det <= 2^16 in float32, nor unless t = logf(255 o) + 1e-5 > 0;
//   - cull everywhere (hx = hy = -inf) for an opacity below (1/255) *
//     0.99999 within those ranges: alpha <= o expf(power) (1 + u) with power
//     <= 0 and expf's 2-ulp error, below 1/255;
//   - else hx = 1.01 sqrt(2 tau' c / det), hy = 1.01 sqrt(2 tau' a / det),
//     tau' = 1.0625 t: the axis-aligned box of the ellipse
//     a dx^2 + 2b dx dy + c dy^2 <= 2 tau' around the alpha >= 1/255 region.
// Why it is conservative (u = 2^-24, every operation rounded on its own by
// --fmad=false): with exact dx, dy and Q = a dx^2 + 2b dx dy + c dy^2, the
// kernel's power differs from -Q/2 by at most gamma_6 (a dx^2 + c dy^2),
// since |b dx dy| <= (a dx^2 + c dy^2) / 2 for a positive definite conic;
// and a dx^2 + c dy^2 <= K Q (lambda_min >= det / (a + c)). So
// -power >= (Q / 2)(1 - 2 gamma_6 K) >= 0.953 Q / 2. A pixel passes only if
// -power <= tau + 8u, tau = ln(255 o) (expf's and the product's rounding
// and 1/255's). K <= 2^16 also keeps det's rounding under 0.42% and proves
// the exact det positive. t exceeds tau + 8u (logf is within 1 ulp), so a
// pixel outside the box has Q > 2 tau' >= 2 (tau + 8u) / 0.953: it fails
// the test; the 1.01 covers the rounding of the box itself and of the four
// differences. A NaN anywhere makes every compare false: no cull. So the
// cull removes only entries that fail the exact test at every pixel of the
// warp's block, and the output is the same, bit for bit, as without it.
// rasterizer/blend.py warp_block_cull_plain mirrors it for the tests and
// chip_smoke.py's counts.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace blend_fwd {

constexpr int TILE = 16;
constexpr int PX = TILE * TILE;
constexpr int PPT = 2;              // pixels per thread, vertically adjacent
constexpr int NT = PX / PPT;        // threads per block
constexpr int WARPS = NT / 32;
constexpr int WARP_W = 8;           // a warp's pixel block is 8 x 8
constexpr int BATCH = NT;           // entries per batch, one staged by each thread
static_assert(BATCH <= 256, "a warp's list holds batch positions in bytes");
constexpr int MIN_BLOCKS = 6;       // resident blocks per SM the registers must allow
constexpr unsigned FULL = 0xffffffffu;
constexpr float ALPHA_MAX = 0.99f;
constexpr float ALPHA_MIN = 1.0f / 255.0f;
constexpr float T_MIN = 1e-4f;
// the cull's ranges and margins (the note above)
constexpr float COORD_MAX = 1048576.0f;                // 2^20
constexpr float CONIC_MAX = 1099511627776.0f;          // 2^40
constexpr float CONIC_MIN = 1.0f / 1099511627776.0f;   // 2^-40
constexpr float COND_MAX = 65536.0f;                   // (a + c)^2 / det
constexpr float OPACITY_NONE = ALPHA_MIN * 0.99999f;   // below: no pixel can pass
constexpr float TAU_SLACK = 1e-5f;
constexpr float TAU_SCALE = 1.0625f;
constexpr float BOX_SCALE = 1.01f;

// One staged batch; geo and conic are read as one float4 each per entry.
struct Batch {
  float4 geo[BATCH];    // x, y, hx, hy (the cull box's half-widths)
  float4 conic[BATCH];  // a, b, c, opacity
  float4 feat[BATCH];   // r, g, b, depth
};

// The block's shared memory: two batches and each warp's list.
struct Smem {
  Batch batch[2];
  unsigned char list[WARPS][BATCH];  // per warp: the positions its cull keeps
};

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// Entry ``base + t`` of the range [first, first + count) into ``b`` (the
// fields the blend reads), by thread t; every thread commits a group.
__device__ __forceinline__ void stage(const float* __restrict__ packed, int64_t e_pad, int64_t first, int count,
                                      int base, Batch& b) {
  const int t = threadIdx.x;
  if (base + t < count) {
    const float* e = packed + first + base + t;
    cp_async4(&b.geo[t].x, e + 0 * e_pad);
    cp_async4(&b.geo[t].y, e + 1 * e_pad);
    cp_async4(&b.conic[t].x, e + 2 * e_pad);
    cp_async4(&b.conic[t].y, e + 3 * e_pad);
    cp_async4(&b.conic[t].z, e + 4 * e_pad);
    cp_async4(&b.conic[t].w, e + 5 * e_pad);
    cp_async4(&b.feat[t].x, e + 8 * e_pad);
    cp_async4(&b.feat[t].y, e + 9 * e_pad);
    cp_async4(&b.feat[t].z, e + 10 * e_pad);
    cp_async4(&b.feat[t].w, e + 11 * e_pad);
  }
  cp_async_commit();
}

// The cull box's half-widths for entry i of ``b``: +inf culls nothing, -inf
// culls every pixel (the note above).
__device__ __forceinline__ void cull_box(Batch& b, int i) {
  const float4 g = b.geo[i];
  const float4 k = b.conic[i];
  const float a = k.x, bb = k.y, c = k.z, o = k.w;
  float h_x = __int_as_float(0x7f800000), h_y = h_x;  // +inf
  const bool tame = fabsf(g.x) <= COORD_MAX && fabsf(g.y) <= COORD_MAX && fabsf(a) <= CONIC_MAX &&
                    fabsf(bb) <= CONIC_MAX && fabsf(c) <= CONIC_MAX;
  if (tame && o < OPACITY_NONE) {
    h_x = h_y = -h_x;
  } else if (tame && o <= 1.0f && a >= CONIC_MIN && c >= CONIC_MIN) {
    const float det = a * c - bb * bb;
    const float tr = a + c;
    const float t = logf(255.0f * o) + TAU_SLACK;
    if (det > 0.0f && tr * tr <= COND_MAX * det && t > 0.0f) {
      const float t2 = 2.0f * (TAU_SCALE * t);
      h_x = BOX_SCALE * sqrtf(t2 * c / det);
      h_y = BOX_SCALE * sqrtf(t2 * a / det);
    }
  }
  b.geo[i].z = h_x;
  b.geo[i].w = h_y;
}

// Blend output row ``row`` (tile tile_ids[row], or tile ``row`` without a
// tile map) into out[row], by a block of NT threads. The caller separates
// two calls on one ``sm`` with a barrier.
__device__ __forceinline__ void fwd_tile(
    const float* __restrict__ packed, int64_t e_pad,
    const int32_t* __restrict__ tile_start,
    const int32_t* __restrict__ tile_count,
    const int32_t* __restrict__ tile_ids, int tiles_x, int row,
    float* __restrict__ out, Smem& sm) {
  const int tile = tile_ids ? tile_ids[row] : row;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  // warp w covers the 8 x 8 block (w % 2, w / 2) of the tile
  const int bcol = (warp % (TILE / WARP_W)) * WARP_W;
  const int brow = (warp / (TILE / WARP_W)) * WARP_W;
  const int col = bcol + lane % WARP_W;
  const int prow = brow + (lane / WARP_W) * PPT;  // first pixel row
  const int tx0 = (tile % tiles_x) * TILE, ty0 = (tile / tiles_x) * TILE;
  const float px = (float)(tx0 + col);
  const float bx0 = (float)(tx0 + bcol), bx1 = (float)(tx0 + bcol + WARP_W - 1);
  const float by0 = (float)(ty0 + brow), by1 = (float)(ty0 + brow + WARP_W - 1);
  const int64_t start = tile_start[row];
  const int count = tile_count[row];

  float py[PPT], T[PPT], acc_r[PPT], acc_g[PPT], acc_b[PPT], acc_d[PPT];
  int last[PPT];
  bool done[PPT];
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    py[k] = (float)(ty0 + prow + k);
    T[k] = 1.0f;
    acc_r[k] = acc_g[k] = acc_b[k] = acc_d[k] = 0.0f;
    last[k] = 0;
    done[k] = false;
  }

  const int nbatch = (count + BATCH - 1) / BATCH;
  bool warp_done = false;  // warp-uniform: all 64 pixels of the warp have stopped
  if (nbatch > 0) stage(packed, e_pad, start, count, 0, sm.batch[0]);
  for (int bi = 0; bi < nbatch; ++bi) {
    Batch& cur = sm.batch[bi & 1];
    const int base = bi * BATCH;
    cp_async_wait_all();  // this thread's copies of batch bi have landed
    if (base + t < count) cull_box(cur, t);
    // the batch and its boxes are visible to every thread, and batch bi - 1,
    // whose buffer the next copy fills, is consumed
    if (__syncthreads_count(warp_done) == NT) break;
    if (bi + 1 < nbatch) stage(packed, e_pad, start, count, base + BATCH, sm.batch[(bi + 1) & 1]);
    if (warp_done) continue;
    const int nb = min(BATCH, count - base);
    // 1. the bounding-box cull: each lane tests one entry in 32 against the
    // warp's block, and a ballot packs the kept entries' positions, in
    // order, into the warp's list
    int n_keep = 0;
    __syncwarp();  // the warp's previous list is consumed
    for (int i0 = 0; i0 < nb; i0 += 32) {
      const int i = i0 + lane;
      bool keep = false;
      if (i < nb) {
        const float4 g = cur.geo[i];
        keep = !(bx0 - g.x > g.z || g.x - bx1 > g.z || by0 - g.y > g.w || g.y - by1 > g.w);
      }
      const unsigned kept = __ballot_sync(FULL, keep);
      if (keep) sm.list[warp][n_keep + __popc(kept & ((1u << lane) - 1u))] = (unsigned char)i;
      n_keep += __popc(kept);
    }
    __syncwarp();
    for (int q = 0; q < n_keep; ++q) {
      const int j = sm.list[warp][q];
      const float4 g = cur.geo[j];
      const float ex = g.x, ey = g.y;
      const float4 cn = cur.conic[j];
      const float dx = ex - px;
      float power[PPT];
      bool ok[PPT];
      bool any_ok = false;
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        const float dy = ey - py[k];
        power[k] = -0.5f * (cn.x * dx * dx + cn.z * dy * dy) - cn.y * dx * dy;
        // 2. the early cut: exp(-5.6) < 1/255, so at opacity <= 1 such an
        // entry cannot reach alpha 1/255
        ok[k] = !done[k] && !(power[k] > 0.0f) && !(power[k] < -5.6f && cn.w <= 1.0f);
        any_ok |= ok[k];
      }
      if (!__any_sync(FULL, any_ok)) continue;  // warp-uniform
      const float4 f = cur.feat[j];
#pragma unroll
      for (int k = 0; k < PPT; ++k) {
        const float alpha = fminf(ALPHA_MAX, cn.w * expf(power[k]));
        const bool c = ok[k] && alpha >= ALPHA_MIN;
        const float test_t = T[k] * (1.0f - alpha);
        const bool stop = c && test_t < T_MIN;  // stop before this entry
        const bool blend = c && !stop;
        const float w = alpha * T[k];
        acc_r[k] = blend ? acc_r[k] + f.x * w : acc_r[k];
        acc_g[k] = blend ? acc_g[k] + f.y * w : acc_g[k];
        acc_b[k] = blend ? acc_b[k] + f.z * w : acc_b[k];
        acc_d[k] = blend ? acc_d[k] + f.w * w : acc_d[k];
        T[k] = blend ? test_t : T[k];
        last[k] = blend ? base + j + 1 : last[k];
        done[k] = done[k] || stop;
      }
      bool mine_done = true;
#pragma unroll
      for (int k = 0; k < PPT; ++k) mine_done = mine_done && done[k];
      if (__all_sync(FULL, mine_done)) {
        warp_done = true;
        break;
      }
    }
  }
  cp_async_wait_all();  // no copy outlives the call

#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    float* o = out + (int64_t)row * 8 * PX + (prow + k) * TILE + col;
    o[0 * PX] = acc_r[k];
    o[1 * PX] = acc_g[k];
    o[2 * PX] = acc_b[k];
    o[3 * PX] = acc_d[k];
    o[4 * PX] = T[k];
    o[5 * PX] = (float)last[k];
    o[6 * PX] = 0.0f;
    o[7 * PX] = 0.0f;
  }
}

}  // namespace blend_fwd
