// UV z-buffer bake (K6) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel topo4d_tpu/texture/bake_pallas.py
// _bake_kernel (:216), launched by _bake_compact (:360) under
// _fill_and_bake (:397), whose color gather it fuses, and the host
// _assemble_canvas (:416), whose scatter onto the canvas it fuses too.
//
// Contract. The binning (texture/bake_tiled.py BakeBinning) holds E entries
// sorted by (16x16 tile, triangle id): geom (10, E) float32 rows x0, y0, x1,
// y1, x2, y2, z0, z1, z2, tile id; corner_idx (3, E) int32, the color row of
// each corner; the M occupied tiles tile_ids[i] with their entry ranges
// [start[i], start[i] + count[i]), count[i] >= 1; and the ascending list of
// the canvas's other tiles, empty_ids. For each pixel centre (px, py) of an
// occupied tile on the canvas, over the tile's entries in order:
//   v0 = p2 - p0, v1 = p1 - p0, dot00 = v0.v0, dot01 = v0.v1, dot11 = v1.v1,
//   inv = 1 / (dot00 dot11 - dot01^2), or 0 where that is 0;
//   dot02 = v0.(p - p0), dot12 = v1.(p - p0);
//   u = (dot11 dot02 - dot01 dot12) inv, w1 = (dot00 dot12 - dot01 dot02) inv,
//   w0 = 1 - u - w1;
//   inside: u >= 0, w1 >= 0, w1 + u <= 1 and ceil(min x) <= px <= floor(max
//   x), ceil(min y) <= py <= floor(max y);
//   depth = w0 z0 + w1 z1 + u z2; the entry wins the pixel if inside and
//   depth > the best so far (from -1e30), so a bigger z wins and the first
//   entry keeps a tie; color = w0 c0 + w1 c1 + u c2.
// The winner's r, g, b go into the (H, W, 3) float32 canvas. The kernel
// writes every pixel of the canvas, 0 where no triangle covers it, so the
// caller allocates it without a fill.
//
// Bound on an H100 SXM. At the main path's 8192^2 bake of 546,028 dense
// triangles the kernel must read each entry's ten geometry rows and three
// corner ids (52 B, 93 MB for 1,786,558 entries), the tile lists and the
// corner colors, and write the 805 MB canvas: 0.27 ms at 3.35 TB/s. So
// bytes bound it, counted with 32 FP32 operations per (pixel, entry) pair
// of every tile's range at the published 67 TFLOP/s, which counts a fused
// multiply-add as two: 457M pairs are 0.22 ms. The build has no fused
// multiply-add (--fmad=false), so each of those operations issues on its
// own: ~1.5e10 lane instructions, ~0.44 ms of FP32 issue at 128 lanes x 132
// SMs if every pair were evaluated; the cull below leaves 240M of them.
//
// Design.
//   - Persistent blocks: as many 128-thread blocks as fit on the card at
//     once (the occupancy API, cached; eight per SM, by registers and
//     shared memory), each walking the occupied tiles blockIdx.x, +
//     gridDim.x, ... in batches of at most 32 entries. The first design
//     started ~213k short blocks, each opening with a chain of dependent
//     loads (tile id, range, geometry and corner ids, colors) that nothing
//     overlapped.
//   - A five-slot ring of batches in shared memory and one barrier per
//     batch. In step s warp 0 issues batch s + 4's raw corners, depths and
//     corner ids (lane i its entry i, 4-byte cp.async) and waits for batch
//     s + 3's; warp 1 computes batch s + 2's per-entry terms (v0, v1, the
//     dots, inv, the inner bbox) in the plain version's order, issues the
//     gather of its nine corner colors, and waits for batch s + 1's colors;
//     every warp evaluates batch s. Warp 0 takes the tile headers from
//     windows of 32, one per lane, loaded a window ahead.
//   - K1's layout: each thread owns two vertically adjacent pixels of a
//     column, each warp an 8 x 8 pixel block.
//   - An exact per-warp cull: lane i tests entry i's inner bbox against the
//     warp's 8 x 8 block and a ballot gives the kept entries as a bit mask,
//     walked in order. An entry is dropped when umax < bx0, umin > bx1,
//     vmax < by0 or vmin > by1 for the block [bx0, bx1] x [by0, by1]: every
//     pixel centre of the block then fails the contract's own bbox compare,
//     whose operands are the same floats, so no rounding argument is
//     needed; a NaN keeps the entry. texture/bake_tiled.py
//     bake_warp_cull_plain mirrors it for the tests and chip_smoke.py's
//     counts. A warp skips the depth test of an entry none of its pixels is
//     inside (a vote).
//   - Each pixel keeps its best depth and, per batch, its winner's index;
//     at the end of the batch it forms the winner's weights again with the
//     same operations and its color from the gathered colors. A later
//     batch's winner replaces it, as a later entry would.
//   - A finished tile goes through shared memory (rows padded to 52 words,
//     so the pixels' writes fall in distinct banks) and out, after the next
//     barrier, as float4 stores of whole rows. One empty tile is written as
//     zeros per step, so those stores overlap the work too.
// Measured (chip_smoke.py with --ref, each source timed alone in turns with
// this one in one call; NVIDIA H100 80GB HBM3, 700.00 W; PERF.md section 6
// has every run, and the earlier states and ablations of this file timed
// the same way): 0.8803 ms at 8192^2, 0.8839 through the wrapper, against
// 1.9719 for the first design with the fill it needs. The cull skips
// 47.5% of the pairs at 8192^2. -Xptxas -v: 64 registers, 25,296 bytes of
// static shared memory, no spills.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false.
// --fmad=false keeps every product and sum rounded on its own, in the plain
// PyTorch version's order (texture/bake_tiled.py bake_canvas_plain), so the
// inclusive inside test, the depth test and the colors equal it bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 16;
constexpr int PPT = 2;               // pixels per thread, vertically adjacent
constexpr int NT = TILE * TILE / PPT;
constexpr int WARP_W = 8;            // a warp's pixel block is 8 x 8
constexpr int BATCH = 32;            // entries per batch: one ballot per warp
constexpr int SLOTS = 5;             // batches in the ring, five steps from copy to evaluation
constexpr int MIN_BLOCKS = 8;        // resident blocks per SM the registers must allow
constexpr int OUT_STRIDE = 52;       // words per staged row: its 48 padded, 16-byte aligned
constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG = -1e30f;
// a batch's flags
constexpr int VALID = 1;  // the slot holds a batch (else the block's stream has ended)
constexpr int FIRST = 2;  // the batch opens its tile
constexpr int LAST = 4;   // the batch closes its tile

// One slot of the ring. As copied: box = (x1, y1, x2, y2), p = (x0, y0, -,
// -), r = (-, -, z0, z1); the producer warp's lane i then fills in entry i's
// terms.
struct Batch {
  float4 box[BATCH];  // umin, umax, vmin, vmax
  float4 p[BATCH];    // x0, y0, v0x, v0y
  float4 q[BATCH];    // v1x, v1y, dot00, dot01
  float4 r[BATCH];    // dot11, inv, z0, z1
  float z2[BATCH];
  float c[9][BATCH];  // r, g, b of corners 0, 1, 2
  int idx[3][BATCH];  // the corners' color rows
  int tile, len, flags;
};

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>  // every group but the newest N has landed
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

// Warp 0's walk over the block's batches: the occupied tiles blockIdx.x,
// + gridDim.x, ..., each cut into batches of BATCH entries. Lane l holds the
// headers of the window's tile l and of the next window's tile l, so a new
// tile's header is a shuffle, loaded a window (32 tiles) before its use.
struct Cursor {
  const int32_t* tile_ids;
  const int32_t* start;
  const int32_t* count;
  int m, step;
  int k0;         // the window's first tile
  int j;          // this tile's lane in the window
  int bi;         // this tile's next batch
  int w_tile, w_start, w_count;  // lane l: tile k0 + l * step
  int n_tile, n_start, n_count;  // lane l: tile k0 + (32 + l) * step

  __device__ __forceinline__ void load(int k, int& tile, int& first, int& n) const {
    const bool in = k < m;
    tile = in ? tile_ids[k] : 0;
    first = in ? start[k] : 0;
    n = in ? count[k] : 0;
  }
  __device__ __forceinline__ void init(int k) {
    const int lane = threadIdx.x & 31;
    k0 = k;
    j = 0;
    bi = 0;
    load(k0 + lane * step, w_tile, w_start, w_count);
    load(k0 + (32 + lane) * step, n_tile, n_start, n_count);
  }
  // Issue the next batch's geometry and corner ids into ``b`` (lane i its
  // entry i) and describe it there; every lane commits a group.
  __device__ __forceinline__ void issue(const float* __restrict__ geom, const int32_t* __restrict__ corner_idx,
                                        int64_t e, Batch& b) {
    const int lane = threadIdx.x & 31;
    const int tile = __shfl_sync(FULL, w_tile, j);
    const int first = __shfl_sync(FULL, w_start, j);
    const int n = __shfl_sync(FULL, w_count, j);
    const bool valid = k0 + j * step < m;
    const int base = bi * BATCH;
    const int len = valid ? min(BATCH, n - base) : 0;
    if (lane < len) {
      const int64_t k = (int64_t)first + base + lane;
      cp_async4(&b.p[lane].x, geom + k);
      cp_async4(&b.p[lane].y, geom + e + k);
      cp_async4(&b.box[lane].x, geom + 2 * e + k);
      cp_async4(&b.box[lane].y, geom + 3 * e + k);
      cp_async4(&b.box[lane].z, geom + 4 * e + k);
      cp_async4(&b.box[lane].w, geom + 5 * e + k);
      cp_async4(&b.r[lane].z, geom + 6 * e + k);
      cp_async4(&b.r[lane].w, geom + 7 * e + k);
      cp_async4(&b.z2[lane], geom + 8 * e + k);
#pragma unroll
      for (int corner = 0; corner < 3; ++corner) cp_async4(&b.idx[corner][lane], corner_idx + corner * e + k);
    }
    cp_async_commit();
    const bool last = base + BATCH >= n;  // an empty range is one batch of no entry
    if (lane == 0) {
      b.tile = tile;
      b.len = len;
      b.flags = valid ? VALID | (bi == 0 ? FIRST : 0) | (last ? LAST : 0) : 0;
    }
    if (!valid) return;
    ++bi;
    if (last) {  // on to the block's next tile
      bi = 0;
      if (++j == 32) {
        j = 0;
        k0 += 32 * step;
        w_tile = n_tile;
        w_start = n_start;
        w_count = n_count;
        load(k0 + (32 + lane) * step, n_tile, n_start, n_count);
      }
    }
  }
};

// Entry i's terms, in the plain version's order, by lane i of the producer
// warp; then the gather of its corner colors (not committed here).
__device__ __forceinline__ void terms_and_colors(Batch& b, int i, const float* __restrict__ colors, int ncol) {
  const float x0 = b.p[i].x, y0 = b.p[i].y;
  const float4 raw = b.box[i];
  const float x1 = raw.x, y1 = raw.y, x2 = raw.z, y2 = raw.w;
  const float v0x = x2 - x0, v0y = y2 - y0;
  const float v1x = x1 - x0, v1y = y1 - y0;
  const float dot00 = v0x * v0x + v0y * v0y;
  const float dot01 = v0x * v1x + v0y * v1y;
  const float dot11 = v1x * v1x + v1y * v1y;
  const float denom = dot00 * dot11 - dot01 * dot01;
  b.p[i].z = v0x;
  b.p[i].w = v0y;
  b.q[i] = make_float4(v1x, v1y, dot00, dot01);
  b.r[i].x = dot11;
  b.r[i].y = denom == 0.0f ? 0.0f : 1.0f / denom;
  b.box[i] = make_float4(ceilf(fminf(fminf(x0, x1), x2)), floorf(fmaxf(fmaxf(x0, x1), x2)),
                         ceilf(fminf(fminf(y0, y1), y2)), floorf(fmaxf(fmaxf(y0, y1), y2)));
#pragma unroll
  for (int corner = 0; corner < 3; ++corner) {
    const float* c = colors + (int64_t)b.idx[corner][i] * ncol;
    cp_async4(&b.c[3 * corner][i], c);
    cp_async4(&b.c[3 * corner + 1][i], c + 1);
    cp_async4(&b.c[3 * corner + 2][i], c + 2);
  }
}

// The barycentrics (u, w1) of a pixel at (dpx, dpy) = (px - x0, py - y0)
// from entry terms pp, qq, rr, in the plain version's order.
__device__ __forceinline__ float2 barycentric(float4 pp, float4 qq, float4 rr, float dpx, float dpy) {
  const float dot02 = pp.z * dpx + pp.w * dpy;
  const float dot12 = qq.x * dpx + qq.y * dpy;
  return make_float2((rr.x * dot02 - qq.w * dot12) * rr.y, (qq.z * dot12 - qq.w * dot02) * rr.y);
}

// The on-canvas part of tile ``tile``'s rows from ``src`` (row stride
// OUT_STRIDE), or zeros without one: whole rows at 16-byte aligned
// addresses as 12 float4 each, in order; else warp w writes rows w, w + 4,
// ..., each as consecutive words.
__device__ __forceinline__ void store_tile(float* __restrict__ out, int tile, int tiles_x, int width, int height,
                                           const float* src) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tx0 = (tile % tiles_x) * TILE, ty0 = (tile / tiles_x) * TILE;
  const int words = 3 * min(TILE, width - tx0);
  const int rows = min(TILE, height - ty0);
  // tx0 is a multiple of 16, so 12 (y W + tx0) bytes is a multiple of 16 when W is of 4
  if (words == 3 * TILE && (width & 3) == 0 && ((uintptr_t)out & 15) == 0) {
    for (int f = threadIdx.x; f < rows * 12; f += NT) {
      const int r = f / 12, c = f - r * 12;
      const float4 v = src ? *reinterpret_cast<const float4*>(src + r * OUT_STRIDE + 4 * c)
                           : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      reinterpret_cast<float4*>(out + ((int64_t)(ty0 + r) * width + tx0) * 3)[c] = v;
    }
    return;
  }
  for (int r = warp; r < rows; r += NT / 32) {
    float* row = out + ((int64_t)(ty0 + r) * width + tx0) * 3;
    for (int c = lane; c < words; c += 32) row[c] = src ? src[r * OUT_STRIDE + c] : 0.0f;
  }
}

__global__ void __launch_bounds__(NT, MIN_BLOCKS) uv_bake_kernel(
    const float* __restrict__ geom, const int32_t* __restrict__ corner_idx,
    int64_t e, const float* __restrict__ colors, int ncol,
    const int32_t* __restrict__ tile_ids, const int32_t* __restrict__ start,
    const int32_t* __restrict__ count, int m,
    const int32_t* __restrict__ empty_ids, int n_empty, int tiles_x,
    int width, int height, float* __restrict__ out) {
  __shared__ Batch ring[SLOTS];
  __shared__ __align__(16) float s_out[2][TILE * OUT_STRIDE];

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  // warp w covers the 8 x 8 block (w % 2, w / 2) of the tile
  const int bcol = (warp % (TILE / WARP_W)) * WARP_W;
  const int brow = (warp / (TILE / WARP_W)) * WARP_W;
  const int col = bcol + lane % WARP_W;
  const int prow = brow + (lane / WARP_W) * PPT;  // first pixel row
  const int step = gridDim.x;

  // The ring, in step s: warp 0 issues batch s + 4's copies and waits for
  // batch s + 3's; warp 1 computes batch s + 2's terms and issues the gather
  // of its colors, and waits for batch s + 1's colors; every warp evaluates
  // batch s. One barrier per step.
  Cursor cur;
  if (warp == 0) {
    cur = Cursor{tile_ids, start, count, m, step};
    cur.init(blockIdx.x);
    for (int i = 0; i < SLOTS - 1; ++i) cur.issue(geom, corner_idx, e, ring[i]);
  }
  // the empty tiles: one per step, so that their stores overlap the work,
  // and the rest after the last; the next one's id is loaded a step ahead
  int empty_i = blockIdx.x;
  int empty_id = empty_i < n_empty ? empty_ids[empty_i] : 0;
  auto store_empty = [&]() {
    store_tile(out, empty_id, tiles_x, width, height, nullptr);
    empty_i += step;
    empty_id = empty_i < n_empty ? empty_ids[empty_i] : 0;
  };
  if (warp == 0) cp_async_wait<2>();  // batches 0 and 1
  __syncthreads();
  if (warp == 1) {
    for (int i = 0; i < 2; ++i) {
      if (lane < ring[i].len) terms_and_colors(ring[i], lane, colors, ncol);
      cp_async_commit();
    }
    cp_async_wait<1>();  // batch 0's colors
  }
  if (warp == 0) cp_async_wait<1>();  // batch 2
  __syncthreads();

  float py[PPT], zbuf[PPT], cr[PPT], cg[PPT], cb[PPT];  // set by each tile's first batch
#pragma unroll
  for (int p = 0; p < PPT; ++p) py[p] = zbuf[p] = cr[p] = cg[p] = cb[p] = 0.0f;
  int out_tile = -1, out_buf = 0;  // the tile whose colors wait in s_out[out_buf ^ 1]
  for (int s = 0;; ++s) {
    const Batch& b = ring[s % SLOTS];
    const int flags = b.flags;
    if (!(flags & VALID)) break;
    if (out_tile >= 0) store_tile(out, out_tile, tiles_x, width, height, s_out[out_buf ^ 1]);
    out_tile = -1;
    if (empty_i < n_empty) store_empty();
    if (warp == 0) cur.issue(geom, corner_idx, e, ring[(s + SLOTS - 1) % SLOTS]);
    if (warp == 1) {
      Batch& nb = ring[(s + 2) % SLOTS];
      if (lane < nb.len) terms_and_colors(nb, lane, colors, ncol);
      cp_async_commit();
    }
    const int tile = b.tile, len = b.len;
    const int tx0 = (tile % tiles_x) * TILE, ty0 = (tile / tiles_x) * TILE;
    const float px = (float)(tx0 + col);
    const float bx0 = (float)(tx0 + bcol), bx1 = (float)(tx0 + bcol + WARP_W - 1);
    const float by0 = (float)(ty0 + brow), by1 = (float)(ty0 + brow + WARP_W - 1);
    if (flags & FIRST) {
#pragma unroll
      for (int p = 0; p < PPT; ++p) {
        py[p] = (float)(ty0 + prow + p);
        zbuf[p] = NEG;
        cr[p] = cg[p] = cb[p] = 0.0f;
      }
    }
    int win_j[PPT];  // each pixel's winner in this batch
#pragma unroll
    for (int p = 0; p < PPT; ++p) win_j[p] = -1;
    // the cull: lane i tests entry i against the warp's block
    bool keep = false;
    if (lane < len) {
      const float4 bb = b.box[lane];
      keep = !(bb.y < bx0 || bb.x > bx1 || bb.w < by0 || bb.z > by1);
    }
    for (unsigned kept = __ballot_sync(FULL, keep); kept; kept &= kept - 1u) {
      const int j = __ffs(kept) - 1;
      const float4 bb = b.box[j];
      const float4 pp = b.p[j];
      const float4 qq = b.q[j];
      const float4 rr = b.r[j];
      const float dpx = px - pp.x;
      const bool in_x = px >= bb.x && px <= bb.y;
      float2 uw[PPT];
      bool inside[PPT];
      bool any_inside = false;
#pragma unroll
      for (int p = 0; p < PPT; ++p) {
        uw[p] = barycentric(pp, qq, rr, dpx, py[p] - pp.y);
        inside[p] = uw[p].x >= 0.0f && uw[p].y >= 0.0f && uw[p].y + uw[p].x <= 1.0f && in_x && py[p] >= bb.z &&
                    py[p] <= bb.w;
        any_inside |= inside[p];
      }
      if (!__any_sync(FULL, any_inside)) continue;  // warp-uniform
      const float z2 = b.z2[j];
#pragma unroll
      for (int p = 0; p < PPT; ++p) {
        const float u = uw[p].x, w1 = uw[p].y;
        const float w0 = 1.0f - u - w1;
        const float depth = w0 * rr.z + w1 * rr.w + u * z2;
        const bool win = inside[p] && depth > zbuf[p];
        zbuf[p] = win ? depth : zbuf[p];
        win_j[p] = win ? j : win_j[p];
      }
    }
    // the batch's winners' colors, gathered while it was resolved, with the
    // winner's weights formed again by the same operations
#pragma unroll
    for (int p = 0; p < PPT; ++p) {
      const int j = win_j[p];
      if (j >= 0) {
        const float4 pp = b.p[j];
        const float2 uw = barycentric(pp, b.q[j], b.r[j], px - pp.x, py[p] - pp.y);
        const float u = uw.x, w1 = uw.y;
        const float w0 = 1.0f - u - w1;
        cr[p] = w0 * b.c[0][j] + w1 * b.c[3][j] + u * b.c[6][j];
        cg[p] = w0 * b.c[1][j] + w1 * b.c[4][j] + u * b.c[7][j];
        cb[p] = w0 * b.c[2][j] + w1 * b.c[5][j] + u * b.c[8][j];
      }
    }
    if (flags & LAST) {  // written out in the next step, after the barrier
#pragma unroll
      for (int p = 0; p < PPT; ++p) {
        float* o = s_out[out_buf] + (prow + p) * OUT_STRIDE + col * 3;
        o[0] = cr[p];
        o[1] = cg[p];
        o[2] = cb[p];
      }
      out_tile = tile;
      out_buf ^= 1;
    }
    if (warp == 0) cp_async_wait<1>();  // batch s + 3
    if (warp == 1) cp_async_wait<1>();  // batch s + 1's colors
    __syncthreads();
  }
  if (out_tile >= 0) store_tile(out, out_tile, tiles_x, width, height, s_out[out_buf ^ 1]);
  while (empty_i < n_empty) store_empty();
  cp_async_wait<0>();  // no copy outlives the block
}

}  // namespace

// Launches K6 on ``stream``: the m occupied tiles and the n_empty others,
// every pixel of the (height, width, 3) ``out`` written. Returns
// cudaGetLastError() (0 = launched).
extern "C" int uv_bake(const void* geom, const void* corner_idx, int64_t e,
                       const void* colors, int ncol, const void* tile_ids,
                       const void* start, const void* count, int m,
                       const void* empty_ids, int n_empty, int tiles_x,
                       int width, int height, void* out, void* stream) {
  static int resident = 0;  // blocks the whole card holds at once
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, uv_bake_kernel, NT, 0);
    if (err != cudaSuccess) return (int)err;
    if (sms * per_sm <= 0) return (int)cudaErrorInvalidConfiguration;
    resident = sms * per_sm;
  }
  const int tiles = m > n_empty ? m : n_empty;
  const int blocks = tiles < resident ? tiles : resident;
  if (blocks > 0) {
    uv_bake_kernel<<<blocks, NT, 0, (cudaStream_t)stream>>>(
        (const float*)geom, (const int32_t*)corner_idx, e,
        (const float*)colors, ncol, (const int32_t*)tile_ids,
        (const int32_t*)start, (const int32_t*)count, m,
        (const int32_t*)empty_ids, n_empty, tiles_x, width, height,
        (float*)out);
  }
  return (int)cudaGetLastError();
}
