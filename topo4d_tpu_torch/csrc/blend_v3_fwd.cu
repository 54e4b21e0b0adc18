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
// rows (1-8). On the TPU it walked the UNION of their spans once, so that
// one window DMA fed every row, and the block terminated collectively. Left
// behind with it: the union span, the double-buffered window DMA, the SMEM
// window cache, the log-space transmittance carry, the (8, PX) transposed
// residual layout and the per-window residual rows (:663-677). On a GPU the
// union walk buys nothing: the rows' ranges are ascending and contiguous
// (tiles.py sorts the entries stably by (tile, depth), and
// compact_nonempty_tiles keeps the non-empty tiles in ascending id order,
// padding rows last with count 0), so a block that walks its rows' ranges
// one after another reads each entry once, as the union walk did
// (tests/test_torch_compact.py checks that order). Rows 5-7 keep K1's
// layout, so K2's and K4b's reverse sweeps start from the same row 5.
//
// Design. A block of 128 threads, K1's: each thread owns two vertically
// adjacent pixels, each warp an 8 x 8 block. The block runs K1's per-tile
// body (csrc/blend_fwd_tile.cuh) on each of its rows in turn: each row gets
// exactly K1's batches, cull, early cut, per-warp stop and operation order,
// so K4f's rows 0-5 equal K1's bit for bit, with a barrier between two
// rows. The one thing the window-span idea still offered a GPU was to carry
// the double buffer across rows: a row's last batch issuing the next row's
// first batch, so that its copies overlap the last batch's work. Timed
// in turns with this turn-by-turn version in one call (chip_smoke.py
// --ref) it was 1-5% slower at the 4K view at tps 4 and 8, 1% faster at
// the geometry view, and took 64 registers against 56, so it was dropped
// (PERF.md section 6 has the times).
//
// Bound on an H100 SXM: the same work as K1 (the same entries read, the
// same output written, the same pairs evaluated), so K1's bound at the same
// shape. A block does ``tps`` tiles' work in series, so at the 4K compact
// view (18,432 rows, 4,608 blocks at tps 4) it has a quarter of K1's
// blocks, and at the geometry view (768 rows, 192 blocks at tps 4 on 132
// SMs) fewer blocks than the card has room for. Measured (chip_smoke.py
// with --ref and the union-span design's source, NVIDIA H100 80GB HBM3,
// 700.00 W; PERF.md section 6): at the 4K compact view, the kernel alone,
// 0.5183 ms at tps 4 and 0.5775 at tps 8 against the union-span design's
// 0.9205 / 1.2819; through the wrapper 0.5226 / 0.5786 ms against K1's
// 0.4678 in the same call (1.12x, 1.24x); at the geometry view, the
// kernels alone, 0.0429 / 0.0818 ms against K1's 0.0168 and the union-span
// design's 0.0830 / 0.2039. -Xptxas -v: K1's 56 registers and 12,800 bytes
// of static shared memory, no spills.
//
// Since the body is K1's, K4f's rows 0-5 equal K1's by construction, and
// chip_smoke.py's assertion that they do guards the row loop, not the body.
// The body is held to the plain version by the forward check (rtol 1e-4,
// atol 1e-5) and, through chip_smoke.py --ref, to an earlier K1 source bit
// for bit.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false, as K1.

#include <cuda_runtime.h>
#include <stdint.h>

#include "blend_fwd_tile.cuh"

namespace {

using namespace blend_fwd;

constexpr int MAX_TPS = 8;

__global__ void __launch_bounds__(NT, MIN_BLOCKS) tile_blend_v3_fwd_kernel(
    const float* __restrict__ packed, int64_t e_pad,
    const int32_t* __restrict__ tile_start,
    const int32_t* __restrict__ tile_count,
    const int32_t* __restrict__ tile_ids, int tiles_x, int num_rows, int tps,
    float* __restrict__ out) {
  __shared__ Smem sm;
  const int row0 = blockIdx.x * tps;
  const int rows = min(tps, num_rows - row0);
  for (int j = 0; j < rows; ++j) {
    if (j > 0) __syncthreads();  // the previous row's batches are consumed
    fwd_tile(packed, e_pad, tile_start, tile_count, tile_ids, tiles_x, row0 + j, out, sm);
  }
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
    const int blocks = (num_rows + tps - 1) / tps;
    tile_blend_v3_fwd_kernel<<<blocks, NT, 0, (cudaStream_t)stream>>>(
        (const float*)packed, e_pad, (const int32_t*)tile_start,
        (const int32_t*)tile_count, (const int32_t*)tile_ids, tiles_x,
        num_rows, tps, (float*)out);
  }
  return (int)cudaGetLastError();
}
