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
// passes the gradient straight through.
//
// The TPU kernel's idea, kept: one block owns ``tps`` consecutive output
// rows (1-8). On the TPU it walked the UNION of their spans once, so that
// one window DMA fed every row. Left behind with it: the union span, the
// log-space transmittance, the per-window residuals, the double-buffered DMA
// and the window-accumulator flush. On a GPU the union walk buys nothing:
// the rows' ranges are ascending and contiguous (tiles.py sorts the entries
// stably by (tile, depth), and compact_nonempty_tiles keeps the non-empty
// tiles in ascending id order, padding rows last with count 0), so a block
// that walks its rows' ranges one after another reads each entry once, as
// the union walk did (tests/test_torch_compact.py checks that order).
//
// Design. A block of 128 threads, K2's: each thread owns two vertically
// adjacent pixels, each warp an 8 x 8 block. The block runs K2's per-tile
// body (csrc/blend_bwd_tile.cuh) on each of its rows in turn, with a
// barrier between two rows: each tile gets exactly K2's batches from its own
// furthest last contributor down, groups of three entries, warp-uniform
// tests and butterfly reduce-scatters, and its cotangent and T_final are
// read once. So every entry's sum is formed in K2's order (the pixels, the
// shuffle tree, the four warps in order): K4b's dpacked equals K2's bit for
// bit, and like K2 it uses no atomics. A block does ``tps`` tiles' work in
// series, so at the 4K view (18,432 rows, 4,608 blocks at tps 4) it has a
// quarter of K2's blocks, and at the geometry view (768 rows, 192 blocks on
// 132 SMs) fewer blocks than the card has room for.
//
// Bound on an H100 SXM: the same work as K2 at the same shape, so K2's
// bound. Measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700.00 W): 1.432 ms
// at tps 4 and 1.586 ms at tps 8 at the 4K compact view against K2's 1.293
// in the same call (the union-span design took 3.193 / 3.587); 0.141 /
// 0.276 ms at the geometry view against K2's 0.046. -Xptxas -v: 80
// registers, 19,204 bytes of static shared memory, no spills.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false, so the
// skip decisions recomputed here equal the forward's bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "blend_bwd_tile.cuh"

namespace {

using namespace blend_bwd;

constexpr int MAX_TPS = 8;

__global__ void __launch_bounds__(NT, MIN_BLOCKS) tile_blend_v3_bwd_kernel(
    const float* __restrict__ packed, int64_t e_pad,
    const int32_t* __restrict__ tile_start,
    const int32_t* __restrict__ tile_count,
    const int32_t* __restrict__ tile_ids, int tiles_x, int num_rows, int tps,
    const float* __restrict__ fwd, const float* __restrict__ g_out,
    float* __restrict__ dpacked) {
  __shared__ Smem sm;
  const int row0 = blockIdx.x * tps;
  const int rows = min(tps, num_rows - row0);
  for (int j = 0; j < rows; ++j) {
    if (j > 0) __syncthreads();  // the previous row's shared data is consumed
    bwd_tile(packed, e_pad, tile_start, tile_count, tile_ids, tiles_x, row0 + j, fwd, g_out, dpacked, sm);
  }
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
    const int blocks = (num_rows + tps - 1) / tps;
    tile_blend_v3_bwd_kernel<<<blocks, NT, 0, (cudaStream_t)stream>>>(
        (const float*)packed, e_pad, (const int32_t*)tile_start,
        (const int32_t*)tile_count, (const int32_t*)tile_ids, tiles_x,
        num_rows, tps, (const float*)fwd, (const float*)g_out,
        (float*)dpacked);
  }
  return (int)cudaGetLastError();
}
