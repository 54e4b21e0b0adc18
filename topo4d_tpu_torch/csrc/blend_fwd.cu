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
// stopped, and write the (T, 8, 256) output once; the arithmetic is 16 FP32
// operations per (pixel, entry) pair a pixel evaluates and 11 more per
// contributing pair. At the 4K dense view (10,567 occupied tiles of 18,432
// compact rows, 2.24M entries) the operations bound it, 0.079 ms at 67
// TFLOP/s; at the head-scale geometry view (768 tiles, ~21k entries) the
// bytes, ~2 us at 3.35 TB/s. What bounds this kernel is instruction issue
// and latency: each pixel's blend is a dependent chain over its entries.
// Measured (chip_smoke.py's K1 timing with --ref, NVIDIA H100 80GB HBM3,
// 700.00 W; PERF.md section 6 has every run): 0.454 ms at a 4K compact view
// against 0.781 ms for the first design (one thread per pixel) in the same
// call, 0.0174 against 0.0315 ms at the geometry view. Without the cull
// 0.490 ms, with the cull tested entry by entry 0.507 ms, without the early
// cut 0.477 ms, without the overlapped staging 0.462 ms. -Xptxas -v: 56
// registers, 12,800 bytes of static shared memory, no spills.
//
// Design: csrc/blend_fwd_tile.cuh, the per-tile body that K1 shares with
// K4f (csrc/blend_v3_fwd.cu), and the proof that its bounding-box cull is
// conservative. K1 runs the body on one row per block. Each pixel's
// operations are those of the sequential loop in the contract, in the same
// order. Rows 0-5 equal K4f's by construction, so that equality is no check
// of the body: the forward check against the plain version and chip_smoke.py
// --ref against an earlier source are.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false.
// --fmad=false keeps every product and sum rounded on its own, in the same
// order as the plain PyTorch version, so skip and termination decisions
// match it bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "blend_fwd_tile.cuh"

namespace {

using namespace blend_fwd;

__global__ void __launch_bounds__(NT, MIN_BLOCKS) tile_blend_fwd_kernel(
    const float* __restrict__ packed, int64_t e_pad,
    const int32_t* __restrict__ tile_start,
    const int32_t* __restrict__ tile_count,
    const int32_t* __restrict__ tile_ids, int tiles_x,
    float* __restrict__ out) {
  __shared__ Smem sm;
  fwd_tile(packed, e_pad, tile_start, tile_count, tile_ids, tiles_x, blockIdx.x, out, sm);
}

}  // namespace

// Launches K1 over ``num_rows`` output rows on ``stream`` (``tile_ids``
// null: row r is tile r); returns cudaGetLastError() (0 = launched).
extern "C" int tile_blend_fwd(const void* packed, int64_t e_pad,
                              const void* tile_start, const void* tile_count,
                              const void* tile_ids, int tiles_x, int num_rows,
                              void* out, void* stream) {
  if (num_rows > 0) {
    tile_blend_fwd_kernel<<<num_rows, NT, 0, (cudaStream_t)stream>>>(
        (const float*)packed, e_pad, (const int32_t*)tile_start,
        (const int32_t*)tile_count, (const int32_t*)tile_ids, tiles_x,
        (float*)out);
  }
  return (int)cudaGetLastError();
}
