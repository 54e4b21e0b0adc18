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
// The per-tile body lives in csrc/blend_bwd_tile.cuh, which K4b
// (csrc/blend_v3_bwd.cu) runs too, so K4b's dpacked equals K2's bit for bit.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false, so the
// skip decisions recomputed here equal K1's bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "blend_bwd_tile.cuh"

namespace {

using namespace blend_bwd;

__global__ void __launch_bounds__(NT, MIN_BLOCKS) tile_blend_bwd_kernel(
    const float* __restrict__ packed, int64_t e_pad,
    const int32_t* __restrict__ tile_start,
    const int32_t* __restrict__ tile_count,
    const int32_t* __restrict__ tile_ids, int tiles_x,
    const float* __restrict__ fwd, const float* __restrict__ g_out,
    float* __restrict__ dpacked) {
  __shared__ Smem sm;
  bwd_tile(packed, e_pad, tile_start, tile_count, tile_ids, tiles_x, blockIdx.x, fwd, g_out, dpacked, sm);
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
