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
// each corner; and the M occupied tiles tile_ids[i] with their entry ranges
// [start[i], start[i] + count[i]). For each pixel centre (px, py) of an
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
// The winner's r, g, b go into the (H, W, 3) float32 canvas, which the
// caller zero-fills: a pixel that no triangle covers stays 0.
//
// Bound on an H100 SXM. At the main path's 8192^2 bake of 546,028 dense
// triangles the kernel must read each entry's ten geometry rows and three
// corner ids (52 B, ~0.1 GB for ~1.9M entries) and the corner colors, and
// write the 805 MB canvas: ~0.28 ms at 3.35 TB/s. It evaluates ~4.8e8
// (pixel, entry) pairs at ~30 FP32 operations each: ~0.2 ms at 67 TFLOP/s.
// So bytes bound it, by a small margin; the simple kernel's own limit is the
// sequential walk of each pixel over its tile's list.
//
// Design. One block of 256 threads per occupied tile, one thread per pixel.
// The block stages its range in chunks of 256 entries, one entry per thread:
// the corner x0, y0 and depths, the terms that do not depend on the pixel
// (v0, v1, dot00, dot01, dot11, inv, the four bbox bounds) and the nine
// corner colors, gathered through corner_idx. Then every thread runs the
// sequential strict-> update over the chunk from shared memory (broadcast
// reads) and, at the end, writes its pixel of the canvas. None of the TPU
// kernel's tiles-per-step batching, 1024-aligned scalar blocks or
// double-buffered DMA windows: they served the TPU's grid and VMEM.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false.
// --fmad=false keeps every product and sum rounded on its own, in the plain
// PyTorch version's order (texture/bake_tiled.py bake_canvas_plain), so the
// inclusive inside test, the depth test and the colors equal it bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 16;
constexpr int PX = TILE * TILE;
constexpr int CHUNK = PX;
constexpr float NEG = -1e30f;

__global__ void __launch_bounds__(PX) uv_bake_kernel(
    const float* __restrict__ geom, const int32_t* __restrict__ corner_idx,
    int64_t e, const float* __restrict__ colors, int ncol,
    const int32_t* __restrict__ tile_ids, const int32_t* __restrict__ start,
    const int32_t* __restrict__ count, int tiles_x, int width, int height,
    float* __restrict__ out) {
  __shared__ float s_x0[CHUNK], s_y0[CHUNK];
  __shared__ float s_z0[CHUNK], s_z1[CHUNK], s_z2[CHUNK];
  __shared__ float s_v0x[CHUNK], s_v0y[CHUNK], s_v1x[CHUNK], s_v1y[CHUNK];
  __shared__ float s_d00[CHUNK], s_d01[CHUNK], s_d11[CHUNK], s_inv[CHUNK];
  __shared__ float s_umin[CHUNK], s_umax[CHUNK], s_vmin[CHUNK], s_vmax[CHUNK];
  __shared__ float s_c[9][CHUNK];

  const int tile = tile_ids[blockIdx.x];
  const int64_t first = start[blockIdx.x];
  const int n = count[blockIdx.x];
  const int p = threadIdx.x;
  const int pxi = (tile % tiles_x) * TILE + p % TILE;
  const int pyi = (tile / tiles_x) * TILE + p / TILE;
  const bool on_canvas = pxi < width && pyi < height;
  const float px = (float)pxi;
  const float py = (float)pyi;

  float zbuf = NEG;
  float cr = 0.0f, cg = 0.0f, cb = 0.0f;
  for (int c0 = 0; c0 < n; c0 += CHUNK) {
    const int len = min(CHUNK, n - c0);
    if (p < len) {
      const int64_t k = first + c0 + p;
      const float x0 = geom[k], y0 = geom[e + k];
      const float x1 = geom[2 * e + k], y1 = geom[3 * e + k];
      const float x2 = geom[4 * e + k], y2 = geom[5 * e + k];
      const float v0x = x2 - x0, v0y = y2 - y0;
      const float v1x = x1 - x0, v1y = y1 - y0;
      const float dot00 = v0x * v0x + v0y * v0y;
      const float dot01 = v0x * v1x + v0y * v1y;
      const float dot11 = v1x * v1x + v1y * v1y;
      const float denom = dot00 * dot11 - dot01 * dot01;
      s_x0[p] = x0;
      s_y0[p] = y0;
      s_z0[p] = geom[6 * e + k];
      s_z1[p] = geom[7 * e + k];
      s_z2[p] = geom[8 * e + k];
      s_v0x[p] = v0x;
      s_v0y[p] = v0y;
      s_v1x[p] = v1x;
      s_v1y[p] = v1y;
      s_d00[p] = dot00;
      s_d01[p] = dot01;
      s_d11[p] = dot11;
      s_inv[p] = denom == 0.0f ? 0.0f : 1.0f / denom;
      s_umin[p] = ceilf(fminf(fminf(x0, x1), x2));
      s_umax[p] = floorf(fmaxf(fmaxf(x0, x1), x2));
      s_vmin[p] = ceilf(fminf(fminf(y0, y1), y2));
      s_vmax[p] = floorf(fmaxf(fmaxf(y0, y1), y2));
#pragma unroll
      for (int corner = 0; corner < 3; ++corner) {
        const float* c = colors + (int64_t)corner_idx[corner * e + k] * ncol;
        s_c[3 * corner][p] = c[0];
        s_c[3 * corner + 1][p] = c[1];
        s_c[3 * corner + 2][p] = c[2];
      }
    }
    __syncthreads();
    if (on_canvas) {
      for (int j = 0; j < len; ++j) {
        const float dpx = px - s_x0[j];
        const float dpy = py - s_y0[j];
        const float dot02 = s_v0x[j] * dpx + s_v0y[j] * dpy;
        const float dot12 = s_v1x[j] * dpx + s_v1y[j] * dpy;
        const float u = (s_d11[j] * dot02 - s_d01[j] * dot12) * s_inv[j];
        const float w1 = (s_d00[j] * dot12 - s_d01[j] * dot02) * s_inv[j];
        const float w0 = 1.0f - u - w1;
        const float depth = w0 * s_z0[j] + w1 * s_z1[j] + u * s_z2[j];
        const bool inside = u >= 0.0f && w1 >= 0.0f && w1 + u <= 1.0f &&
                            px >= s_umin[j] && px <= s_umax[j] &&
                            py >= s_vmin[j] && py <= s_vmax[j];
        if (inside && depth > zbuf) {
          zbuf = depth;
          cr = w0 * s_c[0][j] + w1 * s_c[3][j] + u * s_c[6][j];
          cg = w0 * s_c[1][j] + w1 * s_c[4][j] + u * s_c[7][j];
          cb = w0 * s_c[2][j] + w1 * s_c[5][j] + u * s_c[8][j];
        }
      }
    }
    __syncthreads();
  }
  if (on_canvas) {
    float* o = out + ((int64_t)pyi * width + pxi) * 3;
    o[0] = cr;
    o[1] = cg;
    o[2] = cb;
  }
}

}  // namespace

// Launches K6 on ``stream`` over the m occupied tiles; the caller has
// zero-filled ``out``. Returns cudaGetLastError() (0 = launched).
extern "C" int uv_bake(const void* geom, const void* corner_idx, int64_t e,
                       const void* colors, int ncol, const void* tile_ids,
                       const void* start, const void* count, int m,
                       int tiles_x, int width, int height, void* out,
                       void* stream) {
  if (m > 0) {
    uv_bake_kernel<<<m, PX, 0, (cudaStream_t)stream>>>(
        (const float*)geom, (const int32_t*)corner_idx, e,
        (const float*)colors, ncol, (const int32_t*)tile_ids,
        (const int32_t*)start, (const int32_t*)count, tiles_x, width, height,
        (float*)out);
  }
  return (int)cudaGetLastError();
}
