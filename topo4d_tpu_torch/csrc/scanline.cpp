// Scanline z-buffer triangle rasterizer on the host, the C++ tier of
// topo4d_tpu_torch.mesh3d (bound through ctypes by mesh3d/scanline.py,
// built at first use by native.py with the host C++ compiler).
//
// A copy of the JAX package's native/scanline.cpp with the same C ABI and
// the same arithmetic: per-triangle inner-bbox scan, barycentric inside
// test with an inclusive far edge, bigger-z-wins depth (the first triangle
// keeps a tie), barycentric interpolation in double precision. It is the
// contract of the pure-NumPy tier (mesh3d/mesh_numpy.py), whose loop it
// runs in C++.
//
// Exposed C ABI:
//   render_colors(verts, n_verts, tris, n_tris, colors, channels, h, w, out)
//   rasterize_triangles(verts, n_verts, tris, n_tris, h, w,
//                       depth_out, tri_out, bary_out)
//   render_texture(verts, n_verts, tris, n_tris, tex, tex_h, tex_w,
//                  channels, tex_coords, tex_tris, h, w, bilinear, out)
//   vertex_normals(verts, n_verts, tris, n_tris, out)

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

struct Bary {
  double w0, w1, w2;
};

// Barycentric weights of point p against triangle (a, b, c); the oracle's
// dot-product Cramer formulation (weights may fall outside [0,1]).
inline Bary barycentric(double px, double py, const double* a,
                        const double* b, const double* c) {
  const double v0x = c[0] - a[0], v0y = c[1] - a[1];
  const double v1x = b[0] - a[0], v1y = b[1] - a[1];
  const double v2x = px - a[0], v2y = py - a[1];
  const double dot00 = v0x * v0x + v0y * v0y;
  const double dot01 = v0x * v1x + v0y * v1y;
  const double dot02 = v0x * v2x + v0y * v2y;
  const double dot11 = v1x * v1x + v1y * v1y;
  const double dot12 = v1x * v2x + v1y * v2y;
  const double denom = dot00 * dot11 - dot01 * dot01;
  const double inv = denom == 0.0 ? 0.0 : 1.0 / denom;
  const double u = (dot11 * dot02 - dot01 * dot12) * inv;
  const double v = (dot00 * dot12 - dot01 * dot02) * inv;
  return Bary{1.0 - u - v, v, u};
}

inline bool inside(const Bary& bw) {
  // A documented deviation from the reference's isPointInTri
  // (face3d mesh_core.cpp:49: u >= 0, v >= 0, u + v < 1): the far edge is
  // inclusive here. A strict test makes exact-shared-edge pixels a
  // mixed-precision knife edge (a float32 bake and a float64 oracle
  // disagree on u+v == 1); inclusive keeps all implementations
  // self-consistent, filling first-triangle color on exact edges where
  // the reference leaves background (a <=1px boundary difference).
  return bw.w2 >= 0.0 && bw.w1 >= 0.0 && bw.w1 + bw.w2 <= 1.0;
}

}  // namespace

extern "C" {

void render_colors(const float* verts, int n_verts, const int* tris,
                   int n_tris, const float* colors, int channels, int h,
                   int w, float* out /* h*w*channels, caller-zeroed */) {
  (void)n_verts;
  double* depth = new double[(size_t)h * w];
  std::fill(depth, depth + (size_t)h * w, -999999.0);

  for (int i = 0; i < n_tris; ++i) {
    const int i0 = tris[i * 3 + 0];
    const int i1 = tris[i * 3 + 1];
    const int i2 = tris[i * 3 + 2];
    const double p0[3] = {verts[i0 * 3], verts[i0 * 3 + 1], verts[i0 * 3 + 2]};
    const double p1[3] = {verts[i1 * 3], verts[i1 * 3 + 1], verts[i1 * 3 + 2]};
    const double p2[3] = {verts[i2 * 3], verts[i2 * 3 + 1], verts[i2 * 3 + 2]};

    int umin = std::max((int)std::ceil(std::min({p0[0], p1[0], p2[0]})), 0);
    int umax = std::min((int)std::floor(std::max({p0[0], p1[0], p2[0]})), w - 1);
    int vmin = std::max((int)std::ceil(std::min({p0[1], p1[1], p2[1]})), 0);
    int vmax = std::min((int)std::floor(std::max({p0[1], p1[1], p2[1]})), h - 1);
    if (umax < umin || vmax < vmin) continue;

    for (int u = umin; u <= umax; ++u) {
      for (int v = vmin; v <= vmax; ++v) {
        const Bary bw = barycentric((double)u, (double)v, p0, p1, p2);
        if (!inside(bw)) continue;
        const double z = bw.w0 * p0[2] + bw.w1 * p1[2] + bw.w2 * p2[2];
        double* d = &depth[(size_t)v * w + u];
        if (z > *d) {
          *d = z;
          float* px = &out[((size_t)v * w + u) * channels];
          for (int c = 0; c < channels; ++c) {
            px[c] = (float)(bw.w0 * colors[i0 * channels + c] +
                            bw.w1 * colors[i1 * channels + c] +
                            bw.w2 * colors[i2 * channels + c]);
          }
        }
      }
    }
  }
  delete[] depth;
}

void rasterize_triangles(const float* verts, int n_verts, const int* tris,
                         int n_tris, int h, int w, float* depth_out,
                         int* tri_out, float* bary_out) {
  (void)n_verts;
  for (size_t i = 0; i < (size_t)h * w; ++i) {
    depth_out[i] = -999999.0f;
    tri_out[i] = -1;
  }
  std::memset(bary_out, 0, (size_t)h * w * 3 * sizeof(float));

  for (int i = 0; i < n_tris; ++i) {
    const int i0 = tris[i * 3 + 0];
    const int i1 = tris[i * 3 + 1];
    const int i2 = tris[i * 3 + 2];
    const double p0[3] = {verts[i0 * 3], verts[i0 * 3 + 1], verts[i0 * 3 + 2]};
    const double p1[3] = {verts[i1 * 3], verts[i1 * 3 + 1], verts[i1 * 3 + 2]};
    const double p2[3] = {verts[i2 * 3], verts[i2 * 3 + 1], verts[i2 * 3 + 2]};

    int umin = std::max((int)std::ceil(std::min({p0[0], p1[0], p2[0]})), 0);
    int umax = std::min((int)std::floor(std::max({p0[0], p1[0], p2[0]})), w - 1);
    int vmin = std::max((int)std::ceil(std::min({p0[1], p1[1], p2[1]})), 0);
    int vmax = std::min((int)std::floor(std::max({p0[1], p1[1], p2[1]})), h - 1);
    if (umax < umin || vmax < vmin) continue;

    for (int u = umin; u <= umax; ++u) {
      for (int v = vmin; v <= vmax; ++v) {
        const Bary bw = barycentric((double)u, (double)v, p0, p1, p2);
        if (!inside(bw)) continue;
        const double z = bw.w0 * p0[2] + bw.w1 * p1[2] + bw.w2 * p2[2];
        const size_t idx = (size_t)v * w + u;
        if (z > depth_out[idx]) {
          depth_out[idx] = (float)z;
          tri_out[idx] = i;
          bary_out[idx * 3 + 0] = (float)bw.w0;
          bary_out[idx * 3 + 1] = (float)bw.w1;
          bary_out[idx * 3 + 2] = (float)bw.w2;
        }
      }
    }
  }
}

void render_texture(const float* verts, int n_verts, const int* tris,
                    int n_tris, const float* tex, int tex_h, int tex_w,
                    int channels, const float* tex_coords,
                    const int* tex_tris, int h, int w, int bilinear,
                    float* out /* h*w*channels, caller-zeroed */) {
  // Texture-mapped z-buffer render (the reference's _render_texture_core,
  // mesh_core.cpp:237-336): pixel color sampled from `tex` at the
  // barycentric interpolation of the visible triangle's UV-pixel coords.
  // Deviation (documented): the reference mixes mesh- and texture-triangle
  // indices when reading tex_coords y (mesh_core.cpp:273-275); here
  // tex_coords is indexed by tex_tris consistently.
  (void)n_verts;
  double* depth = new double[(size_t)h * w];
  std::fill(depth, depth + (size_t)h * w, -999999.0);

  for (int i = 0; i < n_tris; ++i) {
    const int i0 = tris[i * 3 + 0];
    const int i1 = tris[i * 3 + 1];
    const int i2 = tris[i * 3 + 2];
    const double p0[3] = {verts[i0 * 3], verts[i0 * 3 + 1], verts[i0 * 3 + 2]};
    const double p1[3] = {verts[i1 * 3], verts[i1 * 3 + 1], verts[i1 * 3 + 2]};
    const double p2[3] = {verts[i2 * 3], verts[i2 * 3 + 1], verts[i2 * 3 + 2]};
    const int t0 = tex_tris[i * 3 + 0];
    const int t1 = tex_tris[i * 3 + 1];
    const int t2 = tex_tris[i * 3 + 2];

    int umin = std::max((int)std::ceil(std::min({p0[0], p1[0], p2[0]})), 0);
    int umax = std::min((int)std::floor(std::max({p0[0], p1[0], p2[0]})), w - 1);
    int vmin = std::max((int)std::ceil(std::min({p0[1], p1[1], p2[1]})), 0);
    int vmax = std::min((int)std::floor(std::max({p0[1], p1[1], p2[1]})), h - 1);
    if (umax < umin || vmax < vmin) continue;

    for (int u = umin; u <= umax; ++u) {
      for (int v = vmin; v <= vmax; ++v) {
        const Bary bw = barycentric((double)u, (double)v, p0, p1, p2);
        if (!inside(bw)) continue;
        const double z = bw.w0 * p0[2] + bw.w1 * p1[2] + bw.w2 * p2[2];
        double* d = &depth[(size_t)v * w + u];
        if (z <= *d) continue;
        *d = z;
        double tx = bw.w0 * tex_coords[t0 * 2] + bw.w1 * tex_coords[t1 * 2] +
                    bw.w2 * tex_coords[t2 * 2];
        double ty = bw.w0 * tex_coords[t0 * 2 + 1] +
                    bw.w1 * tex_coords[t1 * 2 + 1] +
                    bw.w2 * tex_coords[t2 * 2 + 1];
        tx = std::max(std::min(tx, (double)(tex_w - 1)), 0.0);
        ty = std::max(std::min(ty, (double)(tex_h - 1)), 0.0);
        float* px = &out[((size_t)v * w + u) * channels];
        if (!bilinear) {
          const int sx = (int)std::lround(tx);
          const int sy = (int)std::lround(ty);
          const float* t = &tex[((size_t)sy * tex_w + sx) * channels];
          for (int c = 0; c < channels; ++c) px[c] = t[c];
        } else {
          const int x0 = (int)std::floor(tx), x1 = (int)std::ceil(tx);
          const int y0 = (int)std::floor(ty), y1 = (int)std::ceil(ty);
          const double fx = tx - x0, fy = ty - y0;
          const float* ul = &tex[((size_t)y0 * tex_w + x0) * channels];
          const float* ur = &tex[((size_t)y0 * tex_w + x1) * channels];
          const float* dl = &tex[((size_t)y1 * tex_w + x0) * channels];
          const float* dr = &tex[((size_t)y1 * tex_w + x1) * channels];
          for (int c = 0; c < channels; ++c) {
            px[c] = (float)(ul[c] * (1 - fx) * (1 - fy) +
                            ur[c] * fx * (1 - fy) + dl[c] * (1 - fx) * fy +
                            dr[c] * fx * fy);
          }
        }
      }
    }
  }
  delete[] depth;
}

void vertex_normals(const float* verts, int n_verts, const int* tris,
                    int n_tris, float* out /* n_verts*3, caller-zeroed */) {
  for (int i = 0; i < n_tris; ++i) {
    const int i0 = tris[i * 3 + 0];
    const int i1 = tris[i * 3 + 1];
    const int i2 = tris[i * 3 + 2];
    double e1[3], e2[3];
    for (int c = 0; c < 3; ++c) {
      e1[c] = (double)verts[i1 * 3 + c] - verts[i0 * 3 + c];
      e2[c] = (double)verts[i2 * 3 + c] - verts[i0 * 3 + c];
    }
    const double nx = e1[1] * e2[2] - e1[2] * e2[1];
    const double ny = e1[2] * e2[0] - e1[0] * e2[2];
    const double nz = e1[0] * e2[1] - e1[1] * e2[0];
    for (int vi : {i0, i1, i2}) {
      out[vi * 3 + 0] += (float)nx;
      out[vi * 3 + 1] += (float)ny;
      out[vi * 3 + 2] += (float)nz;
    }
  }
  for (int i = 0; i < n_verts; ++i) {
    const double n0 = out[i * 3], n1 = out[i * 3 + 1], n2 = out[i * 3 + 2];
    const double norm = std::sqrt(n0 * n0 + n1 * n1 + n2 * n2);
    if (norm > 1e-12) {
      out[i * 3 + 0] = (float)(n0 / norm);
      out[i * 3 + 1] = (float)(n1 / norm);
      out[i * 3 + 2] = (float)(n2 / norm);
    }
  }
}

}  // extern "C"
