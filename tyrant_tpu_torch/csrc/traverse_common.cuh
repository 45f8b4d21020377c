// Arithmetic shared by the traversal kernels (traverse.cu, one ray per
// thread; traverse_wave.cu, one 32-ray packet per warp; stream.cu, one
// (ray, row) pair per thread, level by level), so they round identically:
// the fat-row layout, the ray set-up, the slab test and Möller-Trumbore.  Built with --fmad=false so a*b+c rounds as two
// operations, as in the eager PyTorch plain version.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tyrant {

constexpr int STACK_DEPTH = 128;
constexpr int ROW = 128;  // f32 lanes a fat row
constexpr int LEAF_WIDTH = 6;
constexpr int L_TAG = 12, R_TAG = 13, L_REF = 14, R_REF = 15, AXIS = 16;
constexpr int L_TRI = 17, R_TRI = L_TRI + 9 * LEAF_WIDTH;
constexpr float EPS = 1e-3f;

// max and min that propagate NaN like jnp.maximum / torch.maximum (fmaxf
// would drop it): an origin on a slab plane gives 0 * inf = NaN there, and
// the box must then be missed exactly as in the plain version
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a) ? a : ((a > b) ? a : b);
}

__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a) ? a : ((a < b) ? a : b);
}

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
  bool nx, ny, nz;
};

__device__ __forceinline__ Ray make_ray(float ox, float oy, float oz,
                                        float dx, float dy, float dz) {
  Ray r;
  r.ox = ox;
  r.oy = oy;
  r.oz = oz;
  r.dx = dx;
  r.dy = dy;
  r.dz = dz;
  r.ix = 1.0f / dx;  // inf for a zero component
  r.iy = 1.0f / dy;
  r.iz = 1.0f / dz;
  r.nx = dx < 0.0f;
  r.ny = dy < 0.0f;
  r.nz = dz < 0.0f;
  return r;
}

// Child box test; box = lo.xyz, hi.xyz.
__device__ __forceinline__ bool slab(float lox, float loy, float loz,
                                     float hix, float hiy, float hiz,
                                     const Ray& r, float prune) {
  const float n_x = r.nx ? hix : lox, f_x = r.nx ? lox : hix;
  const float n_y = r.ny ? hiy : loy, f_y = r.ny ? loy : hiy;
  const float n_z = r.nz ? hiz : loz, f_z = r.nz ? loz : hiz;
  const float tmin = max_nan(max_nan((n_x - r.ox) * r.ix, (n_y - r.oy) * r.iy),
                             (n_z - r.oz) * r.iz);
  const float tmax = min_nan(min_nan((f_x - r.ox) * r.ix, (f_y - r.oy) * r.iy),
                             (f_z - r.oz) * r.iz);
  return (tmin <= tmax) && (tmin < prune) && (tmax > 0.0f);
}

// Möller-Trumbore against one packed triangle (v0, e1, e2), back faces
// culled by det >= 1e-7; 0 on a miss.
__device__ __forceinline__ float moller_trumbore(
    float v0x, float v0y, float v0z, float e1x, float e1y, float e1z,
    float e2x, float e2y, float e2z, const Ray& r) {
  const float px = r.dy * e2z - r.dz * e2y;
  const float py = r.dz * e2x - r.dx * e2z;
  const float pz = r.dx * e2y - r.dy * e2x;
  const float det = e1x * px + e1y * py + e1z * pz;
  const float inv_det = 1.0f / (fabsf(det) < 1e-30f ? 1.0f : det);
  const float tx = r.ox - v0x, ty = r.oy - v0y, tz = r.oz - v0z;
  const float u = (tx * px + ty * py + tz * pz) * inv_det;
  const float qx = ty * e1z - tz * e1y;
  const float qy = tz * e1x - tx * e1z;
  const float qz = tx * e1y - ty * e1x;
  const float v = (r.dx * qx + r.dy * qy + r.dz * qz) * inv_det;
  const float t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
  const bool valid = (det >= 1e-7f) && (u >= 0.0f) && (u <= 1.0f) &&
                     (v >= 0.0f) && (u + v <= 1.0f);
  return valid ? t : 0.0f;
}

// Child box test on a row in global memory; box = lo.xyz, hi.xyz.
__device__ __forceinline__ bool slab_ldg(const float* __restrict__ box,
                                         const Ray& r, float prune) {
  return slab(__ldg(box + 0), __ldg(box + 1), __ldg(box + 2), __ldg(box + 3),
              __ldg(box + 4), __ldg(box + 5), r, prune);
}

// Möller-Trumbore against one packed triangle in global memory.
__device__ __forceinline__ float mt_ldg(const float* __restrict__ tri,
                                        const Ray& r) {
  return moller_trumbore(__ldg(tri + 0), __ldg(tri + 1), __ldg(tri + 2),
                         __ldg(tri + 3), __ldg(tri + 4), __ldg(tri + 5),
                         __ldg(tri + 6), __ldg(tri + 7), __ldg(tri + 8), r);
}

}  // namespace tyrant
