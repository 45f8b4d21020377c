// The ray-sphere test of the render step in one launch, in two modes: the
// closest hit of extend (render.py:sphere_pass, the t_init of traverse.cu's
// closest hit) and the any hit of connect (render.py:_connect, OR-ed into
// the traversal's occluded flags).  The plain version is ops/intersect.py
// (intersect_spheres, any_hit_spheres), which every CPU tensor takes.
//
// Replaces: no TPU kernel.  The JAX package tests every ray against the
// sphere list as an [N, S] broadcast that XLA fuses into one loop; the
// port's plain version runs it eagerly, some twenty launches over [N, S, 3]
// and [N, S] temporaries (two sums over a dimension of 3, then a min or an
// any over the spheres and the wheres around it), each written to device
// memory for the next to read: about 1.7 ms a stage at 2,097,152 rays
// against 7 spheres on an H100.
//
// What bounds it on an H100: memory bandwidth.  The closest hit reads a
// ray's origin and direction (24 bytes) and writes t and the sphere id (8):
// 67 MB at 2,097,152 rays, 0.020 ms at 3.35 TB/s.  The any hit reads the
// valid and occluded flags and writes the result (3 bytes a slot), plus
// the ray and its max distance (28 bytes) on a valid slot the traversal left
// unoccluded.  About 20 float operations a ray-sphere pair: 0.3 GFLOP a
// test at 7 spheres, under 5 us of float32.
//
// What the design does about it: one thread a ray, every temporary in
// registers.  The sphere rows (centre, radius squared) are staged in shared
// memory a tile of BLOCK rows at a time, so each block reads them once and
// any number of spheres fits.  The any hit leaves an invalid or already
// occluded slot after its flags and stops at the first occluding sphere.
//
// Exactness: the plain version's float32 operations in its order on the
// card, built with --fmad=false: op = centre - origin, b and op.op as
// PyTorch's sum over a last dimension of 3 (shade_common.cuh:dot), disc =
// (b*b - op.op) + r*r, sqrt of disc clamped at 0 (NaN passing), the near
// root if > eps, else the far root if > eps, else 0, and 0 where disc < 0.
// The closest hit keeps the first of equal distances, as torch.min does,
// so t and the id are bit for bit the plain version's.  The ground
// sphere's radius of 1e4 cancels at 1e8 in disc, so any other order moves
// its roots.
#include "shade_common.cuh"

namespace {

constexpr int TILE = BLOCK;  // sphere rows staged in shared memory a pass

// ops/intersect.py:ray_sphere for one ray and one sphere (s.w: the radius
// squared): the near root > eps, else the far root > eps, else 0
__device__ __forceinline__ float ray_sphere(V3 o, V3 d, float4 s, float eps) {
  const V3 op = v3(s.x - o.x, s.y - o.y, s.z - o.z);
  const float b = dot(op, d);
  const float disc = (b * b - dot(op, op)) + s.w;
  const float sq = sqrtf(clamp_min(disc, 0.0f));
  const float t_near = b - sq, t_far = b + sq;
  const float t = t_near > eps ? t_near : (t_far > eps ? t_far : 0.0f);
  return disc < 0.0f ? 0.0f : t;
}

// ANY false: t [n] and id [n], the closest sphere hit (the first of equal
// distances), very_far and -1 on a miss.  ANY true: occluded_out [n], the
// traversal's occluded flag OR a sphere at 0 < t with t + eps < max_dist
// on a valid slot.
template <bool ANY>
__global__ void __launch_bounds__(BLOCK)
spheres_kernel(const float* __restrict__ origin,
               const float* __restrict__ direction,
               const float* __restrict__ center,
               const float* __restrict__ radius, int n_spheres, int n,
               float eps, float very_far, const uint8_t* __restrict__ valid,
               const float* __restrict__ max_dist,
               const uint8_t* __restrict__ occluded_in,
               float* __restrict__ t_out, int* __restrict__ id_out,
               uint8_t* __restrict__ occluded_out) {
  __shared__ float4 rows[TILE];
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  bool testing = i < n;
  bool occluded = false;
  float maxd = 0.0f;
  if (ANY && testing) {
    occluded = occluded_in[i] != 0;
    testing = !occluded && valid[i] != 0;
    if (testing) {
      maxd = max_dist[i];
      testing = maxd > 0.0f;  // no sphere lies closer than 0 (or NaN)
    }
  }
  V3 o = v3(0.0f, 0.0f, 0.0f), d = o;
  if (testing) {
    const size_t r = 3 * static_cast<size_t>(i);
    o = v3(origin[r], origin[r + 1], origin[r + 2]);
    d = v3(direction[r], direction[r + 1], direction[r + 2]);
  }
  float best = INFINITY;  // torch.min over the spheres' t, VERY_FAR a miss
  int best_id = -1;
  for (int base = 0; base < n_spheres; base += TILE) {
    const int m = min(TILE, n_spheres - base);
    if (base > 0) __syncthreads();  // the last tile's rows are read
    if (threadIdx.x < m) {
      const int s = base + threadIdx.x;
      const float rad = radius[s];
      rows[threadIdx.x] = make_float4(center[3 * s], center[3 * s + 1],
                                      center[3 * s + 2], rad * rad);
    }
    __syncthreads();
    if (!testing) continue;
    for (int k = 0; k < m; ++k) {
      const float t = ray_sphere(o, d, rows[k], eps);
      if (ANY) {
        if (t > 0.0f && t + eps < maxd) {
          occluded = true;
          testing = false;
          break;
        }
      } else {
        const float v = t > 0.0f ? t : very_far;
        if (v < best) {
          best = v;
          best_id = base + k;
        }
      }
    }
  }
  if (i >= n) return;
  if (ANY) {
    occluded_out[i] = occluded;
  } else {
    t_out[i] = best;
    id_out[i] = best < very_far ? best_id : -1;
  }
}

int grid_of(int n) { return (n + BLOCK - 1) / BLOCK; }

}  // namespace

// The closest sphere hit of n rays (origin, direction [n, 3]) against
// n_spheres > 0 spheres (center [n_spheres, 3], radius [n_spheres]): t [n]
// and id [n], very_far and -1 on a miss.
extern "C" int tyrant_spheres_closest(const float* origin,
                                      const float* direction,
                                      const float* center,
                                      const float* radius, int n_spheres,
                                      int n, float eps, float very_far,
                                      float* t, int* id, void* stream) {
  if (n_spheres <= 0) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  spheres_kernel<false>
      <<<grid_of(n), BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
          origin, direction, center, radius, n_spheres, n, eps, very_far,
          nullptr, nullptr, nullptr, t, id, nullptr);
  return (int)cudaGetLastError();
}

// The shadow rays' occlusion: occluded_out [n] = occluded_in [n] OR, on a
// valid slot, a sphere at 0 < t with t + eps < max_dist [n].
extern "C" int tyrant_spheres_any(const float* origin, const float* direction,
                                  const float* center, const float* radius,
                                  int n_spheres, int n, float eps,
                                  const uint8_t* valid, const float* max_dist,
                                  const uint8_t* occluded_in,
                                  uint8_t* occluded_out, void* stream) {
  if (n_spheres <= 0) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  spheres_kernel<true>
      <<<grid_of(n), BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
          origin, direction, center, radius, n_spheres, n, eps, 0.0f, valid,
          max_dist, occluded_in, nullptr, nullptr, occluded_out);
  return (int)cudaGetLastError();
}
