// Arithmetic shared by the traversal kernels (traverse.cu, one ray per
// lane; traverse_wave.cu, one 32-ray packet per warp; stream.cu, one
// (ray, row) pair per thread, level by level), so they round identically:
// the ray set-up, the slab test and Möller-Trumbore.  Built with
// --fmad=false so a*b+c rounds as two operations, as in the eager PyTorch
// plain version.
//
// All three read the table ops/kernels/traverse.py:build_kernel_tables
// makes from the fat rows for 16-byte vector loads: a 64-byte node record
// (Node, four ld.global.nc.v4) and 48-byte triangle records at their
// leaf-order prim offset (three loads each); compact_live is the live-slot
// compaction of traverse.cu's any-hit queues.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tyrant {

constexpr int STACK_DEPTH = 128;
constexpr int LEAF_WIDTH = 6;
constexpr float EPS = 1e-3f;
constexpr unsigned FULL = 0xffffffffu;

// max and min that propagate NaN like jnp.maximum / torch.maximum (fmaxf
// would drop it): an origin on a slab plane gives 0 * inf = NaN there, and
// the box must then be missed exactly as in the plain version.  One
// instruction each (max.NaN / min.NaN); only compares read the result, so
// neither the NaN's payload nor a zero's sign can show.
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
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

// One row of the kernel-side node table: 16 words, 64-byte aligned.
struct Node {
  float4 a, b, c;  // left box lo.xyz hi.x | hi.yz, right lo.xy | lo.z hi.xyz
  int4 m;          // tags and axis packed, left ref, right ref, 0
};

__device__ __forceinline__ Node load_node(const float4* __restrict__ nodes,
                                          int row_id) {
  const float4* __restrict__ p = nodes + 4 * (size_t)row_id;
  Node nd;
  nd.a = __ldg(p);
  nd.b = __ldg(p + 1);
  nd.c = __ldg(p + 2);
  nd.m = __ldg(reinterpret_cast<const int4*>(p + 3));
  return nd;
}

__device__ __forceinline__ bool box_left(const Node& nd, const Ray& r,
                                         float prune) {
  return slab(nd.a.x, nd.a.y, nd.a.z, nd.a.w, nd.b.x, nd.b.y, r, prune);
}

__device__ __forceinline__ bool box_right(const Node& nd, const Ray& r,
                                          float prune) {
  return slab(nd.b.z, nd.b.w, nd.c.x, nd.c.y, nd.c.z, nd.c.w, r, prune);
}

// tags: > 0 leaf prim count, < 0 interior, 0 empty
__device__ __forceinline__ int tag_left(const Node& nd) {
  return (int)(signed char)(nd.m.x & 0xff);
}

__device__ __forceinline__ int tag_right(const Node& nd) {
  return (int)(signed char)((nd.m.x >> 8) & 0xff);
}

__device__ __forceinline__ int split_axis(const Node& nd) {
  return (nd.m.x >> 16) & 3;
}

// One leaf child: `tag` triangle records from prim offset `ref`, in order.
// closest: updates t_best / hit; any hit: sets hit = 1 on the first accept.
template <bool CLOSEST>
__device__ __forceinline__ void leaf(const float4* __restrict__ tris, int tag,
                                     int ref, const Ray& r, float limit,
                                     float& t_best, int& hit) {
  const float4* __restrict__ p = tris + 3 * (size_t)ref;
  for (int j = 0; j < LEAF_WIDTH; ++j) {
    if (j >= tag) break;
    const float4 u = __ldg(p + 3 * j);
    const float4 v = __ldg(p + 3 * j + 1);
    const float4 w = __ldg(p + 3 * j + 2);
    const float t = moller_trumbore(u.x, u.y, u.z, u.w, v.x, v.y, v.z, v.w,
                                    w.x, r);
    if (CLOSEST) {
      if (t > EPS && (t_best - t) > EPS) {
        t_best = t;
        hit = ref + j;
      }
    } else if (t > EPS && (limit - t) > EPS) {
      hit = 1;
      return;
    }
  }
}

// The hit triangle's unnormalised geometric normal cross(e1, e2), read
// once from its 48-byte record after the walk (e1 = u.w v.x v.y, e2 = v.z
// v.w w.x), or zero without a hit; each component rounds as two products
// and a difference, like ops/traverse.py:hit_normals.
__device__ __forceinline__ void store_normal(const float4* __restrict__ tris,
                                             int hit,
                                             float* __restrict__ nrm_out,
                                             int slot) {
  float nx = 0.0f, ny = 0.0f, nz = 0.0f;
  if (hit >= 0) {
    const float4* __restrict__ p = tris + 3 * (size_t)hit;
    const float4 u = __ldg(p);
    const float4 v = __ldg(p + 1);
    const float4 w = __ldg(p + 2);
    nx = v.x * w.x - v.y * v.w;
    ny = v.y * v.z - u.w * w.x;
    nz = u.w * v.w - v.x * v.z;
  }
  nrm_out[3 * slot + 0] = nx;
  nrm_out[3 * slot + 1] = ny;
  nrm_out[3 * slot + 2] = nz;
}

// Live-slot compaction of an any-hit queue: the block's tile of TILE slots
// from `base`.  Reads only the max distances.  Every slot's result is
// written here, coalesced (t_out = its max distance, flag 0; a walk that
// finds an occluder sets the flag later), so a slot that cannot be occluded
// (max distance <= 2 EPS) is done without its origin and direction being
// touched.  The others' indices are packed into `list` (TILE ints of shared
// memory), one ballot and one shared-memory atomicAdd a warp and round.
// Returns the number packed, to every thread; ends with a __syncthreads.
template <int THREADS, int TILE>
__device__ __forceinline__ int compact_live(const float* __restrict__ t_init,
                                            float* __restrict__ t_out,
                                            int* __restrict__ hit_out,
                                            int base, int n, int* list,
                                            int* s_count) {
  static_assert(TILE % THREADS == 0, "every lane must reach the ballots");
  if (threadIdx.x == 0) *s_count = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
#pragma unroll 4
  for (int k = threadIdx.x; k < TILE; k += THREADS) {
    const int i = base + k;
    bool live = false;
    if (i < n) {
      const float limit = t_init[i];
      t_out[i] = limit;
      hit_out[i] = 0;
      live = limit > 2.0f * EPS;
    }
    const unsigned m = __ballot_sync(FULL, live);
    if (m) {
      int off = 0;
      if (lane == 0) off = atomicAdd(s_count, __popc(m));
      off = __shfl_sync(FULL, off, 0);
      if (live) list[off + __popc(m & ((1u << lane) - 1u))] = i;
    }
  }
  __syncthreads();
  return *s_count;
}

}  // namespace tyrant
