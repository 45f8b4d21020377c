// BVH traversal over the fat-row table: closest hit and any hit.
//
// Replaces: tyrant_tpu/ops/pallas/traverse_kernel.py::_traverse_kernel
// (with _traverse_group, _visit and _mt_packet), the mono packet kernel
// behind closest_hit_packets / any_hit_packets.
//
// What bounds it on an H100: memory latency.  Each visit reads scattered
// lanes of one 512-byte row (two child boxes, tags, refs, split axis, and
// for leaf children up to 6 triangles of 9 floats), and the next row's
// address depends on this visit's result.  A 1M-triangle table is about
// 129 MB, more than the 50 MB L2, so deep visits miss to HBM.  Arithmetic
// per visit is small (two slab tests, at most 12 Möller-Trumbore tests).
//
// What the design does about it: the TPU kernel walks one 1024-ray packet
// per scalar-core stack because its vector unit cannot gather per lane.
// A GPU thread can, so here each thread walks its own ray with its own
// stack (STACK_DEPTH rows, in local memory) and visits only the nodes its
// ray needs, near child first by the row's split axis and the ray's own
// direction sign.  Latency is hidden by occupancy: many rays in flight per
// SM, each with an independent chain of row reads through the read-only
// cache.  Warp-cooperative packets, the counterpart of the wave kernel,
// are traverse_wave.cu; treelet staging in shared memory is later work.
//
// Semantics follow the Pallas kernel: closest accepts t > EPS and
// (t_best - t) > EPS slot by slot; any hit accepts (max_dist - t) > EPS and
// stops at the first one; rays with max_dist <= 2 EPS are done at once;
// back faces are culled by det >= 1e-7.  Slab distances are (b - o) * inv
// with inv = 1/d (inf for a zero component); the NaN-propagating max and
// min, the slab test and Möller-Trumbore are in traverse_common.cuh, shared
// with the wave kernel.  Built with --fmad=false so a*b+c rounds as two
// operations, as in eager PyTorch.
#include "traverse_common.cuh"

namespace {

using namespace tyrant;

// One leaf child: `tag` triangles starting at global prim offset `ref`.
// closest: updates t_best / hit; any hit: sets hit = 1 on the first accept.
template <bool CLOSEST>
__device__ __forceinline__ void leaf(const float* __restrict__ tris, int tag,
                                     int ref, const Ray& r, float limit,
                                     float& t_best, int& hit) {
  for (int j = 0; j < LEAF_WIDTH; ++j) {
    if (j >= tag) break;
    const float t = mt_ldg(tris + 9 * j, r);
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

template <bool CLOSEST>
__global__ void __launch_bounds__(128)
traverse_kernel(const float* __restrict__ rows, int n_rows,
                const float* __restrict__ origin,
                const float* __restrict__ direction,
                const float* __restrict__ t_init, float* __restrict__ t_out,
                int* __restrict__ hit_out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Ray r = make_ray(origin[3 * i + 0], origin[3 * i + 1],
                         origin[3 * i + 2], direction[3 * i + 0],
                         direction[3 * i + 1], direction[3 * i + 2]);
  const float limit = t_init[i];
  float t_best = limit;
  int hit = CLOSEST ? -1 : 0;

  if (CLOSEST || limit > 2.0f * EPS) {
    int stack[STACK_DEPTH];
    int sp = 0;
    stack[0] = 0;
    while (sp >= 0) {
      const int row_id = stack[sp--];
      if (row_id < 0 || row_id >= n_rows) continue;  // never for a valid table
      const float* __restrict__ row = rows + (size_t)row_id * ROW;
      const float prune = CLOSEST ? t_best : limit;
      const bool box_l = slab_ldg(row + 0, r, prune);
      const bool box_r = slab_ldg(row + 6, r, prune);
      const int tag_l = (int)__ldg(row + L_TAG);
      const int tag_r = (int)__ldg(row + R_TAG);
      const int ref_l = (int)__ldg(row + L_REF);
      const int ref_r = (int)__ldg(row + R_REF);
      if (box_l && tag_l > 0)
        leaf<CLOSEST>(row + L_TRI, tag_l, ref_l, r, limit, t_best, hit);
      if (!CLOSEST && hit) break;
      if (box_r && tag_r > 0)
        leaf<CLOSEST>(row + R_TRI, tag_r, ref_r, r, limit, t_best, hit);
      if (!CLOSEST && hit) break;
      // interior children: push the far one first, so the near one pops next
      const int axis = (int)__ldg(row + AXIS);
      const bool near_is_r = axis == 0 ? r.nx : (axis == 1 ? r.ny : r.nz);
      const bool push_l = box_l && tag_l < 0;
      const bool push_r = box_r && tag_r < 0;
      const bool far_ok = near_is_r ? push_l : push_r;
      const bool near_ok = near_is_r ? push_r : push_l;
      if (far_ok && sp + 1 < STACK_DEPTH) stack[++sp] = near_is_r ? ref_l : ref_r;
      if (near_ok && sp + 1 < STACK_DEPTH) stack[++sp] = near_is_r ? ref_r : ref_l;
    }
  }
  t_out[i] = CLOSEST ? t_best : limit;
  hit_out[i] = hit;
}

}  // namespace

// rows [n_rows, 128] f32; origin, direction [n, 3] f32; t_init [n] f32
// (closest: initial best distance; any hit: max distance).  Writes t_out
// [n] f32 and hit_out [n] i32 (closest: leaf-order triangle id or -1; any
// hit: 0/1).  Launches on `stream`; returns cudaGetLastError().
extern "C" int tyrant_traverse(const float* rows, int n_rows,
                               const float* origin, const float* direction,
                               const float* t_init, float* t_out, int* hit_out,
                               int n, int closest, void* stream) {
  if (n <= 0) return 0;
  const int block = 128;
  const int grid = (n + block - 1) / block;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (closest)
    traverse_kernel<true><<<grid, block, 0, s>>>(rows, n_rows, origin,
                                                 direction, t_init, t_out,
                                                 hit_out, n);
  else
    traverse_kernel<false><<<grid, block, 0, s>>>(rows, n_rows, origin,
                                                  direction, t_init, t_out,
                                                  hit_out, n);
  return (int)cudaGetLastError();
}
