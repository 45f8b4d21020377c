// BVH traversal, one ray per lane: closest hit and any hit.
//
// Replaces: tyrant_tpu/ops/pallas/traverse_kernel.py::_traverse_kernel
// (with _traverse_group, _visit and _mt_packet), the mono packet kernel
// behind closest_hit_packets / any_hit_packets.
//
// What bounds it on an H100 (chip_smoke.py on the 1M-triangle terrain;
// PERF.md has the numbers): not the bytes (a 2M-ray queue moves
// 30-90 MB, 0.01-0.03 ms of HBM time), but the chain of dependent visits of
// the rays that walk longest and the lanes that wait for them.  A visit's
// row address comes out of the visit before it; a live ray of the extend
// queue reads 5 rows on average and 130 at most, so a warp lasts as long
// as its longest ray (52% of the lane-trips are useful); a bounced ray
// reads its own rows (32 separate accesses a load); nine in ten shadow
// slots are dead (max distance <= 2 EPS).  The time follows the rays one
// lane walks in sequence: giving a lane a second ray, whether by larger
// tiles or by refilling the lanes that finished early from a block-wide
// list, made every queue slower, so a lane walks one ray and the
// hardware's block scheduler does the balancing.
//
// What the design does about it:
//  - The kernel-side table (ops/kernels/traverse.py:build_kernel_tables):
//    a visit reads its node as four 16-byte loads of one 64-byte line, not
//    17 scalar loads of a 512-byte row, a triangle as three, and tags,
//    refs and axis are integers.  The node part of a 1M-triangle table is
//    16 MB and stays in the 50 MB L2.
//  - Any-hit queues are compacted first (compact_live, traverse_common.cuh):
//    a block takes a tile of TILE slots, reads only the max distances,
//    finishes the dead slots at once and packs the live ones, so the
//    block's first lanes walk a dense set of live rays and a dead slot's
//    origin and direction are never read.  Closest-hit queues are all live
//    and skip this.
//  - The NaN-propagating max and min of the slab test are one instruction
//    each (max.NaN / min.NaN).
//  - The stack stays in local memory, which L1 holds and where the lanes'
//    entries interleave; its first 8 entries in shared memory, one column a
//    thread, measured 4-5% slower (PERF.md).  The launch bounds hold the
//    kernel to 40 registers a thread, so 12 blocks an SM are in flight.
//
// The normals output (closest hit, NORMALS): the Pallas kernel carries the
// winner's cross(e1, e2) through every leaf pass, three more floats a
// lane, because a TPU lane cannot gather after its walk.  Here three more
// loop carries would spill under the 40-register bound, so a lane that has
// finished its walk reads the winner's triangle record once and computes
// the cross there (store_normal, traverse_common.cuh): one 48-byte record
// a hit ray.  NORMALS is a template argument, so the kernel that extend,
// connect and the AOV pass run without normals keeps its registers.
//
// Semantics follow the Pallas kernel: closest accepts t > EPS and
// (t_best - t) > EPS slot by slot; any hit accepts (max_dist - t) > EPS and
// stops at the first one; rays with max_dist <= 2 EPS are done at once;
// back faces are culled by det >= 1e-7; the near child, by the row's split
// axis and the ray's own direction sign, is visited first.  Slab distances
// are (b - o) * inv with inv = 1/d (inf for a zero component); the NaN-
// propagating max and min, the slab test and Möller-Trumbore are in
// traverse_common.cuh, shared with the wave kernel.  Built with
// --fmad=false so a*b+c rounds as two operations, as in eager PyTorch.
#include "traverse_common.cuh"

namespace {

using namespace tyrant;

constexpr int THREADS = 128;
constexpr int TILE = 128;  // slots a block takes: one ray a lane

// 12 blocks an SM: 40 registers a thread, 48 warps in flight
template <bool CLOSEST, bool NORMALS>
__global__ void __launch_bounds__(THREADS, 12)
traverse_kernel(const float4* __restrict__ nodes, int n_rows,
                const float4* __restrict__ tris,
                const float* __restrict__ origin,
                const float* __restrict__ direction,
                const float* __restrict__ t_init, float* __restrict__ t_out,
                int* __restrict__ hit_out, float* __restrict__ nrm_out,
                int n) {
  static_assert(CLOSEST || !NORMALS, "normals exist for closest hit only");
  __shared__ int s_list[CLOSEST ? 1 : TILE];
  __shared__ int s_count;
  int stack[STACK_DEPTH];  // this lane's row stack, in local memory

  // the tile's rays: slots base.. (closest) or the packed live slots
  const int base = blockIdx.x * TILE;
  const int count =
      CLOSEST ? min(TILE, n - base)
              : compact_live<THREADS, TILE>(t_init, t_out, hit_out, base, n,
                                            s_list, &s_count);

  // one ray a lane, walked to its end
  static_assert(TILE == THREADS, "one ray a lane");
  const int k = threadIdx.x;
  if (k < count) {
    const int slot = CLOSEST ? base + k : s_list[k];
    const Ray r = make_ray(origin[3 * slot + 0], origin[3 * slot + 1],
                           origin[3 * slot + 2], direction[3 * slot + 0],
                           direction[3 * slot + 1], direction[3 * slot + 2]);
    const float limit = t_init[slot];
    float t_best = limit;
    int hit = CLOSEST ? -1 : 0;
    int sp = 1;  // entries on this lane's stack
    stack[0] = 0;  // the root row
    while (sp > 0) {
      const int row_id = stack[--sp];
      if (row_id < 0 || row_id >= n_rows) continue;  // never for a valid table
      const Node nd = load_node(nodes, row_id);
      const float prune = CLOSEST ? t_best : limit;
      const bool box_l = box_left(nd, r, prune);
      const bool box_r = box_right(nd, r, prune);
      const int tag_l = tag_left(nd), tag_r = tag_right(nd);
      const int ref_l = nd.m.y, ref_r = nd.m.z;
      if (box_l && tag_l > 0)
        leaf<CLOSEST>(tris, tag_l, ref_l, r, limit, t_best, hit);
      if (!CLOSEST && hit) break;
      if (box_r && tag_r > 0)
        leaf<CLOSEST>(tris, tag_r, ref_r, r, limit, t_best, hit);
      if (!CLOSEST && hit) break;
      // interior children: push the far one first, so the near one pops next
      const int axis = split_axis(nd);
      const bool near_is_r = axis == 0 ? r.nx : (axis == 1 ? r.ny : r.nz);
      const bool push_l = box_l && tag_l < 0;
      const bool push_r = box_r && tag_r < 0;
      const bool far_ok = near_is_r ? push_l : push_r;
      const bool near_ok = near_is_r ? push_r : push_l;
      if (far_ok && sp < STACK_DEPTH)
        stack[sp++] = near_is_r ? ref_l : ref_r;
      if (near_ok && sp < STACK_DEPTH)
        stack[sp++] = near_is_r ? ref_r : ref_l;
    }
    if (CLOSEST) {
      t_out[slot] = t_best;
      hit_out[slot] = hit;
      if (NORMALS) store_normal(tris, hit, nrm_out, slot);
    } else if (hit) {
      hit_out[slot] = 1;  // compact_live wrote the slot's t and a flag 0
    }
  }
}

}  // namespace

// nodes [n_rows, 16] i32, 64-byte aligned, and tris [T, 12] f32, 16-byte
// aligned: the kernel-side table (traverse_common.cuh); origin, direction
// [n, 3] f32; t_init [n] f32 (closest: initial best distance; any hit: max
// distance).  Writes t_out [n] f32 and hit_out [n] i32 (closest: leaf-order
// triangle id or -1; any hit: 0/1), and for a closest hit with a non-null
// nrm_out the hit triangle's cross(e1, e2) there ([n, 3] f32, zero on a
// miss).  Launches on `stream`; returns cudaGetLastError().
extern "C" int tyrant_traverse(const void* nodes, int n_rows, const void* tris,
                               const float* origin, const float* direction,
                               const float* t_init, float* t_out, int* hit_out,
                               float* nrm_out, int n, int closest,
                               void* stream) {
  if (n <= 0) return 0;
  const float4* nd = static_cast<const float4*>(nodes);
  const float4* tr = static_cast<const float4*>(tris);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = (n + TILE - 1) / TILE;
  if (closest && nrm_out)
    traverse_kernel<true, true><<<grid, THREADS, 0, s>>>(
        nd, n_rows, tr, origin, direction, t_init, t_out, hit_out, nrm_out,
        n);
  else if (closest)
    traverse_kernel<true, false><<<grid, THREADS, 0, s>>>(
        nd, n_rows, tr, origin, direction, t_init, t_out, hit_out, nullptr,
        n);
  else
    traverse_kernel<false, false><<<grid, THREADS, 0, s>>>(
        nd, n_rows, tr, origin, direction, t_init, t_out, hit_out, nullptr,
        n);
  return (int)cudaGetLastError();
}
