// BVH traversal in warp packets: closest hit and any hit, the same
// function as traverse.cu.
//
// Replaces: tyrant_tpu/ops/pallas/traverse_kernel.py::_wave_kernel (with
// _wave_packet), the wave generation behind closest_hit_packets /
// any_hit_packets(wave=True).  The TPU kernel splits each block into 8
// independent 128-ray sublane packets with one stack each; its shape (8
// sublanes, SMEM stacks, a VMEM treelet, 8 row DMAs in flight) belongs to
// the TPU and is not carried over.
//
// What bounds it on an H100 (chip_smoke.py on the 1M-triangle terrain;
// PERF.md has the numbers): the union of the visits.  A packet
// visits every row that any of its rays needs, one after the other, and
// learns a child's address only from its parent's row; the bytes are few
// (30-90 MB a 2M-ray queue, 0.01-0.03 ms of HBM time).  On coherent rays
// (camera primaries) the union is close to each ray's own walk and the
// kernel runs level with the one-ray-per-lane kernel; on incoherent ones
// (bounces, shadow rays) the union grows with every live lane, and the
// warp pays a whole visit where one lane needs it.
//
// What the design does about it:
//  - The kernel-side table (ops/kernels/traverse.py:build_kernel_tables): a
//    row is a 64-byte node record that every lane reads with four 16-byte
//    loads of one address, which the hardware serves as one broadcast
//    access, and a leaf's triangles are three such loads each.  So a row
//    goes straight into registers: no copy through shared memory and none
//    of the three __syncwarp a visit that the 512-byte row needed.
//  - The stack is warp-uniform, so every lane keeps its own copy in local
//    memory, where the 32 lanes' entries interleave: a push or a pop is one
//    coalesced access that L1 holds, with no shared memory, no race and no
//    barrier (the same entries in registers, read with a shuffle, measured
//    5% slower).  One __reduce_or_sync a visit carries every vote (either
//    child's box hit by a live lane; any lane still live).
//  - A dead lane (max distance <= 2 EPS) reads neither origin nor
//    direction, and a packet with no live lane ends before its first visit.
//  - Measured on this card and left out (PERF.md): the tree's top rows
//    staged in shared memory (no gain at 64, 256 or 512 rows: L1 holds
//    them anyway); the row on top of the stack kept in flight in a second
//    set of registers (16 more registers cost more occupancy than the
//    overlap returns); any-hit
//    queues compacted into packets of 32 live rays (the union of 32
//    incoherent live rays is a walk ten times as long as that of the 2-3
//    live rays of 32 consecutive slots, and the time follows the longest
//    walk); persistent blocks striding over the packets (the hardware's
//    block scheduler balances a packet a warp better).
//
// The normals output (closest hit, NORMALS) is the mono kernel's: a lane
// reads its winner's triangle record once after the packet's walk
// (store_normal, traverse_common.cuh) instead of carrying three floats
// through every leaf pass as the Pallas kernel does.
//
// Per lane the arithmetic is the mono kernel's (traverse_common.cuh): the
// same slab test with NaN-propagating max/min, the same Möller-Trumbore
// with det >= 1e-7 culling, the same EPS accept rules slot by slot, built
// with --fmad=false.  The near child follows the packet's first ray, so the
// visiting order differs from the plain walk's, which can flip only epsilon
// ties (two hits within EPS of each other); any-hit flags do not depend on
// the order, nor on which rays share a packet.
#include "traverse_common.cuh"

namespace {

using namespace tyrant;

constexpr int WTHREADS = 128;  // 4 packets walking a block

// One packet: each lane walks its slot `slot` when `valid`.
template <bool CLOSEST, bool NORMALS>
__device__ __forceinline__ void walk_packet(
    const float4* __restrict__ nodes, int n_rows,
    const float4* __restrict__ tris,
    const float* __restrict__ origin, const float* __restrict__ direction,
    const float* __restrict__ t_init, float* __restrict__ t_out,
    int* __restrict__ hit_out, float* __restrict__ nrm_out, int slot,
    bool valid) {
  const float limit = valid ? t_init[slot] : 0.0f;
  float t_best = limit;
  int hit = CLOSEST ? -1 : 0;
  // lanes that take part in the union; any hit: until occluded
  bool live = valid && (CLOSEST || limit > 2.0f * EPS);
  const Ray r = live ? make_ray(origin[3 * slot + 0], origin[3 * slot + 1],
                                origin[3 * slot + 2], direction[3 * slot + 0],
                                direction[3 * slot + 1],
                                direction[3 * slot + 2])
                     : make_ray(0.0f, 0.0f, 0.0f, 1.0f, 1.0f, 1.0f);

  // near-child order: the direction signs of the packet's first live ray
  const unsigned alive = __ballot_sync(FULL, live);
  const int lead = alive ? __ffs(alive) - 1 : 0;
  const int neg_x = __shfl_sync(FULL, (int)r.nx, lead);
  const int neg_y = __shfl_sync(FULL, (int)r.ny, lead);
  const int neg_z = __shfl_sync(FULL, (int)r.nz, lead);

  // the packet's row stack: warp-uniform, every lane keeps its own copy in
  // local memory (a lane's entries interleave with its neighbours', so a
  // push or a pop is one coalesced access, and no barrier is needed)
  int stack[STACK_DEPTH];
  int sp = 0;
  Node cur = load_node(nodes, 0);
  while (alive) {
    const float prune = CLOSEST ? t_best : limit;
    const bool box_l = live && box_left(cur, r, prune);
    const bool box_r = live && box_right(cur, r, prune);
    const int tag_l = tag_left(cur), tag_r = tag_right(cur);
    const int ref_l = cur.m.y, ref_r = cur.m.z;

    if (box_l && tag_l > 0)
      leaf<CLOSEST>(tris, tag_l, ref_l, r, limit, t_best, hit);
    if (!CLOSEST && hit) live = false;
    if (box_r && tag_r > 0 && live)
      leaf<CLOSEST>(tris, tag_r, ref_r, r, limit, t_best, hit);
    if (!CLOSEST && hit) live = false;

    // one vote: a live lane hit the left box, the right box; a lane lives
    const unsigned votes = __reduce_or_sync(
        FULL, (box_l && live ? 1u : 0u) | (box_r && live ? 2u : 0u) |
                  (live ? 4u : 0u));
    if (!CLOSEST && !(votes & 4u)) break;  // every ray occluded
    // interior children some live lane hit: push the far one first, so the
    // near one pops next
    const bool push_l = (votes & 1u) && tag_l < 0 && ref_l >= 0 &&
                        ref_l < n_rows;
    const bool push_r = (votes & 2u) && tag_r < 0 && ref_r >= 0 &&
                        ref_r < n_rows;
    const int axis = split_axis(cur);
    const bool near_is_r = (axis == 0 ? neg_x : (axis == 1 ? neg_y : neg_z));
    const bool far_ok = near_is_r ? push_l : push_r;
    const bool near_ok = near_is_r ? push_r : push_l;
    if (far_ok && sp < STACK_DEPTH) stack[sp++] = near_is_r ? ref_l : ref_r;
    if (near_ok && sp < STACK_DEPTH) stack[sp++] = near_is_r ? ref_r : ref_l;

    if (sp == 0) break;
    const int row_id = stack[--sp];
    cur = load_node(nodes, row_id);
  }
  if (valid) {
    if (CLOSEST) {
      t_out[slot] = t_best;
      hit_out[slot] = hit;
      if (NORMALS) store_normal(tris, hit, nrm_out, slot);
    } else {
      t_out[slot] = limit;
      hit_out[slot] = hit;
    }
  }
}

template <bool CLOSEST, bool NORMALS>
__global__ void __launch_bounds__(WTHREADS)
traverse_wave_kernel(const float4* __restrict__ nodes, int n_rows,
                     const float4* __restrict__ tris,
                     const float* __restrict__ origin,
                     const float* __restrict__ direction,
                     const float* __restrict__ t_init,
                     float* __restrict__ t_out, int* __restrict__ hit_out,
                     float* __restrict__ nrm_out, int n) {
  static_assert(CLOSEST || !NORMALS, "normals exist for closest hit only");
  const int lane = threadIdx.x & 31;
  // a packet is 32 consecutive slots
  const int slot = (blockIdx.x * (WTHREADS / 32) + (threadIdx.x >> 5)) * 32
                   + lane;
  if (slot - lane < n)
    walk_packet<CLOSEST, NORMALS>(nodes, n_rows, tris, origin, direction,
                                  t_init, t_out, hit_out, nrm_out, slot,
                                  slot < n);
}

}  // namespace

// Same contract as tyrant_traverse (traverse.cu): nodes [n_rows, 16] i32,
// 64-byte aligned, and tris [T, 12] f32, 16-byte aligned; origin, direction
// [n, 3] f32; t_init [n] f32 (closest: initial best distance; any hit: max
// distance).  Writes t_out [n] f32 and hit_out [n] i32 (closest: leaf-order
// triangle id or -1; any hit: 0/1), and for a closest hit with a non-null
// nrm_out the hit triangle's cross(e1, e2) there ([n, 3] f32, zero on a
// miss).  Launches on `stream`; returns cudaGetLastError().
extern "C" int tyrant_traverse_wave(const void* nodes, int n_rows,
                                    const void* tris, const float* origin,
                                    const float* direction,
                                    const float* t_init, float* t_out,
                                    int* hit_out, float* nrm_out, int n,
                                    int closest, void* stream) {
  if (n <= 0) return 0;
  const float4* nd = static_cast<const float4*>(nodes);
  const float4* tr = static_cast<const float4*>(tris);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = (n + WTHREADS - 1) / WTHREADS;  // a packet a warp
  if (closest && nrm_out)
    traverse_wave_kernel<true, true><<<grid, WTHREADS, 0, s>>>(
        nd, n_rows, tr, origin, direction, t_init, t_out, hit_out, nrm_out,
        n);
  else if (closest)
    traverse_wave_kernel<true, false><<<grid, WTHREADS, 0, s>>>(
        nd, n_rows, tr, origin, direction, t_init, t_out, hit_out, nullptr,
        n);
  else
    traverse_wave_kernel<false, false><<<grid, WTHREADS, 0, s>>>(
        nd, n_rows, tr, origin, direction, t_init, t_out, hit_out, nullptr,
        n);
  return (int)cudaGetLastError();
}
