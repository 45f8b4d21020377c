// BVH traversal over the fat-row table in warp packets: closest hit and
// any hit, the same function as traverse.cu.
//
// Replaces: tyrant_tpu/ops/pallas/traverse_kernel.py::_wave_kernel (with
// _wave_packet), the wave generation behind closest_hit_packets /
// any_hit_packets(wave=True).  The TPU kernel splits each block into 8
// independent 128-ray sublane packets with one stack each; its shape (8
// sublanes, SMEM stacks, a VMEM treelet, 8 row DMAs in flight) belongs to
// the TPU and is not carried over.
//
// What bounds it on an H100: row latency and union visits.  Each visit
// depends on the row read before it, and a 1M-triangle table (about
// 129 MB) does not fit the 50 MB L2, so deep rows come from HBM.  A packet
// visits the union of the nodes its rays need: on coherent rays (camera
// primaries) that union is close to each ray's own walk, on incoherent
// ones (bounces, shadow rays) every lane pays for the nodes of the others.
//
// What the design does about it: one warp is one packet of 32 consecutive
// rays, one ray per lane, with one row stack in shared memory that every
// lane sees alike.  A visit brings the popped 512-byte row into shared
// memory with one coalesced read (a float4 per lane) instead of the mono
// kernel's 32 scattered per-thread reads of the same row, and each lane
// then reads its boxes, tags, refs and triangles from there.  Leaf passes
// run when __any_sync finds a lane whose box test hit a leaf child; a child
// row is pushed when any lane hit its box; the near child comes from the
// direction of the packet's first ray on the row's split axis.  Closest
// hit prunes each lane with its own t_best.  Any hit drops occluded lanes
// and lanes with max_dist <= 2 EPS out of the union, and the packet stops
// when __all_sync finds every lane done.  A ragged last packet masks its
// dead lanes out of every vote.  Treelet staging in shared memory, TMA and
// persistent warps are later work.
//
// Per lane the arithmetic is the mono kernel's (traverse_common.cuh): the
// same slab test with NaN-propagating max/min, the same Möller-Trumbore
// with det >= 1e-7 culling, the same EPS accept rules slot by slot, built
// with --fmad=false.  Visiting order differs from the plain walk's, which
// can flip only epsilon ties (two hits within EPS of each other).
#include "traverse_common.cuh"

namespace {

using namespace tyrant;

constexpr int WARPS = 4;  // a block of 128 threads
constexpr unsigned FULL = 0xffffffffu;

// One leaf child, read from the shared row: `tag` triangles starting at
// global prim offset `ref`.  closest: updates t_best / hit; any hit: sets
// hit = 1 on the first accept.
template <bool CLOSEST>
__device__ __forceinline__ void leaf(const float* tris, int tag, int ref,
                                     const Ray& r, float limit, float& t_best,
                                     int& hit) {
  for (int j = 0; j < LEAF_WIDTH; ++j) {
    if (j >= tag) break;
    const float* tri = tris + 9 * j;
    const float t = moller_trumbore(tri[0], tri[1], tri[2], tri[3], tri[4],
                                    tri[5], tri[6], tri[7], tri[8], r);
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
__global__ void __launch_bounds__(WARPS * 32)
traverse_wave_kernel(const float* __restrict__ rows, int n_rows,
                     const float* __restrict__ origin,
                     const float* __restrict__ direction,
                     const float* __restrict__ t_init,
                     float* __restrict__ t_out, int* __restrict__ hit_out,
                     int n) {
  __shared__ int stacks[WARPS][STACK_DEPTH];
  __shared__ float4 row_bufs[WARPS][ROW / 4];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int first = (blockIdx.x * WARPS + warp) * 32;  // the packet's ray 0
  if (first >= n) return;  // whole warp: no lane of this packet exists
  const int i = first + lane;
  const bool valid = i < n;

  const Ray r = valid ? make_ray(origin[3 * i + 0], origin[3 * i + 1],
                                 origin[3 * i + 2], direction[3 * i + 0],
                                 direction[3 * i + 1], direction[3 * i + 2])
                      : make_ray(0.0f, 0.0f, 0.0f, 1.0f, 1.0f, 1.0f);
  const float limit = valid ? t_init[i] : 0.0f;
  float t_best = limit;
  int hit = CLOSEST ? -1 : 0;
  // lanes that take part in the union's votes
  bool live = valid && (CLOSEST || limit > 2.0f * EPS);

  // near-child order: the packet's first ray's direction signs
  const int neg_x = __shfl_sync(FULL, (int)r.nx, 0);
  const int neg_y = __shfl_sync(FULL, (int)r.ny, 0);
  const int neg_z = __shfl_sync(FULL, (int)r.nz, 0);

  int* stack = stacks[warp];
  const float* row = reinterpret_cast<const float*>(row_bufs[warp]);
  const float4* rows4 = reinterpret_cast<const float4*>(rows);
  // sp is warp-uniform: every lane pops and pushes alike, lane 0 writes
  int sp = __any_sync(FULL, live) ? 0 : -1;
  if (lane == 0) stack[0] = 0;
  __syncwarp();

  while (sp >= 0) {
    const int row_id = stack[sp--];
    if (row_id < 0 || row_id >= n_rows) continue;  // never for a valid table
    // one coalesced 512-byte read of the row into shared memory
    row_bufs[warp][lane] = __ldg(rows4 + (size_t)row_id * (ROW / 4) + lane);
    __syncwarp();

    const float prune = CLOSEST ? t_best : limit;
    const bool box_l = live && slab(row[0], row[1], row[2], row[3], row[4],
                                    row[5], r, prune);
    const bool box_r = live && slab(row[6], row[7], row[8], row[9], row[10],
                                    row[11], r, prune);
    const int tag_l = (int)row[L_TAG];
    const int tag_r = (int)row[R_TAG];
    const int ref_l = (int)row[L_REF];
    const int ref_r = (int)row[R_REF];

    if (__any_sync(FULL, box_l && tag_l > 0) && box_l && tag_l > 0)
      leaf<CLOSEST>(row + L_TRI, tag_l, ref_l, r, limit, t_best, hit);
    if (!CLOSEST && hit) live = false;
    if (__any_sync(FULL, box_r && tag_r > 0 && live) && box_r && tag_r > 0 &&
        live)
      leaf<CLOSEST>(row + R_TRI, tag_r, ref_r, r, limit, t_best, hit);
    if (!CLOSEST && hit) live = false;

    // interior children any live lane hit: push the far one first, so the
    // near one pops next
    const bool push_l = __any_sync(FULL, box_l && tag_l < 0 && live);
    const bool push_r = __any_sync(FULL, box_r && tag_r < 0 && live);
    const int axis = (int)row[AXIS];
    const bool near_is_r = (axis == 0 ? neg_x : (axis == 1 ? neg_y : neg_z));
    const bool far_ok = near_is_r ? push_l : push_r;
    const bool near_ok = near_is_r ? push_r : push_l;
    __syncwarp();  // every lane has read the row and the popped slot
    if (far_ok && sp + 1 < STACK_DEPTH) {
      ++sp;
      if (lane == 0) stack[sp] = near_is_r ? ref_l : ref_r;
    }
    if (near_ok && sp + 1 < STACK_DEPTH) {
      ++sp;
      if (lane == 0) stack[sp] = near_is_r ? ref_r : ref_l;
    }
    if (!CLOSEST && __all_sync(FULL, !live)) break;
    __syncwarp();  // the pushes are visible before the next pop
  }
  if (valid) {
    t_out[i] = CLOSEST ? t_best : limit;
    hit_out[i] = hit;
  }
}

}  // namespace

// Same contract as tyrant_traverse (traverse.cu): rows [n_rows, 128] f32,
// 16-byte aligned; origin, direction [n, 3] f32; t_init [n] f32 (closest:
// initial best distance; any hit: max distance).  Writes t_out [n] f32 and
// hit_out [n] i32 (closest: leaf-order triangle id or -1; any hit: 0/1).
// Launches on `stream`; returns cudaGetLastError().
extern "C" int tyrant_traverse_wave(const float* rows, int n_rows,
                                    const float* origin,
                                    const float* direction,
                                    const float* t_init, float* t_out,
                                    int* hit_out, int n, int closest,
                                    void* stream) {
  if (n <= 0) return 0;
  const int block = WARPS * 32;
  const int grid = (n + block - 1) / block;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (closest)
    traverse_wave_kernel<true><<<grid, block, 0, s>>>(
        rows, n_rows, origin, direction, t_init, t_out, hit_out, n);
  else
    traverse_wave_kernel<false><<<grid, block, 0, s>>>(
        rows, n_rows, origin, direction, t_init, t_out, hit_out, n);
  return (int)cudaGetLastError();
}
