// Breadth-first closest hit over the fat-row table ("level stream").
//
// Replaces: tyrant_tpu/ops/pallas/stream_kernel.py::_level_kernel (with
// _run_level, _stream_impl and its hit-queue min-combine), the kernel
// behind closest_hit_stream.
//
// What it computes: a frontier of (ray, row, lineage t) pairs, one level
// of the tree at a time.  A pair tests both child boxes of its row against
// its entry t, then the left leaf's triangles in order, then the right
// leaf's, each accept lowering its lineage t; each interior child whose box
// was hit becomes a pair of the next level with the final lineage t; a pair
// whose t fell leaves a hit.  Per ray the least t wins, then the smallest
// id.  A pair's t depends only on its ancestors, so the result does not
// depend on the order of the pairs: it equals the plain version
// (ops/stream.py) bit for bit.
//
// What bounds it on an H100: memory.  Each level writes its children to
// device memory and the next reads them back (12 bytes a pair), and each
// pair gathers its ray (24 bytes) and lanes of one 512-byte row by index.
// Arithmetic per pair is small (two slab tests, at most 12 Möller-Trumbore
// tests).
//
// What the design does about it: the TPU kernel's run ids, circular
// staging buffer, one-hot matmul placement, row window and DMA rings exist
// because its vector unit cannot gather or scatter per lane.  A GPU thread
// can, so here one thread takes one pair.  Children are appended with one
// atomicAdd a warp (ballot, popc, shuffle); an index past the capacity is
// dropped and raises the overflow flag.  Hits go straight to a per-ray
// 64-bit atomicMin on (t bits << 32 | id) instead of a hit queue: t > 0
// there, so its bits order as its value.  Every integer is an int32, so
// there is no 2^24 bound.  The level kernel reads its pair count from
// device memory, written by the level before, on a persistent grid-stride
// grid: no host sync between levels.  The slab test and Möller-Trumbore
// come from traverse_common.cuh, built with --fmad=false.
#include "traverse_common.cuh"

namespace {

using namespace tyrant;

constexpr int NO_HIT = 0x7fffffff;  // id half of a best before any hit
constexpr int BLOCK = 256;

__device__ __forceinline__ unsigned long long pack(float t, int id) {
  return ((unsigned long long)__float_as_uint(t) << 32) | (unsigned)id;
}

// Level 0: one pair (ray, row 0, t_init) a ray; bests at (t_init, NO_HIT);
// the level counts and the overflow flag cleared.
__global__ void init_kernel(const float* __restrict__ t_init, int n,
                            int* __restrict__ pair_ray,
                            int* __restrict__ pair_row,
                            float* __restrict__ pair_t,
                            unsigned long long* __restrict__ best,
                            int* __restrict__ counts, int levels,
                            int* __restrict__ ovf) {
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const float t = t_init[i];
    pair_ray[i] = i;
    pair_row[i] = 0;
    pair_t[i] = t;
    best[i] = pack(t, NO_HIT);
  }
  if (blockIdx.x == 0) {
    for (int k = threadIdx.x; k <= levels; k += blockDim.x)
      counts[k] = k == 0 ? n : 0;
    if (threadIdx.x == 0) *ovf = 0;
  }
}

// One leaf child: `tag` triangles from global prim offset `ref`, in order.
__device__ __forceinline__ void leaf(const float* __restrict__ tris, int tag,
                                     int ref, const Ray& r, float& t_best,
                                     int& hit) {
  for (int j = 0; j < LEAF_WIDTH; ++j) {
    if (j >= tag) break;
    const float t = mt_ldg(tris + 9 * j, r);
    if (t > EPS && (t_best - t) > EPS) {
      t_best = t;
      hit = ref + j;
    }
  }
}

__device__ __forceinline__ void emit(int idx, int cap, int ray, int row,
                                     float t, int* __restrict__ out_ray,
                                     int* __restrict__ out_row,
                                     float* __restrict__ out_t,
                                     int* __restrict__ ovf) {
  if (idx < cap) {
    out_ray[idx] = ray;
    out_row[idx] = row;
    out_t[idx] = t;
  } else {
    *ovf = 1;
  }
}

__global__ void __launch_bounds__(BLOCK)
level_kernel(const float* __restrict__ rows, int n_rows,
             const float* __restrict__ origin,
             const float* __restrict__ direction,
             const int* __restrict__ in_ray, const int* __restrict__ in_row,
             const float* __restrict__ in_t, const int* __restrict__ in_count,
             int* __restrict__ out_ray, int* __restrict__ out_row,
             float* __restrict__ out_t, int* __restrict__ out_count, int cap,
             unsigned long long* __restrict__ best, int* __restrict__ ovf) {
  const int n = min(*in_count, cap);  // a count past cap was cut there
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const int stride = gridDim.x * blockDim.x;
  // the loop bound is the same for the whole block, so every lane of a
  // warp reaches the ballots; lanes past n take part as dead lanes
  for (int base = blockIdx.x * blockDim.x; base < n; base += stride) {
    const int p = base + threadIdx.x;
    bool go_l = false, go_r = false;
    int ray = 0, ref_l = 0, ref_r = 0;
    float tl = 0.0f;
    if (p < n) {
      ray = in_ray[p];
      const int row_id = in_row[p];
      const float t_entry = in_t[p];
      tl = t_entry;
      if (row_id >= 0 && row_id < n_rows) {  // never false for a valid table
        const Ray r = make_ray(origin[3 * ray + 0], origin[3 * ray + 1],
                               origin[3 * ray + 2], direction[3 * ray + 0],
                               direction[3 * ray + 1], direction[3 * ray + 2]);
        const float* __restrict__ row = rows + (size_t)row_id * ROW;
        const bool box_l = slab_ldg(row + 0, r, t_entry);
        const bool box_r = slab_ldg(row + 6, r, t_entry);
        const int tag_l = (int)__ldg(row + L_TAG);
        const int tag_r = (int)__ldg(row + R_TAG);
        ref_l = (int)__ldg(row + L_REF);
        ref_r = (int)__ldg(row + R_REF);
        int hit = NO_HIT;
        if (box_l && tag_l > 0) leaf(row + L_TRI, tag_l, ref_l, r, tl, hit);
        if (box_r && tag_r > 0) leaf(row + R_TRI, tag_r, ref_r, r, tl, hit);
        if ((t_entry - tl) > 0.0f) atomicMin(best + ray, pack(tl, hit));
        go_l = box_l && tag_l < 0;
        go_r = box_r && tag_r < 0;
      }
    }
    // warp-aggregated append: one atomicAdd reserves the warp's children,
    // left ones first, each lane's slot from the ballots below it
    const unsigned ml = __ballot_sync(FULL, go_l);
    const unsigned mr = __ballot_sync(FULL, go_r);
    const int nl = __popc(ml);
    const int total = nl + __popc(mr);
    if (total == 0) continue;
    int warp_base = 0;
    if (lane == 0) warp_base = atomicAdd(out_count, total);
    warp_base = __shfl_sync(FULL, warp_base, 0);
    if (go_l)
      emit(warp_base + __popc(ml & below), cap, ray, ref_l, tl, out_ray,
           out_row, out_t, ovf);
    if (go_r)
      emit(warp_base + nl + __popc(mr & below), cap, ray, ref_r, tl, out_ray,
           out_row, out_t, ovf);
  }
}

// (t, id) from the packed bests; a frontier left after the last level
// means pairs were never visited, which raises the flag too.
__global__ void finish_kernel(const unsigned long long* __restrict__ best,
                              int n, float* __restrict__ t_out,
                              int* __restrict__ hit_out,
                              const int* __restrict__ left,
                              int* __restrict__ ovf) {
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const unsigned long long k = best[i];
    t_out[i] = __uint_as_float((unsigned)(k >> 32));
    const int id = (int)(unsigned)(k & 0xffffffffu);
    hit_out[i] = id == NO_HIT ? -1 : id;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0 && *left > 0) *ovf = 1;
}

}  // namespace

// rows [n_rows, 128] f32; origin, direction [n, 3] f32; t_init [n] f32.
// Scratch from the caller: pair_ray, pair_row [2 * cap] i32 and pair_t
// [2 * cap] f32 (two frontiers of cap pairs, cap >= n), counts
// [levels + 1] i32 (the pairs each level asked for), best [n] u64, ovf [1]
// i32.  Writes t_out [n] f32 and hit_out [n] i32 (leaf-order triangle id
// or -1).  Launches init, `levels` level kernels and finish on `stream`;
// returns the first cudaGetLastError() that is not cudaSuccess.
extern "C" int tyrant_stream(const float* rows, int n_rows,
                             const float* origin, const float* direction,
                             const float* t_init, float* t_out, int* hit_out,
                             int n, int* pair_ray, int* pair_row,
                             float* pair_t, int cap, int* counts, int levels,
                             unsigned long long* best, int* ovf,
                             void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, level_kernel,
                                                        BLOCK, 0);
  if (err != cudaSuccess) return (int)err;
  const int grid = sms * (per_sm > 0 ? per_sm : 1);  // one resident wave
  const int grid_n = min((n + BLOCK - 1) / BLOCK, grid);

  init_kernel<<<grid_n, BLOCK, 0, s>>>(t_init, n, pair_ray, pair_row, pair_t,
                                        best, counts, levels, ovf);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  for (int l = 0; l < levels; ++l) {
    const size_t in = (size_t)(l & 1) * cap, out = (size_t)((l + 1) & 1) * cap;
    level_kernel<<<grid, BLOCK, 0, s>>>(
        rows, n_rows, origin, direction, pair_ray + in, pair_row + in,
        pair_t + in, counts + l, pair_ray + out, pair_row + out, pair_t + out,
        counts + l + 1, cap, best, ovf);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  finish_kernel<<<grid_n, BLOCK, 0, s>>>(best, n, t_out, hit_out,
                                          counts + levels, ovf);
  return (int)cudaGetLastError();
}
