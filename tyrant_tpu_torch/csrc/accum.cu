// Framebuffer accumulation of pixel-sorted updates, fed straight from the
// render step's sort.
//
// Replaces: tyrant_tpu/ops/pallas/accum_kernel.py::_accum_kernel, behind
// accumulate_sorted and accumulate_terminated.
//
// What bounds it on an H100: memory bandwidth, and only for the bytes the
// inputs need: every sort key (4 bytes), the values of the entries below P
// (16 bytes, or 12 with the path count implied), and the 16-byte row of each
// pixel that has an entry, read and written.  Entries at or above P (the
// step's surviving rays, a contiguous suffix of the sorted column) and
// pixels with no entry need nothing.  Arithmetic is one add per value.
//
// What the design does about it: the TPU kernel turns the scatter into
// one-hot matrix products over framebuffer tiles, because its vector unit
// has no per-lane scatter; that rounds the update values to bf16, a TPU
// artifact not carried over.  Here one thread takes one sorted entry.  It
// reads its key, takes its neighbour's with a shuffle (lane 0 loads the one
// before its warp), and is its pixel's run head when the key is below P and
// differs from the one before.  A head adds acc[p] + v[i] + v[i+1] + ... in
// sorted order in float32, reading on past its warp or block while the run
// lasts, and writes acc[p] with one 16-byte store.  Each pixel has exactly
// one head, so there are no atomics and the result equals a sequential
// scatter in index order, bit for bit.  No thread searches; a block whose
// first key is at or above P stops after that one load.  With W = 3 the
// values are a step's pending radiance [N, 3] and the count 1 is added in
// the same place, so the render step's accumulation needs no update array.
//
// The second-moment mode (M2, with W = 3) is the JAX step's second call of
// the TPU kernel on the same sorted keys, (p0^2, p1^2, p2^2, 1) into
// moment2 (tyrant_tpu/render.py, the flush for adaptive sampling and
// track_variance), made in the same launch: the head that walks its run
// adds each entry's value to acc[p] and its square, a float32 product
// rounded on its own (no FMA), to m2[p], the count 1 to both, so the keys
// and values are read once and the bound gains only the 16-byte moment2 row
// of each distinct pixel, read and written.
#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 256;
constexpr unsigned FULL = 0xffffffffu;

template <int W>
__device__ __forceinline__ float4 value(const float* __restrict__ vals,
                                        int i) {
  if (W == 4) return __ldg(reinterpret_cast<const float4*>(vals) + i);
  const float* v = vals + 3 * (size_t)i;
  return make_float4(__ldg(v), __ldg(v + 1), __ldg(v + 2), 1.0f);
}

template <int W, bool M2>
__global__ void __launch_bounds__(BLOCK)
accum_kernel(float4* __restrict__ acc, const int* __restrict__ key,
             const float* __restrict__ vals, float4* __restrict__ m2, int n,
             int p) {
  const int first = blockIdx.x * BLOCK;
  if (__ldg(key + first) >= p) return;  // the block is past the live prefix
  const int i = first + threadIdx.x;
  const int k = i < n ? __ldg(key + i) : p;
  int prev = __shfl_up_sync(FULL, k, 1);
  if ((threadIdx.x & 31) == 0 && i < n)
    prev = i > 0 ? __ldg(key + i - 1) : -1;
  if (k >= p || k == prev) return;
  float4 a = acc[k];
  float4 s;
  if (M2) s = m2[k];
  int j = i;
  do {
    const float4 v = value<W>(vals, j);
    a.x += v.x;
    a.y += v.y;
    a.z += v.z;
    a.w += v.w;
    if (M2) {
      s.x += __fmul_rn(v.x, v.x);
      s.y += __fmul_rn(v.y, v.y);
      s.z += __fmul_rn(v.z, v.z);
      s.w += v.w;
    }
  } while (++j < n && __ldg(key + j) == k);
  acc[k] = a;
  if (M2) m2[k] = s;
}

}  // namespace

// acc [p, 4] f32, updated in place; key [n] i32 ascending; vals [n, width]
// f32 with width 4 (the values as given) or 3 (a path count of 1 implied
// for every entry below p).  With m2 (a [p, 4] f32 buffer, width 3 only)
// the squared values and the count go into m2 in the same launch.
// Launches on `stream`; returns cudaGetLastError(), or
// cudaErrorInvalidValue for another width or m2 with width 4.
extern "C" int tyrant_accumulate(float* acc, const int* key, const float* vals,
                                 int n, int p, int width, float* m2,
                                 void* stream) {
  if ((width != 3 && width != 4) || (m2 && width != 3))
    return (int)cudaErrorInvalidValue;
  if (n <= 0 || p <= 0) return 0;
  const int grid = (n + BLOCK - 1) / BLOCK;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float4* a = reinterpret_cast<float4*>(acc);
  float4* q = reinterpret_cast<float4*>(m2);
  if (width == 4)
    accum_kernel<4, false><<<grid, BLOCK, 0, s>>>(a, key, vals, q, n, p);
  else if (m2)
    accum_kernel<3, true><<<grid, BLOCK, 0, s>>>(a, key, vals, q, n, p);
  else
    accum_kernel<3, false><<<grid, BLOCK, 0, s>>>(a, key, vals, q, n, p);
  return (int)cudaGetLastError();
}
