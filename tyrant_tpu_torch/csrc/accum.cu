// Framebuffer accumulation of pixel-sorted updates.
//
// Replaces: tyrant_tpu/ops/pallas/accum_kernel.py::_accum_kernel, behind
// accumulate_sorted.
//
// What bounds it on an H100: memory bandwidth.  One pass reads the [P, 4]
// framebuffer, the sorted [N] pixel column and the [N, 4] update values
// and writes the framebuffer back: about 108 MB at 1080p with a 2M-ray
// queue, some 32 us at 3.35 TB/s.  Arithmetic is one add per value.
//
// What the design does about it: the TPU kernel turns the scatter into
// one-hot matrix products over framebuffer tiles, because its vector unit
// has no per-lane scatter; that rounds the update values to bf16, a TPU
// artifact not carried over.  Here one thread owns one pixel p: it finds
// the start of p's run in the sorted column by binary search, adds
// acc[p] + v[lo] + ... + v[hi-1] in sorted order in float32, and writes
// acc[p] in place.  No atomics, so the result is deterministic and equal to
// a sequential scatter in index order.  Pixel and value reads of one warp
// fall on neighbouring runs of the sorted arrays, and the framebuffer row
// is one 16-byte load and store.  Entries at or above P (the sentinel
// tail of surviving rays) are never visited.
#include <cuda_runtime.h>

namespace {

__global__ void __launch_bounds__(256)
accum_kernel(float4* __restrict__ acc, const int* __restrict__ pix,
             const float4* __restrict__ vals, int n, int p) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= p) return;
  // lower bound of q in the ascending pix[0, n)
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (__ldg(pix + mid) < q) lo = mid + 1;
    else hi = mid;
  }
  if (lo >= n || __ldg(pix + lo) != q) return;
  float4 a = acc[q];
  for (int k = lo; k < n && __ldg(pix + k) == q; ++k) {
    const float4 v = __ldg(vals + k);
    a.x += v.x;
    a.y += v.y;
    a.z += v.z;
    a.w += v.w;
  }
  acc[q] = a;
}

}  // namespace

// acc [p, 4] f32, updated in place; pix [n] i32 ascending; vals [n, 4] f32.
// Launches on `stream`; returns cudaGetLastError().
extern "C" int tyrant_accumulate(float* acc, const int* pix, const float* vals,
                                 int n, int p, void* stream) {
  if (p <= 0) return 0;
  const int block = 256;
  const int grid = (p + block - 1) / block;
  accum_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<float4*>(acc), pix,
      reinterpret_cast<const float4*>(vals), n, p);
  return (int)cudaGetLastError();
}
