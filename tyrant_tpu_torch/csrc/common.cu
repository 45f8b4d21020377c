// Shared C entry points of the tyrant_tpu_torch kernel library, and the
// tracer's device side (tyrant_tpu_torch/utils/profiling.py).
//
// Replaces: no TPU kernel.  A CUDA graph replays its kernels without the
// host, so a host range around a stage exists only while the graph is
// captured; a marker kernel captured into the graph records the stage's
// start on every replay, with no host sync.
//
// What bounds it on an H100: nothing but its launch.  A marker is one
// thread, one 8-byte load, up to 10 stores and a read of %globaltimer (ns);
// the count kernel one warp and 10 values.  Each costs one launch, or one
// node of a captured graph.
//
// What the design does about it: one launch a stage boundary, and one
// launch for all of a step's counters, put after the step's end marker so
// that no stage's time carries them.  Each marker index is its own template
// instance, so a profiler trace names every stage's marker apart.
#include <cuda_runtime.h>

extern "C" const char* tyrant_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

namespace {

// template instances 0 .. MAX_MARKER - 1: the tracer's eleven markers and
// its clock calibration's
constexpr int MAX_MARKER = 12;
constexpr int MAX_COUNTS = 32;  // counters a step, one thread each

__device__ __forceinline__ long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return static_cast<long long>(t);
}

__device__ __forceinline__ long long ring_row(long long s, int slots) {
  const long long r = s % slots;
  return r < 0 ? r + slots : r;
}

// ring [slots, columns] int64, row (*step - back) mod slots: column K gets
// the device's clock.  Marker 0 opens a step's row and clears the rest of
// it; `advance` moves the step counter on (the step's end marker).
template <int K>
__global__ void trace_marker(long long* ring, long long* step, int slots,
                             int columns, int back, int advance) {
  const long long s = *step;
  long long* row = ring + ring_row(s - back, slots) * columns;
  if (K == 0)
    for (int c = 1; c < columns; ++c) row[c] = 0;
  row[K] = global_ns();
  if (advance) *step = s + 1;
}

// One step's counter values v [n]: into the ring's row of the step just
// ended ((*step - 1) mod slots) and added to the running totals.
__global__ void trace_count(long long* total, long long* ring,
                            const long long* step, const long long* v,
                            int slots, int n) {
  const int i = threadIdx.x;
  if (i >= n) return;
  ring[ring_row(*step - 1, slots) * n + i] = v[i];
  total[i] += v[i];
}

template <int K>
void launch_marker(int k, long long* ring, long long* step, int slots,
                   int columns, int back, int advance, cudaStream_t s) {
  if (k == K)
    trace_marker<K><<<1, 1, 0, s>>>(ring, step, slots, columns, back,
                                    advance);
  else if constexpr (K + 1 < MAX_MARKER)
    launch_marker<K + 1>(k, ring, step, slots, columns, back, advance, s);
}

}  // namespace

// Marker `k` (0 <= k < columns, k < 12) into ring [slots, columns] int64 at
// row (*step - back) mod slots; with `advance`, *step += 1 after it.
// Launches on `stream`; returns cudaGetLastError(), or
// cudaErrorInvalidValue for a marker outside the row.
extern "C" int tyrant_trace_marker(int k, long long* ring, long long* step,
                                   int slots, int columns, int back,
                                   int advance, void* stream) {
  if (k < 0 || k >= MAX_MARKER || k >= columns || slots <= 0)
    return (int)cudaErrorInvalidValue;
  launch_marker<0>(k, ring, step, slots, columns, back, advance,
                   static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}

// total [n] += v [n] and ring [slots, n] row (*step - 1) mod slots = v, all
// int64, n <= 32.  Launches on `stream`; returns cudaGetLastError(), or
// cudaErrorInvalidValue for another n.
extern "C" int tyrant_trace_count(long long* total, long long* ring,
                                  const long long* step, const long long* v,
                                  int slots, int n, void* stream) {
  if (n <= 0 || n > MAX_COUNTS || slots <= 0)
    return (int)cudaErrorInvalidValue;
  trace_count<<<1, MAX_COUNTS, 0, static_cast<cudaStream_t>(stream)>>>(
      total, ring, step, v, slots, n);
  return (int)cudaGetLastError();
}
