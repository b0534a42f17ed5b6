// The tracer's device stamp (utils/profiling.py): one thread reads the
// device's nanosecond clock (%globaltimer) and writes it with a tag into a
// ring of (time, tag) pairs, at the slot of an atomically incremented
// count.  Launched on a stream that a CUDA graph captures, it becomes a
// kernel node, which may sit inside a conditional node's body, so a
// captured tick stamps the points it reaches as the device runs them.
//
// Returns cudaGetLastError() after the launch (0 = cudaSuccess).

#include <cuda_runtime.h>

namespace {

__global__ void stamp_kernel(long long* ring, unsigned long long* count,
                             unsigned long long capacity, long long tag) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  const unsigned long long slot = atomicAdd(count, 1ULL) % capacity;
  ring[2 * slot] = static_cast<long long>(now);
  ring[2 * slot + 1] = tag;
}

}  // namespace

extern "C" {

// ring: (capacity, 2) int64 on the device; count: one int64 there
int nmpc_stamp(void* ring, void* count, long long capacity, long long tag,
               void* stream) {
  stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(ring), static_cast<unsigned long long*>(count),
      static_cast<unsigned long long>(capacity), tag);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
