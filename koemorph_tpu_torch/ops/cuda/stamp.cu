// Stage stamps: a one-thread kernel that writes the device's global
// timer into a ring of step rows.
//
// No TPU kernel corresponds to it: on the TPU a compiled step's stages
// were timed by the profiler alone. On the card a step is one CUDA graph
// replay, so the stage boundaries are marked inside the graph: each stamp
// reads `%globaltimer` (ns) and writes it at [step % capacity, slot] of
// its track's ring, where `step` is the track's device step counter. The
// step's first stamp clears the rest of its row (a stage that does not
// run in a step, such as a refresh, then reads 0); its last stamp
// advances the counter. The counter lives on the device, so a replay
// needs nothing from the host.
//
// One thread, no shared memory, a few global writes: its cost is the
// launch (~2 us inside a graph). The template argument is the stamp's
// global slot id, which the kernel's name carries into a profiler trace
// (`koemorph_stamp<7>`), so a trace reader matches stamps by name.

#include <cuda_runtime.h>

template <int ID>
__global__ void koemorph_stamp(long long* ring, long long* counter,
                               int capacity, int n_slots, int slot,
                               int flags) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  const long long step = *counter;
  long long* row = ring + (step % capacity) * n_slots;
  if (flags & 1) {
    for (int i = 0; i < n_slots; ++i) row[i] = 0;
  }
  row[slot] = static_cast<long long>(now);
  if (flags & 2) *counter = step + 1;
}

#define KM_STAMP_CASE(i)                                              \
  case i:                                                             \
    koemorph_stamp<i><<<1, 1, 0, s>>>(ring, counter, capacity,        \
                                      n_slots, slot, flags);          \
    break;

// flags: 1 = the step's first stamp (clears its row), 2 = its last
// (advances the counter).
extern "C" int km_stamp(void* ring_ptr, void* counter_ptr, int id,
                        int capacity, int n_slots, int slot, int flags,
                        void* stream) {
  long long* ring = static_cast<long long*>(ring_ptr);
  long long* counter = static_cast<long long*>(counter_ptr);
  if (capacity <= 0 || slot < 0 || slot >= n_slots)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (id) {
    KM_STAMP_CASE(0) KM_STAMP_CASE(1) KM_STAMP_CASE(2) KM_STAMP_CASE(3)
    KM_STAMP_CASE(4) KM_STAMP_CASE(5) KM_STAMP_CASE(6) KM_STAMP_CASE(7)
    KM_STAMP_CASE(8) KM_STAMP_CASE(9) KM_STAMP_CASE(10) KM_STAMP_CASE(11)
    KM_STAMP_CASE(12) KM_STAMP_CASE(13) KM_STAMP_CASE(14) KM_STAMP_CASE(15)
    KM_STAMP_CASE(16) KM_STAMP_CASE(17) KM_STAMP_CASE(18) KM_STAMP_CASE(19)
    KM_STAMP_CASE(20) KM_STAMP_CASE(21) KM_STAMP_CASE(22) KM_STAMP_CASE(23)
    KM_STAMP_CASE(24) KM_STAMP_CASE(25) KM_STAMP_CASE(26) KM_STAMP_CASE(27)
    KM_STAMP_CASE(28) KM_STAMP_CASE(29) KM_STAMP_CASE(30) KM_STAMP_CASE(31)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
