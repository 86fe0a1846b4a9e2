// sched_pop: the weighted-fair scheduler pop of the staged engine round,
// written for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/sched_pop/kernel.py, sched_pop_call
// (Pallas body _sched_pop_kernel) of the JAX package.
//
// What bounds it on this card: not bandwidth.  At the default queue=2048
// the kernel must read about 35 KB (the priority, seq, tenant and weight
// int32 planes and the valid byte of every slot, then the 64 winners' sid,
// ts and payload) -- some 10 ns of HBM time.  Nor is the pop a chain of
// `batch` dependent argmins: it takes the first B slots of one static
// order (pop_select.cuh), so its least dependent chain is that of two
// selections over Q keys, about 2 * (ceil(log2 Q) + 1) compare levels.
// What the CTA pays is shared memory: the merge levels' binary searches
// and window loads read 16-byte words at data-dependent slots, whose bank
// conflicts and dependent loads set each level's time.
//
// What the design does about it: one CTA of Q / 8 threads (at most 512)
// keeps each slot's sort word, the two slot lists and the valid bytes in
// shared memory (21 bytes a slot, 43 KB at Q=2048, opted in above 48 KB)
// and runs the two sorts of pop_select.cuh there: runs of eight slots
// sorted in registers (loaded in a rotated order that spreads a quarter
// warp over the banks), then merge-path levels that merge eight words of
// each run in registers, one barrier a level (8 a sort at Q=2048; the
// second sort keeps only the first B of each run).  The winners'
// sid/ts/valid/payload rows are then gathered with direct loads.  Payload
// floats are copied as their 32-bit patterns, so -0.0 and NaN payloads
// survive.
#include <cuda_runtime.h>

#include <cstdint>

#include "pop_select.cuh"

namespace {

__global__ void __launch_bounds__(pop_select::kThreads)
    sched_pop_kernel(const int* __restrict__ prio, const int* __restrict__ seq,
                     const uint8_t* __restrict__ valid,
                     const int* __restrict__ tenant,
                     const int* __restrict__ weight,
                     const int* __restrict__ sid, const int* __restrict__ ts,
                     const uint32_t* __restrict__ vals, int Q, int C, int B,
                     int* __restrict__ take, int* __restrict__ p_sid,
                     int* __restrict__ p_ts, uint8_t* __restrict__ p_valid,
                     uint32_t* __restrict__ p_vals) {
  extern __shared__ __align__(16) unsigned char smem[];
  const pop_select::Planes p = pop_select::carve(smem, Q, B);
  pop_select::run(p, Q, B, prio, seq, valid, tenant, weight);
  for (int b = threadIdx.x; b < B; b += blockDim.x) {
    const int i = p.take[b];
    take[b] = i;
    p_sid[b] = sid[i];
    p_ts[b] = ts[i];
    p_valid[b] = p.valid[i];
  }
  for (int j = threadIdx.x; j < B * C; j += blockDim.x) {
    const int b = j / C, c = j - b * C;
    p_vals[j] = vals[(size_t)p.take[b] * C + c];
  }
}

}  // namespace

extern "C" int sched_pop_launch(const void* prio, const void* seq,
                                const void* valid, const void* tenant,
                                const void* weight, const void* sid,
                                const void* ts, const void* vals, int Q, int C,
                                int B, void* take, void* p_sid, void* p_ts,
                                void* p_valid, void* p_vals, void* stream) {
  static size_t smem_set[pop_select::kMaxDevices] = {};
  const size_t smem = pop_select::planes_bytes(Q, B);
  const cudaError_t err = pop_select::opt_in_smem(
      (const void*)sched_pop_kernel, smem, smem_set);
  if (err != cudaSuccess) return (int)err;
  sched_pop_kernel<<<1, pop_select::threads_for(Q), smem,
                     (cudaStream_t)stream>>>(
      (const int*)prio, (const int*)seq, (const uint8_t*)valid,
      (const int*)tenant, (const int*)weight, (const int*)sid, (const int*)ts,
      (const uint32_t*)vals, Q, C, B, (int*)take, (int*)p_sid, (int*)p_ts,
      (uint8_t*)p_valid, (uint32_t*)p_vals);
  return (int)cudaGetLastError();
}
