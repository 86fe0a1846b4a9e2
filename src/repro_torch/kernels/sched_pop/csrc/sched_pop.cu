// sched_pop: the weighted-fair scheduler pop of the staged engine round,
// written for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/sched_pop/kernel.py, sched_pop_call
// (Pallas body _sched_pop_kernel) of the JAX package.
//
// What bounds it on this card: not bandwidth.  At the default queue=2048
// the kernel must read about 35 KB (the priority, seq, tenant and weight
// int32 planes and the valid byte of every slot, then the 64 winners' sid,
// ts and payload) — some 10 ns of HBM time.  The work is a serial chain of
// `batch` (64) selection steps, each a full-queue argmin whose result the
// next step depends on: at least ceil(log2 Q) + 1 = 12 dependent
// instructions per step (a compare tree over 2,048 candidates, then the
// tag bump), about 1.6 us at 4 cycles each and 1.98 GHz.  The simple
// design pays more per step: two block barriers and two shuffle trees.
//
// What the simple design does about it: one CTA of up to 1024 threads
// keeps every plane the loop touches in shared memory (about 43 KB at
// Q=2048, opted in above 48 KB), so each step costs shared-memory
// latency only, and the winners' sid/ts/valid/payload rows are gathered
// with direct loads after the loop.  Payload floats are copied as their
// 32-bit patterns, so -0.0 and NaN payloads survive.  Threads with no
// slot left start each reduction from the all-INT_MAX sentinel, above
// every real slot (the role of the Pallas kernel's retired pad lanes).
#include <cuda_runtime.h>

#include <cstdint>

#include "pop_select.cuh"

namespace {

__global__ void sched_pop_kernel(const int* __restrict__ prio,
                                 const int* __restrict__ seq,
                                 const uint8_t* __restrict__ valid,
                                 const int* __restrict__ tenant,
                                 const int* __restrict__ weight,
                                 const int* __restrict__ sid,
                                 const int* __restrict__ ts,
                                 const uint32_t* __restrict__ vals, int Q,
                                 int C, int B, int* __restrict__ take,
                                 int* __restrict__ p_sid,
                                 int* __restrict__ p_ts,
                                 uint8_t* __restrict__ p_valid,
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
  int threads = ((Q + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > 1024 ? 1024 : threads);
  sched_pop_kernel<<<1, threads, smem, (cudaStream_t)stream>>>(
      (const int*)prio, (const int*)seq, (const uint8_t*)valid,
      (const int*)tenant, (const int*)weight, (const int*)sid, (const int*)ts,
      (const uint32_t*)vals, Q, C, B, (int*)take, (int*)p_sid, (int*)p_ts,
      (uint8_t*)p_valid, (uint32_t*)p_vals);
  return (int)cudaGetLastError();
}
