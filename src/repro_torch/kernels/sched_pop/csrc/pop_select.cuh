// Weighted-fair selection pop in one CTA: the shared device code of the
// sched_pop kernel (sched_pop.cu) and of the fused round's pop_dispatch
// kernel (round_fuse/csrc/fused_round.cu).
//
// The queue's per-slot planes live in shared memory.  Each of the `batch`
// steps takes the lexicographic minimum of (key, tag, seq, slot) over the
// whole queue (every thread scans a strided share, then a warp-shuffle
// reduction and one pass over the warp results), bumps the winning
// tenant's virtual tag on its live slots, and retires the winner by
// raising its key and tag to INT_MAX — a pair no live slot can reach.
// Semantics are those of ref.py's sched_pop_ref, step for step.
#pragma once

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace pop_select {

constexpr int kFairScale = 1 << 15;
constexpr int kRankLim = INT_MAX / kFairScale - 1;
constexpr int kMaxDevices = 64;

// Raise `kernel`'s dynamic shared-memory limit to at least `bytes` on the
// current device.  The attribute persists, so each launcher keeps the
// largest size it has set per device in `done` and sets the attribute
// again only when a launch needs more.
inline cudaError_t opt_in_smem(const void* kernel, size_t bytes,
                               size_t (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 0 && dev < kMaxDevices && done[dev] >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err == cudaSuccess && dev >= 0 && dev < kMaxDevices) done[dev] = bytes;
  return err;
}

struct Cand {
  int key, tag, seq, slot;
};

__device__ __forceinline__ bool before(const Cand& a, const Cand& b) {
  if (a.key != b.key) return a.key < b.key;
  if (a.tag != b.tag) return a.tag < b.tag;
  if (a.seq != b.seq) return a.seq < b.seq;
  return a.slot < b.slot;
}

__device__ __forceinline__ Cand sentinel() {
  return Cand{INT_MAX, INT_MAX, INT_MAX, INT_MAX};
}

__device__ __forceinline__ Cand warp_min(Cand c) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Cand o;
    o.key = __shfl_down_sync(0xffffffffu, c.key, off);
    o.tag = __shfl_down_sync(0xffffffffu, c.tag, off);
    o.seq = __shfl_down_sync(0xffffffffu, c.seq, off);
    o.slot = __shfl_down_sync(0xffffffffu, c.slot, off);
    if (before(o, c)) c = o;
  }
  return c;
}

// Shared-memory layout of one pop, carved from the dynamic buffer.
struct Planes {
  Cand* warp_best;   // [32]
  Cand* winner;      // [1]
  int* key;          // [Q]
  int* tag;          // [Q]
  int* seq;          // [Q]
  int* tenant;       // [Q]
  int* weight;       // [Q]
  int* pop_tenant;   // [B] tenant of each valid pop, -2 for the others
  int* take;         // [B] winning slots in pop order
  uint8_t* valid;    // [Q]
};

inline size_t planes_bytes(int Q, int B) {
  return sizeof(Cand) * 33 + sizeof(int) * (5 * (size_t)Q + 2 * (size_t)B) +
         (size_t)Q;
}

__device__ inline Planes carve(unsigned char* smem, int Q, int B) {
  Planes p;
  p.warp_best = reinterpret_cast<Cand*>(smem);
  p.winner = p.warp_best + 32;
  int* ip = reinterpret_cast<int*>(p.winner + 1);
  p.key = ip;
  p.tag = ip + Q;
  p.seq = ip + 2 * Q;
  p.tenant = ip + 3 * Q;
  p.weight = ip + 4 * Q;
  p.pop_tenant = ip + 5 * Q;
  p.take = ip + 5 * Q + B;
  p.valid = reinterpret_cast<uint8_t*>(ip + 5 * Q + 2 * B);
  return p;
}

__device__ inline Cand block_min(Cand c, const Planes& p) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  c = warp_min(c);
  if (lane == 0) p.warp_best[warp] = c;
  __syncthreads();
  if (warp == 0) {
    const int n_warps = (blockDim.x + 31) >> 5;
    c = lane < n_warps ? p.warp_best[lane] : sentinel();
    c = warp_min(c);
    if (lane == 0) *p.winner = c;
  }
  __syncthreads();
  return *p.winner;
}

// Load the planes, run the `B` selection steps; on return p.take[0..B)
// holds the winners and every thread has passed a barrier after the last
// write.  blockDim.x must be a multiple of 32.
__device__ inline void run(const Planes& p, int Q, int B, const int* prio,
                           const int* seq, const uint8_t* valid,
                           const int* tenant, const int* weight) {
  const int tid = threadIdx.x, nthr = blockDim.x;
  for (int s = tid; s < Q; s += nthr) {
    const uint8_t v = valid[s] != 0;
    p.valid[s] = v;
    p.key[s] = v ? prio[s] : INT_MAX;
    p.tag[s] = 0;
    p.seq[s] = seq[s];
    p.tenant[s] = tenant[s];
    p.weight[s] = weight[s];
  }
  __syncthreads();
  for (int b = 0; b < B; ++b) {
    Cand c = sentinel();
    for (int s = tid; s < Q; s += nthr) {
      const Cand o{p.key[s], p.tag[s], p.seq[s], s};
      if (before(o, c)) c = o;
    }
    c = block_min(c, p);
    const int i = c.slot;
    const bool was_valid = p.valid[i] != 0;
    const int t_i = p.tenant[i];
    const int w_i = p.weight[i];
    if (was_valid && w_i > 0) {
      // valid pops of t_i so far, this one included: the within-tenant
      // rank of t_i's next head in the full-sort pop
      int cnt = 1;
      for (int k = 0; k < b; ++k) cnt += p.pop_tenant[k] == t_i;
      const int tagval = min(cnt, kRankLim) * kFairScale / w_i;
      for (int s = tid; s < Q; s += nthr) {
        if (p.tenant[s] == t_i && p.valid[s] && p.tag[s] != INT_MAX)
          p.tag[s] = tagval;
      }
    }
    __syncthreads();
    if (tid == 0) {
      p.tag[i] = INT_MAX;
      p.key[i] = INT_MAX;
      p.pop_tenant[b] = was_valid ? t_i : -2;
      p.take[b] = i;
    }
    __syncthreads();
  }
}

}  // namespace pop_select
