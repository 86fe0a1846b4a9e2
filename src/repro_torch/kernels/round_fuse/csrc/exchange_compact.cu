// exchange_compact: the sharded round's exchange compaction, written for
// Hopper (sm_90a).  W work items of each sending shard go into
// (n_dest, slots) per-destination buckets, in array order within each
// destination; an item ranked past its bucket's slots overflows.
//
// Replaces: src/repro/kernels/round_fuse/kernel.py, exchange_compact_call
// (Pallas body _exchange_compact_kernel) of the JAX package.  Its plain
// version is ref.exchange_compact_ref, the JAX package's ranked scatter
// lifted verbatim.
//
// What it computes, per sending shard s:
//   routed[w] = dest[w] < n_dest (a negative dest is clipped to bucket 0,
//   as the plain version clips it); unrouted lanes take no rank.
//   rank[w]   = number of earlier routed items with the same destination.
//   fits[w]   = routed[w] && rank[w] < slots; the item lands in slot
//   dest * slots + rank as (t, src, ts, its) int32 and its C payload
//   floats, moved as 32-bit patterns so -0.0 and NaN bits pass unchanged.
//   Empty slots read -1 in the four int planes and +0.0 in the payload.
//   drop[w]   = routed[w] && !fits[w] (the overflow mask).
//
// What bounds it on this card: bytes, and the latency of one launch.  At
// the smoke configuration (W = 1,024 items, 4 shards, 1,024 slots) it
// reads W x (4 + C) x 4 B per shard and writes n_dest x slots x (4 + C)
// x 4 B of buckets per shard (mostly the empty pattern), about 0.6 MB in
// all: a fraction of a microsecond of HBM time.
//
// What the simple design does about it: one CTA per sending shard, so one
// launch serves every shard.  The CTA first fills its buckets with the
// empty pattern, then walks W in tiles of its block size.  Per tile each
// warp takes one ballot per destination and counts it with __popc, a scan
// over the warps' counts gives each item its rank, and a running count
// per destination carries from tile to tile.  No atomics: ranks are exact
// and in array order.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDest = 32;

__global__ void __launch_bounds__(kThreads) exchange_compact_kernel(
    int W, int C, int n_dest, int slots, const int* __restrict__ wi_t,
    const int* __restrict__ wi_src, const int* __restrict__ wi_ts,
    const int* __restrict__ wi_its, const uint32_t* __restrict__ wi_vals,
    const int* __restrict__ dest, int* __restrict__ xi,
    uint32_t* __restrict__ xf, uint8_t* __restrict__ drop) {
  __shared__ int warp_count[kWarps][kMaxDest];
  __shared__ int running[kMaxDest];
  const size_t s = blockIdx.x;            // sending shard
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t n_slot = (size_t)n_dest * slots;
  wi_t += s * W;
  wi_src += s * W;
  wi_ts += s * W;
  wi_its += s * W;
  wi_vals += s * W * C;
  dest += s * W;
  drop += s * W;
  xi += s * n_slot * 4;
  xf += s * n_slot * C;

  // empty pattern first; __syncthreads orders it before the scatter
  for (size_t j = tid; j < n_slot * 4; j += kThreads) xi[j] = -1;
  for (size_t j = tid; j < n_slot * C; j += kThreads) xf[j] = 0u;
  for (int k = tid; k < n_dest; k += kThreads) running[k] = 0;
  __syncthreads();

  const unsigned lt_mask = (1u << lane) - 1u;
  for (int base = 0; base < W; base += kThreads) {
    const int w = base + tid;
    const int d = w < W ? dest[w] : n_dest;
    const bool routed = d < n_dest;
    const int dd = d < 0 ? 0 : d;
    int rank_in_warp = 0;
    for (int k = 0; k < n_dest; ++k) {
      const unsigned hit = __ballot_sync(0xffffffffu, routed && dd == k);
      if (lane == 0) warp_count[warp][k] = __popc(hit);
      if (routed && dd == k) rank_in_warp = __popc(hit & lt_mask);
    }
    __syncthreads();
    int rank = 0;
    if (routed) {
      rank = running[dd] + rank_in_warp;
      for (int v = 0; v < warp; ++v) rank += warp_count[v][dd];
    }
    __syncthreads();  // every thread has read running[] for this tile
    for (int k = tid; k < n_dest; k += kThreads) {
      int total = 0;
      for (int v = 0; v < kWarps; ++v) total += warp_count[v][k];
      running[k] += total;
    }
    if (w < W) {
      const bool fits = routed && rank < slots;
      drop[w] = routed && !fits;
      if (fits) {
        const size_t slot = (size_t)dd * slots + rank;
        xi[slot * 4 + 0] = wi_t[w];
        xi[slot * 4 + 1] = wi_src[w];
        xi[slot * 4 + 2] = wi_ts[w];
        xi[slot * 4 + 3] = wi_its[w];
        for (int c = 0; c < C; ++c)
          xf[slot * C + c] = wi_vals[(size_t)w * C + c];
      }
    }
    __syncthreads();  // warp_count and running[] are reused next tile
  }
}

}  // namespace

// n_send sending shards, each with W items of C payload floats, into
// n_dest x slots buckets per sender: xi (n_send, n_dest, slots, 4) int32,
// xf (n_send, n_dest, slots, C) float32 bits, drop (n_send, W) bytes.
extern "C" int exchange_compact_launch(
    int n_send, int W, int C, int n_dest, int slots, const void* wi_t,
    const void* wi_src, const void* wi_ts, const void* wi_its,
    const void* wi_vals, const void* dest, void* xi, void* xf, void* drop,
    void* stream) {
  if (n_send == 0) return 0;
  if (n_dest < 1 || n_dest > kMaxDest || slots < 1 || W < 0 || C < 0)
    return (int)cudaErrorInvalidValue;
  exchange_compact_kernel<<<n_send, kThreads, 0, (cudaStream_t)stream>>>(
      W, C, n_dest, slots, (const int*)wi_t, (const int*)wi_src,
      (const int*)wi_ts, (const int*)wi_its, (const uint32_t*)wi_vals,
      (const int*)dest, (int*)xi, (uint32_t*)xf, (uint8_t*)drop);
  return (int)cudaGetLastError();
}
