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
// all: a fraction of a microsecond of HBM time.  The stores are most of
// the bytes, so they have to be spread over many SMs and made once each.
//
// What the design does about it: a grid over (slot tile, destination,
// sender), so a sender's buckets are written by many CTAs at once.  Each
// CTA ranks its sender's W items for its own destination only: every
// thread counts the hits in a contiguous run of the dest plane (4 KB at
// W = 1,024, read from L2), one CTA scan over the threads' counts gives
// each run its first rank, and a second pass over the run writes, for
// every hit ranked inside the CTA's tile, the item's index at its rank in
// shared memory.  Then each thread writes one slot of the tile exactly
// once: from that item where the rank is below the destination's count,
// else the empty pattern — one 16-byte store for the four int planes and,
// at C = 4, one for the payload (C stores of 4 bytes at other C).  The
// first tile of each destination writes the drop flags of its items (the
// first tile of destination 0 also those of the unrouted items), so every
// flag too is written once.  No atomics: ranks are exact and in array
// order.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;  // ranking threads, and slots per CTA
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads) exchange_compact_kernel(
    int W, int C, int n_dest, int slots, const int* __restrict__ wi_t,
    const int* __restrict__ wi_src, const int* __restrict__ wi_ts,
    const int* __restrict__ wi_its, const uint32_t* __restrict__ wi_vals,
    const int* __restrict__ dest, int* __restrict__ xi,
    uint32_t* __restrict__ xf, uint8_t* __restrict__ drop) {
  __shared__ int item_at[kThreads];  // the item at each rank of the tile
  __shared__ int warp_hits[kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j0 = blockIdx.x * kThreads;  // first slot of the tile
  const int d = blockIdx.y;              // destination
  const size_t s = blockIdx.z;           // sending shard
  const bool first_tile = blockIdx.x == 0;
  wi_t += s * W;
  wi_src += s * W;
  wi_ts += s * W;
  wi_its += s * W;
  wi_vals += s * W * C;
  dest += s * W;
  drop += s * W;

  // this thread's run of items, and its hits on destination d
  const int per = (W + kThreads - 1) / kThreads;
  const int b0 = min(tid * per, W), b1 = min(b0 + per, W);
  int hits = 0;
  for (int w = b0; w < b1; ++w) {
    const int dw = dest[w];
    hits += dw < n_dest && max(dw, 0) == d;
  }
  // exclusive scan of the runs' hits, in thread (= array) order
  int incl = hits;
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) warp_hits[warp] = incl;
  __syncthreads();
  int rank = incl - hits, count = 0;
  for (int v = 0; v < kWarps; ++v) {
    const int x = warp_hits[v];
    rank += v < warp ? x : 0;
    count += x;
  }
  for (int w = b0; w < b1; ++w) {
    const int dw = dest[w];
    if (dw < n_dest && max(dw, 0) == d) {
      if (rank >= j0 && rank < j0 + kThreads) item_at[rank - j0] = w;
      if (first_tile) drop[w] = rank >= slots;
      ++rank;
    } else if (first_tile && d == 0 && dw >= n_dest) {
      drop[w] = 0;
    }
  }
  __syncthreads();

  // every slot of the tile, once
  const int n_tile = min(slots - j0, kThreads);
  const int n_full = min(max(count - j0, 0), n_tile);
  const size_t slot0 = ((s * n_dest) + d) * (size_t)slots + j0;
  const int j = tid;
  if (j < n_tile) {
    int4 v = make_int4(-1, -1, -1, -1);
    if (j < n_full) {
      const int w = item_at[j];
      v = make_int4(wi_t[w], wi_src[w], wi_ts[w], wi_its[w]);
    }
    reinterpret_cast<int4*>(xi)[slot0 + j] = v;
  }
  if (C == 4 && reinterpret_cast<uintptr_t>(wi_vals) % 16 == 0) {
    if (j < n_tile) {
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (j < n_full)
        v = reinterpret_cast<const uint4*>(wi_vals)[item_at[j]];
      reinterpret_cast<uint4*>(xf)[slot0 + j] = v;
    }
  } else {
    for (int k = tid; k < n_tile * C; k += kThreads) {
      const int jj = k / C, c = k - jj * C;
      xf[slot0 * C + k] =
          jj < n_full ? wi_vals[(size_t)item_at[jj] * C + c] : 0u;
    }
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
  if (n_dest < 1 || n_dest > 65535 || n_send > 65535 || slots < 1 ||
      W < 0 || C < 0 || (uintptr_t)xi % 16 != 0 || (uintptr_t)xf % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((slots + kThreads - 1) / kThreads, n_dest, n_send);
  exchange_compact_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      W, C, n_dest, slots, (const int*)wi_t, (const int*)wi_src,
      (const int*)wi_ts, (const int*)wi_its, (const uint32_t*)wi_vals,
      (const int*)dest, (int*)xi, (uint32_t*)xf, (uint8_t*)drop);
  return (int)cudaGetLastError();
}
