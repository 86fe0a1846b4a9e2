// Weighted-fair pop in one CTA as a sorted selection: the shared device
// code of the sched_pop kernel (sched_pop.cu) and of the fused round's
// pop_dispatch kernel (round_fuse/csrc/fused_round.cu).
//
// The pop takes the first B slots of one static order, (key, vtag, seq,
// slot): key is the priority of a valid slot and INT_MAX for an invalid
// one; vtag = min(j, RANK_LIM) * FAIR_SCALE / w for the j-th valid slot
// of its tenant in (key, seq, slot) order, and 0 where w <= 0 or the slot
// is invalid.  ref.py's step-by-step loop visits exactly these slots in
// this order, and the engine's lexsort pop computes it outright.
// Precondition: a slot's weight is a function of its tenant (both callers
// pass weight[tenant]); the step-by-step pop applied the winner's weight
// to its whole tenant.
//
// So the pop is two sorts of the Q slots, not B dependent argmins:
//   1. each slot's 128-bit word (invalid, tenant, key, seq, slot); sort;
//      a valid slot's j is its position minus the first position of its
//      tenant's run.  The tenant range is not known here: tenants are
//      sorted on, never used as an index.
//   2. each slot's word (key, vtag, seq, slot); sort; the first B slots
//      are the pop.
// Signed fields are biased (x ^ 0x80000000) so that unsigned order is
// signed order.  The slot is the last field, so words are unique and ties
// go to the lowest slot, as jnp.lexsort gives them.  An invalid slot's
// word sorts as (INT_MAX, 0, seq, slot), so B at or above the number of
// valid slots fills take with invalid slots in (seq, slot) order.
//
// Shared memory holds each slot's word at its slot (16 B), two 16-bit slot
// lists the sorts permute (ping-pong) and the valid byte: 21 bytes a slot,
// plus 4 a pick and 128 for the rank scan.  A sort orders runs of kTile
// slots in registers, then merges runs of doubling width, one barrier a
// level: each thread finds where its kTile outputs start on the merge path
// (a binary search over the two runs), then merges the next kTile words of
// each run in registers (a bitonic merge).  The second sort keeps only the
// first B of each merged run.  A slot's tenant run starts at the running
// maximum of the positions where (invalid, tenant) changes, a scan over
// the CTA (warp shuffles, one barrier).  No barrier sits in a loop over
// the B picks.  Positions past Q act as words above every word (pad_word,
// the role of the Pallas kernel's retired pad lanes).  Comparisons are
// bitwise, loads are clamped rather than guarded: no branch on the data.
#pragma once

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace pop_select {

constexpr int kFairScale = 1 << 15;
constexpr int kRankLim = INT_MAX / kFairScale - 1;
constexpr int kMaxDevices = 64;
constexpr int kThreads = 512;  // the most threads a pop's CTA launches
constexpr int kTile = 8;       // slots a thread sorts, then merges per level
constexpr unsigned kAll = 0xffffffffu;

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

// Threads of the CTA that pops a Q-slot queue: one per kTile slots.
inline int threads_for(int Q) {
  const int t = ((Q + 32 * kTile - 1) / (32 * kTile)) * 32;
  return t < 32 ? 32 : (t > kThreads ? kThreads : t);
}

// Shared-memory layout of one pop, carved from the dynamic buffer.
struct Planes {
  ulonglong2* word;  // [Q] each slot's sort word, (hi, lo), at its slot
  uint16_t* ord_a;   // [Q] slot lists the sorts permute
  uint16_t* ord_b;   // [Q]
  int* take;         // [B] popped slots in pop order
  int* scan;         // [32] one int per warp, for the rank scan
  uint8_t* valid;    // [Q]
};

inline size_t planes_bytes(int Q, int B) {
  return (sizeof(ulonglong2) + 2 * sizeof(uint16_t) + 1) * (size_t)Q +
         sizeof(int) * ((size_t)B + 32);
}

__device__ inline Planes carve(unsigned char* smem, int Q, int B) {
  Planes p;
  p.word = reinterpret_cast<ulonglong2*>(smem);
  p.ord_a = reinterpret_cast<uint16_t*>(p.word + Q);
  p.ord_b = p.ord_a + Q;
  p.take = reinterpret_cast<int*>(p.ord_b + Q);  // 20 Q bytes in: aligned
  p.scan = p.take + B;
  p.valid = reinterpret_cast<uint8_t*>(p.scan + 32);
  return p;
}

__device__ __forceinline__ uint64_t biased(int x) {
  return (uint32_t)x ^ 0x80000000u;
}

// a < b as 128-bit numbers, hi first; bitwise, so that it takes no branch
__device__ __forceinline__ bool before(const ulonglong2& a,
                                       const ulonglong2& b) {
  return (a.x < b.x) | ((a.x == b.x) & (a.y < b.y));
}

// Above every slot's word: a valid word's hi has bit 63 clear, an invalid
// one's bits 31-62, and a second-sort word's low 32 bits are a tag below
// 2^31.
__device__ __forceinline__ ulonglong2 pad_word() {
  return make_ulonglong2(~0ull, ~0ull);
}

// The slot a word belongs to: the low 31 bits of lo, in both sorts.
__device__ __forceinline__ int slot_of(const ulonglong2& w) {
  return (int)(w.y & 0x7FFFFFFFull);
}

// Put the smaller of two words first.
__device__ __forceinline__ void order(ulonglong2& lo, ulonglong2& hi) {
  const ulonglong2 a = lo, b = hi;
  const bool swap = before(b, a);
  lo = swap ? b : a;
  hi = swap ? a : b;
}

// Ascending bitonic network over N words in registers.
template <int N>
__device__ __forceinline__ void sort_regs(ulonglong2 (&v)[N]) {
#pragma unroll
  for (int k = 2; k <= N; k <<= 1) {
#pragma unroll
    for (int s = k >> 1; s > 0; s >>= 1) {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const int j = s == k >> 1 ? i ^ (k - 1) : i ^ s;
        if (j > i) order(v[i], v[j]);
      }
    }
  }
}

// Order the slots [0, n) by their words (all threads of the CTA) and
// return the list, a or b, whose first min(n, cap) entries hold the
// smallest in order.  Each thread sorts runs of kTile slots in registers;
// merges of doubling width follow, one barrier a level: each thread finds
// where its kTile outputs start on the merge path (a binary search over
// the two runs) and merges the next kTile words of each in registers, and
// a merged run keeps only its first cap entries.  Every thread has passed
// a barrier after the last write.
__device__ inline const uint16_t* sort_slots(const ulonglong2* word,
                                             uint16_t* a, uint16_t* b,
                                             int n, int cap) {
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int tiles = (n + kTile - 1) / kTile;
  for (int t = tid; t < tiles; t += nthr) {
    // the tile's slots in an order rotated by thread, so that the eight
    // threads of a quarter warp read eight distinct 16-byte bank groups
    const int rot = (t * kTile) >> 3;
    ulonglong2 v[kTile];
#pragma unroll
    for (int e = 0; e < kTile; ++e) {
      const int s = t * kTile + ((e + rot) & (kTile - 1));
      v[e] = s < n ? word[s] : pad_word();
    }
    sort_regs(v);
#pragma unroll
    for (int e = 0; e < kTile; ++e) {
      if (t * kTile + e < n) a[t * kTile + e] = (uint16_t)slot_of(v[e]);
    }
  }
  __syncthreads();
  uint16_t* src = a;
  uint16_t* dst = b;
  for (int w = kTile; w < n; w <<= 1) {
    for (int t = tid; t < tiles; t += nthr) {
      // runs [a0, a0 + la) and [b0, b0 + lb) merge into [a0, a0 + total);
      // this tile writes outputs d .. d + kTile - 1 of it, and finds lo,
      // how many of them precede it in the first run (the merge path)
      const int a0 = (t * kTile) & ~(2 * w - 1), b0 = a0 + w;
      const int d = t * kTile - a0;
      const int la = min(min(w, n - a0), cap);
      const int lb = max(0, min(min(w, n - b0), cap));
      const int total = min(la + lb, cap);
      if (d >= total) continue;
      int lo = max(0, d - lb), hi = min(d, la);
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (before(word[src[a0 + mid]], word[src[b0 + d - 1 - mid]]))
          lo = mid + 1;
        else
          hi = mid;
      }
      // outputs d.. are the smallest of A[a0 + lo ..] and B[b0 + d - lo ..]:
      // the first kTile of each, one against the other reversed, keep the
      // smaller of each pair (a bitonic sequence of the kTile smallest),
      // then half-cleaners sort it.  Loads are clamped into the runs
      // rather than guarded, so that no load waits on a branch.
      const int ia = a0 + lo, ib = b0 + d - lo;
      const int ae = a0 + la, be = b0 + lb;
      ulonglong2 c[kTile];
#pragma unroll
      for (int e = 0; e < kTile; ++e) {
        const int i = ia + e, j = ib + kTile - 1 - e;
        ulonglong2 x = word[src[i < ae ? i : a0]];
        ulonglong2 y = word[src[j < be ? j : a0]];
        if (i >= ae) x = pad_word();
        if (j >= be) y = pad_word();
        c[e] = before(y, x) ? y : x;
      }
#pragma unroll
      for (int h = kTile / 2; h > 0; h >>= 1) {
#pragma unroll
        for (int e = 0; e < kTile; ++e) {
          if ((e ^ h) > e) order(c[e], c[e ^ h]);
        }
      }
#pragma unroll
      for (int e = 0; e < kTile; ++e) {
        if (d + e < total) dst[a0 + d + e] = (uint16_t)slot_of(c[e]);
      }
    }
    __syncthreads();
    uint16_t* t = src;
    src = dst;
    dst = t;
  }
  return src;
}

// Load the planes and select; on return p.take[0..B) holds the popped
// slots in pop order, p.valid every slot's validity, and every thread has
// passed a barrier after the last write.  blockDim.x must be a multiple
// of 32.
__device__ inline void run(const Planes& p, int Q, int B, const int* prio,
                           const int* seq, const uint8_t* valid,
                           const int* tenant, const int* weight) {
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, warps = nthr >> 5;
  // first sort: hi = invalid | tenant | key >> 1, lo = key & 1 | seq | slot
#pragma unroll 4
  for (int s = tid; s < Q; s += nthr) {
    const bool v = valid[s] != 0;
    const uint64_t key = biased(v ? prio[s] : INT_MAX);
    p.valid[s] = v;
    p.word[s] = make_ulonglong2(
        (uint64_t)!v << 63 | (v ? biased(tenant[s]) : 0) << 31 | key >> 1,
        (key & 1) << 63 | biased(seq[s]) << 31 | (uint64_t)s);
  }
  __syncthreads();
  const uint16_t* ord = sort_slots(p.word, p.ord_a, p.ord_b, Q, Q);
  // each valid slot's tag from its rank in its tenant's run: its position
  // minus the run's first, the running maximum of the positions where the
  // (invalid | tenant) prefix changes (each thread scans kTile positions,
  // then warps and the CTA combine).  The tag takes the place of the slot
  // field of lo; the scan reads only hi.
  const unsigned long long* hi_of =
      reinterpret_cast<const unsigned long long*>(p.word);
  int carry = 0;  // the run start in force before this round's positions
  for (int r0 = tid * kTile; r0 - tid * kTile < Q; r0 += nthr * kTile) {
    int slot[kTile], start[kTile], w[kTile];
    uint64_t pre[kTile];
    uint64_t prev = r0 > 0 && r0 <= Q ? hi_of[2 * ord[r0 - 1]] >> 31 : 0;
    int mine = 0;
#pragma unroll
    for (int e = 0; e < kTile; ++e) {
      const int r = r0 + e;
      slot[e] = ord[min(r, Q - 1)];
      pre[e] = hi_of[2 * slot[e]] >> 31;  // invalid | tenant
      w[e] = weight[slot[e]];             // in flight over the barriers
      if (r < Q && (r == 0 || pre[e] != prev)) mine = r;
      start[e] = mine;
      prev = pre[e];
    }
    int incl = mine;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(kAll, incl, off);
      if (lane >= off) incl = max(incl, o);
    }
    int excl = __shfl_up_sync(kAll, incl, 1);
    if (lane == 0) excl = 0;
    if (lane == 31) p.scan[warp] = incl;
    __syncthreads();
    int below = carry;
    for (int i = 0; i < warps; ++i) {
      if (i < warp) below = max(below, p.scan[i]);
      carry = max(carry, p.scan[i]);
    }
    __syncthreads();
    below = max(below, excl);
#pragma unroll
    for (int e = 0; e < kTile; ++e) {
      const int r = r0 + e, s = slot[e];
      if (r < Q) {
        int tag = 0;
        if (!(pre[e] >> 32) && w[e] > 0)
          tag = min(r - max(start[e], below), kRankLim) * kFairScale / w[e];
        unsigned long long* lo_of =
            reinterpret_cast<unsigned long long*>(p.word) + 2 * s + 1;
        *lo_of = (*lo_of & ~0x7FFFFFFFull) | (uint64_t)tag;
      }
    }
  }
  __syncthreads();
  // second sort: hi = key | tag, lo = seq | slot; only the first B count
  for (int s = tid; s < Q; s += nthr) {
    const ulonglong2 w = p.word[s];
    const uint64_t key = (w.x & 0x7FFFFFFFull) << 1 | w.y >> 63;
    const uint64_t sq = (w.y >> 31) & 0xFFFFFFFFull;
    p.word[s] = make_ulonglong2(key << 32 | (w.y & 0x7FFFFFFFull),
                                sq << 31 | (uint64_t)s);
  }
  __syncthreads();
  ord = sort_slots(p.word, p.ord_a, p.ord_b, Q, B);
  for (int b = tid; b < B; b += nthr) p.take[b] = ord[b];
  __syncthreads();
}

}  // namespace pop_select
