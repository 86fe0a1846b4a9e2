// stream_dispatch: stage 1 of the engine round (the subscriber fan-out,
// with the optional early stale mask) and the row gather beneath it, which
// also builds the sharded round's by-sid snapshot, written for Hopper
// (sm_90a).
//
// Replaces: src/repro/kernels/stream_dispatch/kernel.py, onehot_gather
// (Pallas body _gather_kernel), and the two onehot_gather calls with their
// glue in src/repro/kernels/stream_dispatch/ops.py, stream_dispatch, of the
// JAX package.
//
// The Pallas kernel gathers rows as a one-hot matrix product on the MXU,
// so the JAX op biases sids by +1 (a zero row means "none") and splits
// each int32 timestamp into 12-bit halves to stay exact in float32.  On
// Hopper a load is exact: both kernels here load the rows directly, so the
// bias and the split are gone and the outputs are the op's bits.  A float
// row keeps its bits (-0.0, NaN payloads, infinities, subnormals), where
// the one-hot product would turn -0.0 into +0.0 and spread a NaN or an
// infinity of the table over the block's other rows.
//
// What bounds them on this card: bytes, and far below that, the launch.
// stream_dispatch at the 4-shard round's shape (64 events, a (1024, 16)
// shard out-table, targets only) must move the 64 sids and valid bytes,
// the valid events' out-table rows (at most 64 x 64 B) and 4 KB of
// targets: about 8.5 KB, 2.5 ns of HBM time at 3.35 TB/s.  The by-sid
// snapshot of the 4-shard round (4096 ids into four (1024, 4) value planes
// and their timestamps) moves about 180 KB, 54 ns.  Both run at a
// launch's length, a microsecond or so, so what the design does about it
// is to spend fewer launches: the fan-out is one launch (the op made two,
// plus its glue), and the snapshot is one launch that reads the S shards'
// value and timestamp planes in place (their addresses travel in the
// kernel's parameters) and writes both by-sid arrays, where stacking the
// planes, gathering, stacking the timestamps, widening the ids and
// indexing took five device operations.
//
// Design: onehot_gather_kernel runs one thread per (id, word of a row): a
// word is 16 bytes where the row width and every table's address allow it
// (a row of C = 4 floats is one 128-bit load and store), else 8 or 4; the
// id's timestamp rides with the row's first word.  stream_dispatch_kernel
// runs one thread per (event, slot).  Neighbouring threads are on
// neighbouring words of one row, so loads and stores are coalesced.  No
// shared memory, no reduction.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

constexpr int kMaxTables = 64;   // shards a snapshot reads in place

// The S tables of one gather: table s holds rows s L .. s L + L - 1 of the
// flat row space, as (L, F) and, where `ts` is given, (L,) timestamps.
struct Tables {
  const void* rows[kMaxTables];
  const int* ts[kMaxTables];
};

template <int kVec> struct Word;
template <> struct Word<1> { using T = uint32_t; };
template <> struct Word<2> { using T = uint2; };
template <> struct Word<4> { using T = uint4; };

__device__ __forceinline__ uint32_t to_float_bits(uint32_t x) {
  return __float_as_uint(__int2float_rn((int)x));
}

// out[m, f] = float(row ids[m] of the flat (S L, F) row space, f) where
// 0 <= ids[m] < S L, else +0.0; with timestamps, out_ts[m] likewise (0
// outside).  kInt: the tables hold int32 (rounded to nearest float32);
// else float32, copied as 32-bit patterns.  kVec 32-bit lanes a word.
template <bool kInt, int kVec>
__global__ void __launch_bounds__(kThreads)
onehot_gather_kernel(const __grid_constant__ Tables tabs, int L, int F,
                     int SL, const int* __restrict__ ids, int M,
                     uint32_t* __restrict__ out, int* __restrict__ out_ts) {
  using T = typename Word<kVec>::T;
  const int words = F / kVec;
  const long long j = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (j >= (long long)M * words) return;
  const int m = (int)(j / words), w = (int)(j - (long long)m * words);
  const int id = ids[m];
  T v;
  uint32_t* lanes = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
  for (int u = 0; u < kVec; ++u) lanes[u] = 0u;
  int t = 0;
  if (id >= 0 && id < SL) {
    const int s = id / L, r = id - s * L;
    v = reinterpret_cast<const T*>(tabs.rows[s])[(size_t)r * words + w];
    if (kInt) {
#pragma unroll
      for (int u = 0; u < kVec; ++u) lanes[u] = to_float_bits(lanes[u]);
    }
    if (out_ts != nullptr && w == 0) t = tabs.ts[s][r];
  }
  reinterpret_cast<T*>(out)[j] = v;
  if (out_ts != nullptr && w == 0) out_ts[m] = t;
}

// targets[b, f] = out_table[sid[b], f] where valid[b], 0 <= sid[b] < n_tab
// and the entry is >= 0, else -1.  With early: early[b, f] = target >= 0
// && ts[b] > timestamps[target], reading a timestamp of 0 for a target
// >= N (the zero row of the op's second gather).
__global__ void __launch_bounds__(kThreads)
stream_dispatch_kernel(const int* __restrict__ sid,
                       const int* __restrict__ ts,
                       const uint8_t* __restrict__ valid,
                       const int* __restrict__ out_table,
                       const int* __restrict__ timestamps, int B, int F,
                       int n_tab, int N, int with_early,
                       int* __restrict__ targets,
                       uint8_t* __restrict__ early) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= B * F) return;
  const int b = j / F, f = j - b * F;
  const int s = sid[b];
  int t = -1;
  if (valid[b] && s >= 0 && s < n_tab) {
    const int x = out_table[(size_t)s * F + f];
    t = x >= 0 ? x : -1;
  }
  targets[j] = t;
  if (with_early) {
    const int t_ts = (t >= 0 && t < N) ? timestamps[t] : 0;
    early[j] = (t >= 0 && ts[b] > t_ts) ? 1 : 0;
  }
}

int blocks(int n) { return (n + kThreads - 1) / kThreads; }

template <bool kInt, int kVec>
int gather(const Tables& tabs, int L, int F, int SL, const int* ids, int M,
           void* out, void* out_ts, cudaStream_t st) {
  const long long n = (long long)M * (F / kVec);
  onehot_gather_kernel<kInt, kVec>
      <<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0, st>>>(
          tabs, L, F, SL, ids, M, (uint32_t*)out, (int*)out_ts);
  return (int)cudaGetLastError();
}

}  // namespace

// rows[s] / ts[s]: the S <= 64 tables' addresses (ts null: no timestamps);
// vec: 32-bit lanes a word, 4 or 2 only where F and every address allow.
extern "C" int onehot_gather_launch(const void* const* rows,
                                    const void* const* ts, int S, int L,
                                    int F, const void* ids, int M,
                                    int is_int, int vec, void* out,
                                    void* out_ts, void* stream) {
  if (S < 1 || S > kMaxTables || L < 1 || F < 1 || M < 1 ||
      (long long)S * L > 0x7fffffffLL || (vec != 1 && vec != 2 && vec != 4) ||
      F % vec != 0 || (ts != nullptr) != (out_ts != nullptr))
    return (int)cudaErrorInvalidValue;
  Tables tabs{};
  for (int s = 0; s < S; ++s) {
    if ((reinterpret_cast<uintptr_t>(rows[s]) & (4u * vec - 1)) != 0)
      return (int)cudaErrorInvalidValue;
    tabs.rows[s] = rows[s];
    tabs.ts[s] = ts != nullptr ? (const int*)ts[s] : nullptr;
  }
  using Gather = int (*)(const Tables&, int, int, int, const int*, int,
                         void*, void*, cudaStream_t);
  static const Gather by_type_and_width[2][3] = {
      {gather<false, 1>, gather<false, 2>, gather<false, 4>},
      {gather<true, 1>, gather<true, 2>, gather<true, 4>}};
  return by_type_and_width[is_int != 0][vec / 2](
      tabs, L, F, S * L, (const int*)ids, M, out, out_ts,
      (cudaStream_t)stream);
}

extern "C" int stream_dispatch_launch(const void* sid, const void* ts,
                                      const void* valid, const void* out_table,
                                      const void* timestamps, int B, int F,
                                      int n_tab, int N, int with_early,
                                      void* targets, void* early,
                                      void* stream) {
  stream_dispatch_kernel<<<blocks(B * F), kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)sid, (const int*)ts, (const uint8_t*)valid,
      (const int*)out_table, (const int*)timestamps, B, F, n_tab, N,
      with_early, (int*)targets, (uint8_t*)early);
  return (int)cudaGetLastError();
}
