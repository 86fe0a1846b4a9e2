// stream_dispatch: stage 1 of the engine round (the subscriber fan-out,
// with the optional early stale mask) and the plain row gather beneath it,
// written for Hopper (sm_90a).
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
// targets: about 8.5 KB, 2.5 ns of HBM time at 3.35 TB/s.  onehot_gather
// at the sharded snapshot's shape (4096 ids into a (4096, 4) float table)
// moves about 147 KB, 44 ns.  Both are expected to be launch-bound at
// these shapes, a few microseconds each; fusing the fan-out into one
// launch (the op made two, plus its glue) is what the design does about
// that.
//
// Design: one thread per output element (event, slot), neighbouring
// threads on neighbouring slots of one row, so the loads of a row and the
// stores of the outputs are coalesced.  No shared memory, no reduction.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

// out[m, f] = float(table[ids[m], f]) where 0 <= ids[m] < N, else +0.0.
// kInt: table holds int32 (rounded to nearest float32); else float32,
// copied as its 32-bit pattern.
template <bool kInt>
__global__ void __launch_bounds__(kThreads)
onehot_gather_kernel(const uint32_t* __restrict__ table,
                     const int* __restrict__ ids, int N, int F, int M,
                     uint32_t* __restrict__ out) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= M * F) return;
  const int m = j / F, f = j - m * F;
  const int id = ids[m];
  uint32_t v = 0u;
  if (id >= 0 && id < N) {
    const uint32_t x = table[(size_t)id * F + f];
    v = kInt ? __float_as_uint(__int2float_rn((int)x)) : x;
  }
  out[j] = v;
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

}  // namespace

extern "C" int onehot_gather_launch(const void* table, const void* ids,
                                    int N, int F, int M, int is_int,
                                    void* out, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (is_int) {
    onehot_gather_kernel<true><<<blocks(M * F), kThreads, 0, st>>>(
        (const uint32_t*)table, (const int*)ids, N, F, M, (uint32_t*)out);
  } else {
    onehot_gather_kernel<false><<<blocks(M * F), kThreads, 0, st>>>(
        (const uint32_t*)table, (const int*)ids, N, F, M, (uint32_t*)out);
  }
  return (int)cudaGetLastError();
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
