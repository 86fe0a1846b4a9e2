// window_agg: sum, mean, max, min and count over the valid prefix of every
// stream's window ring buffer, written for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/window_agg/kernel.py, window_agg (Pallas
// body _agg_kernel) of the JAX package.
//
// What bounds it on this card: bytes.  It reads each ring (N, W, C) once
// and the counts, and writes five (N, C) planes; it does four float
// operations per valid entry.  At the IoT suite's (3586, 256, 4) that is
// 14.7 MB, about 4.4 us of HBM time at 3.35 TB/s, against 3.7 M operations
// (0.06 us at the scalar peak).
//
// What the simple design does about it: a CTA of 128 threads owns
// 128 / C streams (one thread per (stream, channel)).  It walks the window
// in chunks of kChunk entries: the CTA stages each stream's chunk, which is
// contiguous in memory, into shared memory with neighbouring threads on
// neighbouring addresses, skipping entries past the stream's count (they
// cost no HBM traffic); then every thread folds its (stream, channel)
// column of the chunk in index order.  Each thread starts all of its
// kChunk loads of a chunk before it stores any: a load-store loop waits
// out the HBM latency once per load.  Shared rows are padded by C floats, so the threads of a warp
// read 32 different banks.  The order of the sum is fixed (index order,
// one thread per column, no atomics), so the kernel equals its plain
// version (ref.py) bit for bit at every W.
//
// Float contract (as ref.py and core/program.py): subnormal inputs and
// results of the sum and the mean flush to zeros of the same sign (explicit
// flush below; the build also passes -ftz=true), no FMA contraction
// (-fmad=false), min/max propagate NaN and order -0.0 below +0.0, the mean
// is one correctly rounded division.  The masked sum of the JAX reference
// adds a +0.0 for every entry past the count: after the last valid entry
// one +0.0 is added when the window is not full, which is the same (it
// turns a -0.0 sum into +0.0; a second +0.0 changes nothing).  A one-entry
// window (W == 1) is its entry, unflushed, as XLA folds that reduction.
// The +-3e38 sentinels of the empty window stay inside the kernel: a stream
// with count <= 0 reads 0 for its mean, max and min.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 32;
constexpr float kBig = 3.0e38f;

__device__ __forceinline__ float flush(float x) {
  const uint32_t u = __float_as_uint(x);
  return (u & 0x7f800000u) == 0 ? __uint_as_float(u & 0x80000000u) : x;
}

__device__ __forceinline__ bool is_nan(float x) {
  return (__float_as_uint(x) & 0x7fffffffu) > 0x7f800000u;
}

__device__ __forceinline__ bool sign_bit(float x) {
  return (__float_as_uint(x) >> 31) != 0;
}

__device__ __forceinline__ float ieee_min(float a, float b) {
  if (is_nan(a) || is_nan(b)) return __fadd_rn(a, b);
  if (a < b) return a;
  if (b < a) return b;
  return sign_bit(a) ? a : b;
}

__device__ __forceinline__ float ieee_max(float a, float b) {
  if (is_nan(a) || is_nan(b)) return __fadd_rn(a, b);
  if (a > b) return a;
  if (b > a) return b;
  return sign_bit(a) ? b : a;
}

__global__ void __launch_bounds__(kThreads)
window_agg_kernel(const float* __restrict__ values,
                  const int* __restrict__ count, int N, int W, int C,
                  float* __restrict__ out_sum, float* __restrict__ out_mean,
                  float* __restrict__ out_max, float* __restrict__ out_min,
                  float* __restrict__ out_count) {
  __shared__ float tile[kThreads * (kChunk + 1)];
  __shared__ int s_valid[kThreads];    // each stream's count, in [0, W]
  __shared__ int s_limit;
  const int per_block = kThreads / C;            // streams of this CTA
  const int n0 = blockIdx.x * per_block;
  const int t = threadIdx.x;
  const int nl = t / C, c = t - nl * C;
  const int n = n0 + nl;
  const bool mine = nl < per_block && n < N;

  if (t == 0) s_limit = 0;
  if (t < per_block) {
    const int cnt = n0 + t < N ? count[n0 + t] : 0;
    s_valid[t] = cnt < 0 ? 0 : (cnt > W ? W : cnt);
  }
  __syncthreads();
  if (t < per_block) atomicMax(&s_limit, s_valid[t]);
  __syncthreads();
  const int limit = s_limit;                     // longest valid prefix
  const int cnt = mine ? count[n] : 0;
  const int n_valid = mine ? s_valid[nl] : 0;

  // A chunk's tile is per_block rows of `row` floats; load k of this
  // thread is float r_of[k] of row sl_of[k] (-1: none).  The divisions
  // are made once here, not per chunk.
  const int row = kChunk * C;
  const int pitch = row + C;                     // padded against conflicts
  int sl_of[kChunk], r_of[kChunk];
#pragma unroll
  for (int k = 0; k < kChunk; ++k) {
    const int i = t + k * kThreads;
    sl_of[k] = i < per_block * row ? i / row : -1;
    r_of[k] = i - sl_of[k] * row;
  }

  float s = 0.0f, mx = -kBig, mn = kBig;
  for (int w0 = 0; w0 < limit; w0 += kChunk) {
    // Every load of the chunk starts before any is stored, so a thread
    // keeps up to kChunk loads in flight.  Float r of a row lies inside
    // the stream's count iff r < (count - w0) * C.
    float buf[kChunk];
    unsigned ok = 0u;
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      const int sl = sl_of[k];
      if (sl >= 0 && r_of[k] < (s_valid[sl] - w0) * C) {
        buf[k] = values[((size_t)(n0 + sl) * W + w0) * C + r_of[k]];
        ok |= 1u << k;
      }
    }
#pragma unroll
    for (int k = 0; k < kChunk; ++k)
      if ((ok >> k) & 1u) tile[sl_of[k] * pitch + r_of[k]] = buf[k];
    __syncthreads();
    if (mine) {
      const int end = n_valid - w0 < kChunk ? n_valid - w0 : kChunk;
      const float* col = tile + nl * pitch + c;
      if (W == 1) {
        if (end > 0) s = mx = mn = col[0];
      } else {
        for (int j = 0; j < end; ++j) {
          const float x = flush(col[j * C]);
          s = flush(__fadd_rn(s, x));
          mx = ieee_max(mx, x);
          mn = ieee_min(mn, x);
        }
      }
    }
    __syncthreads();
  }
  if (!mine) return;
  if (W > 1 && n_valid < W) s = flush(__fadd_rn(s, 0.0f));
  const bool has = cnt > 0;
  const float cf = (float)cnt;
  const size_t o = (size_t)n * C + c;
  out_sum[o] = s;
  out_mean[o] = has ? flush(__fdiv_rn(flush(s), cf < 1.0f ? 1.0f : cf)) : 0.0f;
  out_max[o] = has ? mx : 0.0f;
  out_min[o] = has ? mn : 0.0f;
  out_count[o] = cf;
}

}  // namespace

extern "C" int window_agg_launch(const void* values, const void* count,
                                 int N, int W, int C, void* out_sum,
                                 void* out_mean, void* out_max, void* out_min,
                                 void* out_count, void* stream) {
  if (C < 1 || C > kThreads || W < 1 || N < 1)
    return (int)cudaErrorInvalidValue;
  const int per_block = kThreads / C;
  const int blocks = (N + per_block - 1) / per_block;
  window_agg_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)values, (const int*)count, N, W, C, (float*)out_sum,
      (float*)out_mean, (float*)out_max, (float*)out_min, (float*)out_count);
  return (int)cudaGetLastError();
}
