// flash_attention: causal, optionally sliding-window, grouped-query
// attention with an online softmax, written for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention/kernel.py, flash_attention
// (Pallas body _flash_kernel) of the JAX package.
//
// What it computes: for every batch b, query head h and query position i,
// o = softmax_j(q_i . k_j * scale) v over the keys j <= i with
// j > i - window (no window: every j <= i), where the key/value head is
// h / (H / KV).  Scores, the running (max, sum) and the accumulator are
// float32; q, k, v and o are float32 or bf16, o in q's type.
//
// What bounds it on this card: operations.  Every allowed (i, j) pair costs
// 2 * Dh multiply-adds (q.k and p.v), against reading q, k, v once and
// writing o once; at gemma3-1b's global layer (B 2, H 4, L 4096, Dh 256)
// that is ~69 GFLOP against 42 MB, far above the card's ~295 operations per
// byte in bf16.  The bound is the tensor cores' bf16 rate; this kernel does
// its products with scalar float32 FMAs, so it sits far above that bound.
//
// The simple design: one CTA of 256 threads per (q block of 64 rows, q head,
// batch).  The q block is staged once in shared memory as float32,
// transposed ([d][row], rows padded by one float against bank conflicts);
// then the CTA walks the 64-key blocks that meet its causal/window band
// (the blocks outside it are skipped, as the Pallas kernel's pl.when does),
// staging k transposed and v as rows (each thread issues eight loads of
// each before it stores any, since one CTA per SM leaves no other warps
// to hide their latency).  The 16 x 16 threads each own four
// query rows (ty + 16 i) and four keys (tx + 16 j) of the 64 x 64 score
// tile, and four rows by Dh / 16 columns (tx + 16 n) of the accumulator; a
// row's 16 owners are one half-warp, so its max and sum reduce by shuffles.
// Masked scores are -1e30 and their probabilities exactly 0, as in the
// Pallas kernel; rows and keys past the ends (any Lq and S) are zero-filled
// and masked.  Products use explicit fmaf, which -fmad=false leaves fused.
// Q, K and V are read in place through their strides: the model plane's
// (B, L, H, Dh) layout needs no transpose and no copy per head group.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kLoads = 8;                  // loads per thread in flight
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

size_t smem_bytes(int Dh) {
  return sizeof(float) * (static_cast<size_t>(Dh) * (kBQ + 1) +
                          static_cast<size_t>(Dh) * (kBK + 1) +
                          static_cast<size_t>(kBK) * Dh + kBQ * (kBK + 1));
}

template <typename T, int kDMax>
__global__ void __launch_bounds__(kThreads, 1) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o, int H, int KV, int Lq,
    int S, int Dh, int window, float scale, long long qsb, long long qsh,
    long long qsl, long long ksb, long long ksh, long long ksl,
    long long vsb, long long vsh, long long vsl, long long osb,
    long long osh, long long osl) {
  constexpr int kCols = kDMax / 16;
  extern __shared__ float smem[];
  float* qt = smem;                        // [Dh][kBQ + 1]
  float* kt = qt + Dh * (kBQ + 1);         // [Dh][kBK + 1]
  float* vs = kt + Dh * (kBK + 1);         // [kBK][Dh]
  float* ps = vs + kBK * Dh;               // [kBQ][kBK + 1]

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int n_qb = (Lq + kBQ - 1) / kBQ;
  const int q0 = (n_qb - 1 - static_cast<int>(blockIdx.x)) * kBQ;  // longest bands first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const T* qp = q + b * qsb + h * qsh;
  const T* kp = k + b * ksb + kvh * ksh;
  const T* vp = v + b * vsb + kvh * vsh;

  for (int e = tid; e < kBQ * Dh; e += kThreads) {
    const int r = e / Dh, d = e - r * Dh;
    const int qi = q0 + r;
    qt[d * (kBQ + 1) + r] = qi < Lq ? to_f(qp[qi * qsl + d]) : 0.f;
  }

  float acc[4][kCols];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int n = 0; n < kCols; ++n) acc[i][n] = 0.f;
  }

  const int q_last = min(q0 + kBQ, Lq) - 1;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_hi = min(S, q_last + 1);     // causal: no key past the last row
  for (int k0 = (k_lo / kBK) * kBK; k0 < k_hi; k0 += kBK) {
    __syncthreads();                       // the last tile's readers are done
    // kLoads elements of k and of v per thread in flight before any store:
    // one CTA per SM leaves no other warps to hide the load latency
    for (int e0 = 0; e0 < kBK * Dh; e0 += kThreads * kLoads) {
      float kr[kLoads], vr[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int e = e0 + u * kThreads + tid;
        const int c = e / Dh, d = e - c * Dh;
        const bool in = e < kBK * Dh && k0 + c < S;
        kr[u] = in ? to_f(kp[(k0 + c) * ksl + d]) : 0.f;
        vr[u] = in ? to_f(vp[(k0 + c) * vsl + d]) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int e = e0 + u * kThreads + tid;
        const int c = e / Dh, d = e - c * Dh;
        if (e < kBK * Dh) {
          kt[d * (kBK + 1) + c] = kr[u];
          vs[c * Dh + d] = vr[u];
        }
      }
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < Dh; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qt[d * (kBQ + 1) + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = kt[d * (kBK + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
      bool ok[4];
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        ok[j] = qi < Lq && kj < S && kj <= qi && (window <= 0 || kj > qi - window);
        s[i][j] = ok[j] ? s[i][j] * scale : kNeg;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        ps[(ty + 16 * i) * (kBK + 1) + tx + 16 * j] = p;
        rs += p;
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = alpha * l[i] + half_warp_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int n = 0; n < kCols; ++n) acc[i][n] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty + 16 * i) * (kBK + 1) + c];
#pragma unroll
      for (int n = 0; n < kCols; ++n) {
        const int d = tx + 16 * n;
        if (d < Dh) {
          const float vv = vs[c * Dh + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][n] = fmaf(pv[i], vv, acc[i][n]);
        }
      }
    }
  }

  T* op = o + b * osb + h * osh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= Lq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int n = 0; n < kCols; ++n) {
      const int d = tx + 16 * n;
      if (d < Dh) put(op + qi * osl + d, acc[i][n] / den);
    }
  }
}

template <typename T, int kDMax>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int KV, int Lq, int S, int Dh, int window, float scale,
           const long long* st, cudaStream_t stream) {
  static bool configured = false;          // the 48 KB default is too small
  auto kern = flash_attention_kernel<T, kDMax>;
  const size_t bytes = smem_bytes(Dh);
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes(kDMax)));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid((Lq + kBQ - 1) / kBQ, H, B);
  kern<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, KV, Lq, S, Dh, window,
      scale, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10], st[11]);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dh(const void* q, const void* k, const void* v, void* o, int B,
              int H, int KV, int Lq, int S, int Dh, int window, float scale,
              const long long* st, cudaStream_t stream) {
  if (Dh <= 64)
    return launch<T, 64>(q, k, v, o, B, H, KV, Lq, S, Dh, window, scale, st,
                         stream);
  if (Dh <= 128)
    return launch<T, 128>(q, k, v, o, B, H, KV, Lq, S, Dh, window, scale, st,
                          stream);
  return launch<T, 256>(q, k, v, o, B, H, KV, Lq, S, Dh, window, scale, st,
                        stream);
}

}  // namespace

// strides: 12 element strides, (batch, head, position) of q, k, v and o;
// the head dim is contiguous.  dtype 0: float32, 1: bf16.  window <= 0: none.
// Returns a cudaError_t code (0 = launched).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int dtype,
                                      int B, int H, int KV, int Lq, int S,
                                      int Dh, int window, float scale,
                                      const long long* strides,
                                      void* stream) {
  if (Dh < 1 || Dh > 256 || KV < 1 || H % KV != 0 || Lq < 1 || S < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dh<float>(q, k, v, o, B, H, KV, Lq, S, Dh, window, scale,
                            strides, s);
  if (dtype == 1)
    return launch_dh<__nv_bfloat16>(q, k, v, o, B, H, KV, Lq, S, Dh, window,
                                    scale, strides, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
