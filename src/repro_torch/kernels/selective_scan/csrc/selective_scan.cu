// selective_scan: the Mamba (S6) recurrence h_t = a_t * h_{t-1} + bx_t,
// y_t = h_t . c_t, written for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/selective_scan/kernel.py, selective_scan
// (Pallas body _scan_kernel) of the JAX package.
//
// Inputs as the model plane's mamba_block builds them: a and bx
// (B, L, Di, S) float32, c (B, L, S) float32, h0 (B, Di, S) float32.
// Outputs y (B, L, Di) float32 and the final state (B, Di, S) float32.
//
// What bounds it on this card: bytes.  It must read a and bx once
// (8 B L Di S bytes) and write y; it does ~4 operations per (t, d, s).  At
// jamba's Mamba layer (B 1, L 4096, Di 8192, S 16) that is ~4.43 GB, about
// 1.32 ms at 3.35 TB/s, against 2.1 G operations (0.03 ms at the scalar
// peak).
//
// The simple design: one thread per (b, d, s); the S threads of a channel
// are neighbouring lanes of one warp, so a warp's loads of a and bx at one
// time step are 128 contiguous bytes.  The carry h stays in a register for
// the whole sequence, time runs sequentially, and y_t is the S-lane sum by
// xor shuffles, stored by the channel's first lane.  Loads run kUnroll
// steps ahead of the recurrence (they do not depend on h), with
// evict-first hints since every element is read once.  The final h is
// written once.  One pass over the sequence replaces the Pallas kernel's
// sequential time-block grid dimension and its VMEM carry.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;

template <int kS>
__global__ void __launch_bounds__(kThreads) selective_scan_kernel(
    const float* __restrict__ a, const float* __restrict__ bx,
    const float* __restrict__ c, const float* __restrict__ h0,
    float* __restrict__ y, float* __restrict__ hout, int B, int L, int Di) {
  const long long per_b = static_cast<long long>(Di) * kS;
  const long long g = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const bool live = g < B * per_b;         // a channel's lanes are all live or all not
  const int b = live ? static_cast<int>(g / per_b) : 0;
  const long long rem = live ? g - b * per_b : 0;   // d * kS + s
  const int s = static_cast<int>(rem % kS);
  const int d = static_cast<int>(rem / kS);
  float h = live ? h0[g] : 0.f;
  const float* ap = a + static_cast<long long>(b) * L * per_b + rem;
  const float* bp = bx + static_cast<long long>(b) * L * per_b + rem;
  const float* cp = c + static_cast<long long>(b) * L * kS + s;
  float* yp = y + static_cast<long long>(b) * L * Di + d;

  for (int t0 = 0; t0 < L; t0 += kUnroll) {
    float av[kUnroll], bv[kUnroll], cv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u;
      const bool in = live && t < L;
      av[u] = in ? __ldcs(ap + t * per_b) : 0.f;
      bv[u] = in ? __ldcs(bp + t * per_b) : 0.f;
      cv[u] = in ? __ldg(cp + t * kS) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (t0 + u >= L) break;              // uniform across the warp
      h = av[u] * h + bv[u];
      float yv = h * cv[u];
#pragma unroll
      for (int off = kS / 2; off > 0; off >>= 1)
        yv += __shfl_xor_sync(0xffffffffu, yv, off);
      if (live && s == 0) yp[static_cast<long long>(t0 + u) * Di] = yv;
    }
  }
  if (live) hout[g] = h;
}

template <int kS>
int launch(const float* a, const float* bx, const float* c, const float* h0,
           float* y, float* hout, int B, int L, int Di, cudaStream_t stream) {
  const long long n = static_cast<long long>(B) * Di * kS;
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  selective_scan_kernel<kS><<<blocks, kThreads, 0, stream>>>(
      a, bx, c, h0, y, hout, B, L, Di);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// S must be a power of two up to 32 (the lanes of one channel).
// Returns a cudaError_t code (0 = launched).
extern "C" int selective_scan_launch(const void* a, const void* bx,
                                     const void* c, const void* h0, void* y,
                                     void* hout, int B, int L, int Di, int S,
                                     void* stream) {
  const auto* fa = static_cast<const float*>(a);
  const auto* fb = static_cast<const float*>(bx);
  const auto* fc = static_cast<const float*>(c);
  const auto* fh = static_cast<const float*>(h0);
  auto* fy = static_cast<float*>(y);
  auto* fo = static_cast<float*>(hout);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || L < 1 || Di < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (S) {
    case 1: return launch<1>(fa, fb, fc, fh, fy, fo, B, L, Di, st);
    case 2: return launch<2>(fa, fb, fc, fh, fy, fo, B, L, Di, st);
    case 4: return launch<4>(fa, fb, fc, fh, fy, fo, B, L, Di, st);
    case 8: return launch<8>(fa, fb, fc, fh, fy, fo, B, L, Di, st);
    case 16: return launch<16>(fa, fb, fc, fh, fy, fo, B, L, Di, st);
    case 32: return launch<32>(fa, fb, fc, fh, fy, fo, B, L, Di, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
