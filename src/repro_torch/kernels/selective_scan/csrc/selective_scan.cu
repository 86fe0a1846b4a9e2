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
// What bounds it on this card: bytes.  Each input byte is read once and
// each output byte written once: a and bx (8 B L Di S bytes), c, h0, y and
// the final state; it does ~4 operations per (t, d, s).  At jamba's Mamba
// layer (B 1, L 4096, Di 8192, S 16) that is 4.43 GB, 1.32 ms at
// 3.35 TB/s, against 2.1 G operations (0.03 ms at the float32 peak).  At
// its decode shape (B 4, L 1) it is 8.5 MB, 2.5 us: there a launch and one
// trip to memory are what the kernel can be.
//
// What the design does about it:
//  - Four states a thread (kV = 4).  A thread owns four neighbouring
//    states of one channel: 16-byte loads of a, bx and h0 and one 16-byte
//    store of the final h.  S / 4 lanes share a channel, so y is an
//    in-register sum of four products and then log2(S / 4) xor shuffles
//    (2 at S = 16), stored once by the channel's first lane.  S in {1, 2},
//    or any base that is not 16-byte aligned (a view one float into its
//    buffer), takes the one-state template (kV = 1, S lanes a channel).
//  - No division and no per-step multiply: b is blockIdx.y and the channel
//    block blockIdx.x; each thread computes one 64-bit base per tensor and
//    advances it by Di S floats a step.
//  - Long sequences (L >= kT, kV = 4): the ring path.  A CTA owns C
//    channels, whose slice of a (and of bx) at one step is one contiguous
//    run of C S floats.  Thread 0 copies chunks of kT steps of both, and
//    c's kT S values, into a ring of kStages stages in shared memory by
//    1-D bulk copies (cp.async.bulk completing on the stage's mbarrier),
//    kStages - 1 chunks ahead of the recurrence, so no register holds a
//    load in flight.  Thread i reads bytes 16 i .. 16 i + 15 of a step's
//    row, so a warp reads 512 contiguous bytes: four wavefronts and no
//    bank conflict, at any row pitch.  A chunk's y lands in shared memory
//    (two buffers, one barrier a chunk) and is stored as kT rows of C
//    contiguous floats.
//  - The ring's sizes (kernel.py's selective_scan_plan): C S = 512 floats
//    (2 KB rows, 128 threads), or 256 (1 KB rows, 64 threads) where 2 KB
//    rows would leave an SM without a CTA; kT = 8, kStages = 3.  A stage
//    is 2 kT C S + kT S floats (33.3 KB at 2 KB rows), a CTA ~100 KB (two
//    an SM) or ~51 KB at 1 KB rows (four an SM).  Two chunks ahead is
//    ~66 KB a CTA, ~130 KB an SM in flight, against the ~25 KB an SM that
//    3.35 TB/s over ~1 us of latency needs.  At jamba's layer (B 1,
//    Di 8192, S 16) C = 32: 256 CTAs, all resident at once, every SM
//    busy.  Measured at that layer on an H100
//    (scripts/profile_torch_selective_scan.py): 4 or 8 steps a chunk and 2
//    to 4 stages read within 1 % of each other where every CTA is resident
//    at once; 1 KB rows ~1 % slower; a second wave of CTAs costs up to 8 %
//    when it is nearly full and ~30 % when it is mostly empty.
//  - Short sequences (L < kT, decode's L = 1) and the one-state template:
//    the register path, no ring.  Loads of up to kUnroll steps are issued
//    before their recurrence; at L = 1 each thread loads its h0, a, bx and
//    c once, so the kernel is a launch plus one trip to memory.  Jamba's
//    decode shape is 131,072 threads in 512 CTAs of 256: one wave.
//  Each call is one launch of one of the two kernels, chosen by the plan.
//
// Float contract (kernels/_build.py): the recurrence is a multiply and
// then an add (-fmad=false, -ftz=true, no fast math), as the plain version
// computes it.  y's sum over S is taken in another order than the plain
// version's: each thread's four products in index order, then the shuffle
// tree over the channel's S / kV lanes; the tests hold it within 1e-4.
#include <cuda_runtime.h>

#include <cstdint>

#include "../../csrc/hopper.cuh"

namespace {

constexpr int kT = 8;                      // steps a chunk of the ring
constexpr int kStages = 3;                 // ring stages
constexpr int kRingOffset = 128;           // shared bytes before the ring
static_assert(8 * kStages <= kRingOffset, "the mbarriers fit before the ring");
constexpr int kRegThreads = 256;           // register path's CTA
constexpr int kUnroll = 8;                 // register path: steps loaded ahead
constexpr unsigned kFull = 0xffffffffu;

// kV neighbouring floats: one 16-byte access where kV == 4
template <int kV>
__device__ __forceinline__ void ld_stream(float (&r)[kV], const float* p) {
  if constexpr (kV == 4) {
    const float4 v = __ldcs(reinterpret_cast<const float4*>(p));
    r[0] = v.x; r[1] = v.y; r[2] = v.z; r[3] = v.w;
  } else {
#pragma unroll
    for (int i = 0; i < kV; ++i) r[i] = __ldcs(p + i);
  }
}

template <int kV>
__device__ __forceinline__ void ld(float (&r)[kV], const float* p) {
  if constexpr (kV == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    r[0] = v.x; r[1] = v.y; r[2] = v.z; r[3] = v.w;
  } else {
#pragma unroll
    for (int i = 0; i < kV; ++i) r[i] = p[i];
  }
}

template <int kV>
__device__ __forceinline__ void st(float* p, const float (&r)[kV]) {
  if constexpr (kV == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(r[0], r[1], r[2], r[3]);
  } else {
#pragma unroll
    for (int i = 0; i < kV; ++i) p[i] = r[i];
  }
}

template <int kV>
__device__ __forceinline__ void zero(float (&r)[kV]) {
#pragma unroll
  for (int i = 0; i < kV; ++i) r[i] = 0.0f;
}

// One step of a thread's kV states; returns the channel's y (the sum over
// its kP lanes, which are aligned neighbours in the warp).
template <int kV, int kP>
__device__ __forceinline__ float step(float (&h)[kV], const float (&a)[kV],
                                      const float (&b)[kV],
                                      const float (&c)[kV]) {
  float y = 0.0f;
#pragma unroll
  for (int i = 0; i < kV; ++i) {
    h[i] = a[i] * h[i] + b[i];
    y = i == 0 ? h[i] * c[i] : y + h[i] * c[i];
  }
#pragma unroll
  for (int off = kP / 2; off > 0; off >>= 1)
    y += __shfl_xor_sync(kFull, y, off);
  return y;
}

// The register path: kRegThreads threads, kS / kV lanes a channel.
template <int kS, int kV>
__global__ void __launch_bounds__(kRegThreads) selective_scan_register_kernel(
    const float* __restrict__ a, const float* __restrict__ bx,
    const float* __restrict__ c, const float* __restrict__ h0,
    float* __restrict__ y, float* __restrict__ hout, int L, int Di) {
  constexpr int kP = kS / kV;
  constexpr int kC = kRegThreads / kP;           // channels a CTA
  const int b = blockIdx.y;
  const int q = threadIdx.x % kP;
  const int d = blockIdx.x * kC + threadIdx.x / kP;
  const bool live = d < Di;                      // a channel's lanes alike
  const long long row = static_cast<long long>(Di) * kS;   // floats a step
  const long long own = static_cast<long long>(d) * kS + q * kV;
  const float* ap = a + static_cast<long long>(b) * L * row + own;
  const float* bp = bx + static_cast<long long>(b) * L * row + own;
  const float* cp = c + static_cast<long long>(b) * L * kS + q * kV;
  float* yp = y + static_cast<long long>(b) * L * Di + d;
  const long long hoff = static_cast<long long>(b) * row + own;
  float h[kV];
  if (live) {
    ld<kV>(h, h0 + hoff);
  } else {
    zero<kV>(h);
  }
  const bool store_y = live && q == 0;
  int t = 0;
  for (; t + kUnroll <= L; t += kUnroll) {
    float av[kUnroll][kV], bv[kUnroll][kV], cv[kUnroll][kV];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (live) {
        ld_stream<kV>(av[u], ap + u * row);
        ld_stream<kV>(bv[u], bp + u * row);
      } else {
        zero<kV>(av[u]);
        zero<kV>(bv[u]);
      }
      ld<kV>(cv[u], cp + u * kS);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const float yv = step<kV, kP>(h, av[u], bv[u], cv[u]);
      if (store_y) yp[static_cast<long long>(u) * Di] = yv;
    }
    ap += kUnroll * row;
    bp += kUnroll * row;
    cp += kUnroll * kS;
    yp += static_cast<long long>(kUnroll) * Di;
  }
  for (; t < L; ++t) {                           // fewer than kUnroll left
    float av[kV], bv[kV], cv[kV];
    if (live) {
      ld_stream<kV>(av, ap);
      ld_stream<kV>(bv, bp);
    } else {
      zero<kV>(av);
      zero<kV>(bv);
    }
    ld<kV>(cv, cp);
    const float yv = step<kV, kP>(h, av, bv, cv);
    if (store_y) *yp = yv;
    ap += row;
    bp += row;
    cp += kS;
    yp += Di;
  }
  if (live) st<kV>(hout + hoff, h);
}

// The ring path: C channels a CTA (a power of two), C S / 4 threads, four
// states a thread.  Shared memory: kStages mbarriers, then kStages stages
// of [a: kT rows of C S floats][bx: the same][c: kT S floats], then two
// y buffers of kT C floats.
template <int kS>
__global__ void __launch_bounds__(128) selective_scan_ring_kernel(
    const float* __restrict__ a, const float* __restrict__ bx,
    const float* __restrict__ c, const float* __restrict__ h0,
    float* __restrict__ y, float* __restrict__ hout, int L, int Di, int C) {
  constexpr int kP = kS / 4;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t bars = smem_u32(smem);
  float* ring = reinterpret_cast<float*>(smem + kRingOffset);
  const int rowF = C * kS;                       // floats of a ring row
  const int stageF = 2 * kT * rowF + kT * kS;
  float* ybuf = ring + kStages * stageF;
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * C;
  const int Cb = Di - d0 < C ? Di - d0 : C;      // this CTA's channels
  const int cl = tid / kP, q = tid % kP;
  const bool live = cl < Cb;
  const long long row = static_cast<long long>(Di) * kS;
  const float* ag = a + static_cast<long long>(b) * L * row +
                    static_cast<long long>(d0) * kS;
  const float* bg = bx + static_cast<long long>(b) * L * row +
                    static_cast<long long>(d0) * kS;
  const float* cg = c + static_cast<long long>(b) * L * kS;
  const uint32_t row_bytes = static_cast<uint32_t>(Cb) * kS * 4;
  const int n_chunks = (L + kT - 1) / kT;
  const int cshift = __ffs(C) - 1;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(bars + 8u * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // chunk i (steps i kT ..) into stage i % kStages; thread 0 only
  auto issue = [&](int i) {
    const int t0 = i * kT;
    const int steps = L - t0 < kT ? L - t0 : kT;
    float* stage = ring + (i % kStages) * stageF;
    const uint32_t bar = bars + 8u * (i % kStages);
    mbar_expect_tx(bar, steps * (2 * row_bytes + kS * 4));
    const float* ap = ag + t0 * row;
    const float* bp = bg + t0 * row;
    for (int u = 0; u < steps; ++u) {
      bulk_copy_g2s(smem_u32(stage + u * rowF), ap, row_bytes, bar);
      bulk_copy_g2s(smem_u32(stage + (kT + u) * rowF), bp, row_bytes, bar);
      ap += row;
      bp += row;
    }
    bulk_copy_g2s(smem_u32(stage + 2 * kT * rowF), cg + t0 * kS,
                  steps * kS * 4, bar);
  };
  if (tid == 0)
    for (int i = 0; i < (n_chunks < kStages ? n_chunks : kStages); ++i)
      issue(i);

  const long long hoff = static_cast<long long>(b) * row +
                         static_cast<long long>(d0) * kS + 4 * tid;
  float h[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (live) ld<4>(h, h0 + hoff);
  float* yrow = y + static_cast<long long>(b) * L * Di + d0;

  for (int i = 0; i < n_chunks; ++i) {
    const int t0 = i * kT;
    const int steps = L - t0 < kT ? L - t0 : kT;
    mbar_wait(bars + 8u * (i % kStages), (i / kStages) & 1);
    const float* sa = ring + (i % kStages) * stageF + 4 * tid;
    const float* sb = sa + kT * rowF;
    const float* sc = ring + (i % kStages) * stageF + 2 * kT * rowF + 4 * q;
    float* yb = ybuf + (i & 1) * kT * C;
    // a channel past Cb reads stale shared memory; its lanes are a whole
    // shuffle group and store nothing
    auto one = [&](int u) {
      float av[4], bv[4], cv[4];
      ld<4>(av, sa + u * rowF);
      ld<4>(bv, sb + u * rowF);
      ld<4>(cv, sc + u * kS);
      const float yv = step<4, kP>(h, av, bv, cv);
      if (q == 0) yb[u * C + cl] = yv;
    };
    if (steps == kT) {
#pragma unroll
      for (int u = 0; u < kT; ++u) one(u);
    } else {
      for (int u = 0; u < steps; ++u) one(u);
    }
    __syncthreads();               // the stage is read, the y buffer full
    if (tid == 0 && i + kStages < n_chunks) issue(i + kStages);
    for (int k = tid; k < steps * C; k += blockDim.x) {
      const int u = k >> cshift, cc = k & (C - 1);
      if (cc < Cb) yrow[static_cast<long long>(t0 + u) * Di + cc] = yb[k];
    }
  }
  if (live) st<4>(hout + hoff, h);
}

template <int kS, int kV>
int launch_register(const float* a, const float* bx, const float* c,
                    const float* h0, float* y, float* hout, int B, int L,
                    int Di, cudaStream_t stream) {
  constexpr int kC = kRegThreads / (kS / kV);
  const dim3 grid((Di + kC - 1) / kC, B);
  selective_scan_register_kernel<kS, kV><<<grid, kRegThreads, 0, stream>>>(
      a, bx, c, h0, y, hout, L, Di);
  return static_cast<int>(cudaGetLastError());
}

template <int kS>
int launch_ring(const float* a, const float* bx, const float* c,
                const float* h0, float* y, float* hout, int B, int L, int Di,
                int C, int smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        selective_scan_ring_kernel<kS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((Di + C - 1) / C, B);
  selective_scan_ring_kernel<kS><<<grid, C * kS / 4, smem, stream>>>(
      a, bx, c, h0, y, hout, L, Di, C);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// The plan (ring or register path, states a thread, channels a CTA, shared
// bytes) comes from kernel.py's selective_scan_plan; this checks that it
// describes one of the layouts above before launching.  S must be a power
// of two up to 32.  Returns a cudaError_t code (0 = launched).
extern "C" int selective_scan_launch(const void* a, const void* bx,
                                     const void* c, const void* h0, void* y,
                                     void* hout, int B, int L, int Di, int S,
                                     int ring, int states, int channels,
                                     int smem, void* stream) {
  const auto* fa = static_cast<const float*>(a);
  const auto* fb = static_cast<const float*>(bx);
  const auto* fc = static_cast<const float*>(c);
  const auto* fh = static_cast<const float*>(h0);
  auto* fy = static_cast<float*>(y);
  auto* fo = static_cast<float*>(hout);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (B < 1 || B > 65535 || L < 1 || Di < 1 || S < 1 || S > 32 ||
      (S & (S - 1)) != 0 || (states != 1 && states != 4) || states > S)
    return bad;
  if (states == 4 && !(aligned16(a) && aligned16(bx) && aligned16(c) &&
                       aligned16(h0) && aligned16(hout)))
    return bad;
  if (ring) {
    const int threads = channels * S / 4;
    const int want = kRingOffset +
                     4 * (kStages * (2 * kT * channels * S + kT * S) +
                          2 * kT * channels);
    if (states != 4 || L < kT || channels < 1 ||
        (channels & (channels - 1)) != 0 || threads < 32 || threads > 128 ||
        smem != want)
      return bad;
    switch (S) {
      case 4: return launch_ring<4>(fa, fb, fc, fh, fy, fo, B, L, Di, channels, smem, st);
      case 8: return launch_ring<8>(fa, fb, fc, fh, fy, fo, B, L, Di, channels, smem, st);
      case 16: return launch_ring<16>(fa, fb, fc, fh, fy, fo, B, L, Di, channels, smem, st);
      case 32: return launch_ring<32>(fa, fb, fc, fh, fy, fo, B, L, Di, channels, smem, st);
      default: return bad;
    }
  }
  if (smem != 0 || channels != kRegThreads / (S / states)) return bad;
  if (states == 4) {
    switch (S) {
      case 4: return launch_register<4, 4>(fa, fb, fc, fh, fy, fo, B, L, Di, st);
      case 8: return launch_register<8, 4>(fa, fb, fc, fh, fy, fo, B, L, Di, st);
      case 16: return launch_register<16, 4>(fa, fb, fc, fh, fy, fo, B, L, Di, st);
      case 32: return launch_register<32, 4>(fa, fb, fc, fh, fy, fo, B, L, Di, st);
      default: return bad;
    }
  }
  switch (S) {
    case 1: return launch_register<1, 1>(fa, fb, fc, fh, fy, fo, B, L, Di, st);
    case 2: return launch_register<2, 1>(fa, fb, fc, fh, fy, fo, B, L, Di, st);
    case 4: return launch_register<4, 1>(fa, fb, fc, fh, fy, fo, B, L, Di, st);
    case 8: return launch_register<8, 1>(fa, fb, fc, fh, fy, fo, B, L, Di, st);
    case 16: return launch_register<16, 1>(fa, fb, fc, fh, fy, fo, B, L, Di, st);
    case 32: return launch_register<32, 1>(fa, fb, fc, fh, fy, fo, B, L, Di, st);
    default: return bad;
  }
}
