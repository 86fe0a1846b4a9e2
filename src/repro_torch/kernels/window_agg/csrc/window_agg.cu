// window_agg: sum, mean, max, min and count over the valid prefix of every
// stream's window ring buffer, written for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/window_agg/kernel.py, window_agg (Pallas
// body _agg_kernel) of the JAX package.
//
// What bounds it on this card: bytes.  It reads each stream's valid
// prefix of its ring (N, W, C) once and the counts, and writes five (N, C)
// planes; it does four float operations per valid entry.  With every
// window full at (4096, 1024, 4) that is 67 MB, about 20 us of HBM time at
// 3.35 TB/s; at the IoT suite's (3586, 256, 4), whose windows hold a few
// entries each, 365 KB, so there a launch and the dependent trips to
// memory are what it waits on.
//
// What the design does about it:
//  - One warp per CTA, and each warp on its own: it owns the (stream,
//    channel) columns of G = 32 / C streams (8 at C = 4); a stream of more
//    than 32 channels spans ceil(C / 32) warps, each folding 32 of them.
//    A warp walks only to the longest valid prefix of its own streams.
//  - Each stream's valid prefix is one contiguous run of count x C floats
//    at n W C.  The warp stages it chunk by chunk (`chunk` entries, a
//    multiple of 4) into a ring of kStages stages in shared memory, a row
//    per stream, kStages - 1 chunks ahead of its fold, so no register
//    holds a load in flight and the copies of later chunks overlap the
//    fold of this one.
//  - Staging (chosen per launch by the launcher's plan, `window_agg_plan`
//    in kernel.py, from the addresses alone): kBulk, one lane per stream
//    issues a 1-D bulk copy (cp.async.bulk, completing on the stage's
//    mbarrier) of its chunk, which needs 16-byte aligned addresses and
//    sizes (W C % 4 == 0 and an aligned base; a chunk's span is rounded
//    up to 16 bytes, which stays inside the stream's ring); kLoad4,
//    wherever those do not hold, the lanes issue 4-byte cp.async copies
//    of the rows, tracked by cp.async groups.  Both land in the same ring.
//  - A ring row's pitch is a multiple of 16 bytes (a bulk copy lands
//    there) and = 16 bytes mod 128, so at C = 4 the 32 lanes of a fold
//    step read 32 banks.
//  - The fold is one sequential chain per column in index order (no
//    atomics, no split of W across lanes), with the NaN-propagating max
//    and min of PTX (max.NaN.f32, min.NaN.f32: one instruction each where
//    branch-free selects took seven).  So the kernel equals its plain
//    version (ref.py) bit for bit at every W.
//  - Limit: where C > 32, each of a stream's ceil(C / 32) warps stages
//    the stream's whole C-wide rows and folds only its own 32 channels,
//    so such stores read ceil(C / 32) times their bytes.  The main path's
//    C is 4.
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

#include "../../csrc/hopper.cuh"

namespace {

constexpr int kStages = 3;              // ring stages per warp
constexpr int kBarBytes = 8 * kStages;  // kStages mbarriers
constexpr int kRingOffset = 160;        // + 32 per-stream counts
static_assert(kBarBytes + 128 <= kRingOffset, "the ring's offset");
constexpr unsigned kFull = 0xffffffffu;
constexpr float kBig = 3.0e38f;
enum Staging { kBulk = 0, kLoad4 = 1 };

struct Shape {
  int N, W, C;
  int chunk;   // entries per chunk, a multiple of 4
  int pitch;   // floats per ring row
  int G;       // streams per warp
  int Cw;      // channels per warp: min(C, 32)
  int parts;   // warps per stream: ceil(C / 32)
};

__device__ __forceinline__ float flush(float x) {
  const uint32_t u = __float_as_uint(x);
  return (u & 0x7f800000u) == 0 ? __uint_as_float(u & 0x80000000u) : x;
}

// IEEE max and min in one instruction each: NaN if either operand is NaN
// (the canonical NaN, which is also what the plain version's a + b gives
// on the card), and -0.0 below +0.0.  The card tests hold them against the
// plain version on windows of NaN payloads and of zeros alternating in
// sign (tests/test_torch_cuda.py, chip_smoke.py phase 2).
__device__ __forceinline__ float ieee_max(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float ieee_min(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst),
               "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

template <int kMode>
__global__ void __launch_bounds__(32)
window_agg_kernel(const float* __restrict__ values,
                  const int* __restrict__ count, const Shape sh,
                  float* __restrict__ out_sum, float* __restrict__ out_mean,
                  float* __restrict__ out_max, float* __restrict__ out_min,
                  float* __restrict__ out_count) {
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t bars = smem_u32(smem);
  int* s_nv = reinterpret_cast<int*>(smem + kBarBytes);
  float* ring = reinterpret_cast<float*>(smem + kRingOffset);
  const int lane = threadIdx.x;
  const int group = blockIdx.x / sh.parts;
  const int part = blockIdx.x - group * sh.parts;
  const int n0 = group * sh.G;                   // this warp's first stream
  const int W = sh.W, C = sh.C, k = sh.chunk;

  // lane r < G holds stream n0 + r's count and valid entries, in [0, W]
  int cnt = 0, nv = 0;
  if (lane < sh.G && n0 + lane < sh.N) {
    cnt = count[n0 + lane];
    nv = cnt < 0 ? 0 : (cnt > W ? W : cnt);
  }
  s_nv[lane] = nv;
  const int limit = __reduce_max_sync(kFull, nv);   // this warp's longest
  const int g = lane / sh.Cw;                        // this lane's stream
  const int c = part * 32 + lane - g * sh.Cw;        // and channel
  const int from = g < sh.G ? g : 0;
  const int my_cnt = __shfl_sync(kFull, cnt, from);
  const int my_nv = __shfl_sync(kFull, nv, from);
  const bool mine = g < sh.G && n0 + g < sh.N && c < C;
  const int n_chunks = (limit + k - 1) / k;
  const int stage_floats = sh.G * sh.pitch;
  if (kMode == kBulk && lane == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(bars + 8u * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncwarp();

  // Stage chunk i (entries i k .. i k + k - 1 of every stream) into ring
  // stage i % kStages.  Every lane calls it.
  auto issue = [&](int i) {
    const int w0 = i * k;
    float* stage = ring + (i % kStages) * stage_floats;
    const float* base = values + ((size_t)n0 * W + w0) * C;
    if (kMode == kBulk) {
      const uint32_t bar = bars + 8u * (i % kStages);
      uint32_t bytes = 0;
      if (nv > w0)
        bytes = (uint32_t)(((nv - w0 < k ? nv - w0 : k) * C * 4 + 15) & ~15);
      const uint32_t total = __reduce_add_sync(kFull, bytes);
      if (lane == 0) mbar_expect_tx(bar, total);
      __syncwarp();
      if (bytes)
        bulk_copy_g2s(smem_u32(stage + lane * sh.pitch),
                      base + (size_t)lane * W * C, bytes, bar);
    } else {
      for (int r = 0; r < sh.G; ++r) {             // uniform over the warp
        const int v = s_nv[r] - w0;
        if (v <= 0) continue;
        const int e = v < k ? v : k;
        const float* src = base + (size_t)r * W * C;
        const uint32_t dst = smem_u32(stage + r * sh.pitch);
        for (int q = lane; q < e * C; q += 32) cp_async4(dst + 4u * q, src + q);
      }
      cp_async_commit();
    }
  };

  const int ahead = n_chunks < kStages ? n_chunks : kStages;
  for (int i = 0; i < ahead; ++i) issue(i);
  if (kMode != kBulk)
    for (int i = ahead; i < kStages; ++i) cp_async_commit();

  float s = 0.0f, mx = -kBig, mn = kBig;
  const float* col0 = ring + g * sh.pitch + c;    // read only when mine
  for (int i = 0; i < n_chunks; ++i) {
    const int w0 = i * k;
    if (kMode == kBulk) {
      mbar_wait(bars + 8u * (i % kStages), (i / kStages) & 1);
    } else {
      cp_async_wait<kStages - 1>();              // chunk i's group is done
      __syncwarp();
    }
    if (mine) {
      const float* col = col0 + (i % kStages) * stage_floats;
      const int end = my_nv - w0 < k ? my_nv - w0 : k;
      if (W == 1) {
        if (end > 0) s = mx = mn = col[0];
      } else {
        int j = 0;
        for (; j + 4 <= end; j += 4) {
          float x[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) x[u] = col[(j + u) * C];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float y = flush(x[u]);
            s = flush(__fadd_rn(s, y));
            mx = ieee_max(mx, y);
            mn = ieee_min(mn, y);
          }
        }
        for (; j < end; ++j) {
          const float y = flush(col[j * C]);
          s = flush(__fadd_rn(s, y));
          mx = ieee_max(mx, y);
          mn = ieee_min(mn, y);
        }
      }
    }
    __syncwarp();                                // the stage is read
    if (i + kStages < n_chunks)
      issue(i + kStages);
    else if (kMode != kBulk)
      cp_async_commit();                         // keep one group a chunk
  }
  if (!mine) return;
  if (W > 1 && my_nv < W) s = flush(__fadd_rn(s, 0.0f));
  const bool has = my_cnt > 0;
  const float cf = (float)my_cnt;
  const size_t o = (size_t)(n0 + g) * C + c;
  out_sum[o] = s;
  out_mean[o] = has ? flush(__fdiv_rn(flush(s), cf < 1.0f ? 1.0f : cf)) : 0.0f;
  out_max[o] = has ? mx : 0.0f;
  out_min[o] = has ? mn : 0.0f;
  out_count[o] = cf;
}

template <int kMode>
int launch(const float* values, const int* count, const Shape& sh,
           int blocks, int smem, float* const* out, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        window_agg_kernel<kMode>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  window_agg_kernel<kMode><<<blocks, 32, smem, stream>>>(
      values, count, sh, out[0], out[1], out[2], out[3], out[4]);
  return (int)cudaGetLastError();
}

}  // namespace

// The plan (chunk, pitch in bytes, streams per warp, warps per stream,
// staging, CTAs, shared bytes) comes from kernel.py's window_agg_plan; this
// checks that it describes the layout above before launching.
extern "C" int window_agg_launch(const void* values, const void* count,
                                 int N, int W, int C, int chunk,
                                 int pitch_bytes, int G, int parts,
                                 int staging, int blocks, int smem,
                                 void* out_sum, void* out_mean, void* out_max,
                                 void* out_min, void* out_count,
                                 void* stream) {
  const int Cw = C < 32 ? C : 32;
  const bool aligned = (W * C) % 4 == 0 &&
                       (reinterpret_cast<uintptr_t>(values) & 15u) == 0;
  if (N < 1 || W < 1 || C < 1 || chunk < 4 || chunk % 4 != 0 ||
      pitch_bytes % 16 != 0 || pitch_bytes < chunk * C * 4 || G < 1 ||
      G * Cw > 32 || parts != (C + 31) / 32 ||
      blocks != (N + G - 1) / G * parts ||
      smem != kRingOffset + kStages * G * pitch_bytes ||
      (staging == kBulk && !aligned) || staging < kBulk || staging > kLoad4)
    return (int)cudaErrorInvalidValue;
  const Shape sh{N, W, C, chunk, pitch_bytes / 4, G, Cw, parts};
  float* out[5] = {(float*)out_sum, (float*)out_mean, (float*)out_max,
                   (float*)out_min, (float*)out_count};
  const float* v = (const float*)values;
  const int* n = (const int*)count;
  const cudaStream_t st = (cudaStream_t)stream;
  if (staging == kBulk) return launch<kBulk>(v, n, sh, blocks, smem, out, st);
  return launch<kLoad4>(v, n, sh, blocks, smem, out, st);
}
