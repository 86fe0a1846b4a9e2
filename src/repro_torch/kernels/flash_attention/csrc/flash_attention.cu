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
// float32; q, k, v and o are float32 or bf16, o in q's type.  Masked
// probabilities are exact zeros.
//
// What bounds it on this card: operations.  Every allowed (i, j) pair costs
// 2 * Dh multiply-adds (q.k and p.v), against reading q, k, v once and
// writing o once; at gemma3-1b's global layer (B 2, H 4, L 4096, Dh 256)
// that is ~69 GFLOP against 42 MB, far above the card's ~295 operations per
// byte in bf16, so the bound is the tensor cores' bf16 rate.
//
// bf16 (flash_attention_wgmma_kernel): the products run on the tensor
// cores.  A CTA of three warpgroups takes 128 query rows of one (head,
// batch): warpgroups 0 and 1 each own 64 rows (consumers), warpgroup 2's
// first thread is the producer.  setmaxnreg moves registers from the
// producer (24 a thread) to the consumers (240), the CTA's 168 x 384.
//  - Tiles arrive by TMA (cp.async.bulk.tensor, 128-byte swizzle, 64
//    columns of the head dim a box) into shared memory: the q block once,
//    then k and v tiles of 64 keys through a ring of two stages, k and v
//    each with a "full" mbarrier (the bytes landed) and an "empty" one
//    (both consumers are done with it: k after S, v after P V).  TMA
//    zero-fills what lies past L or Dh, so ragged lengths and Dh below the
//    template width need no branch.  The host encodes one tensor map per
//    input from its strides (the model's (B, L, H, Dh) layout and
//    transposed views are read in place; the wrapper copies an input whose
//    base or strides break TMA's 16-byte rules first).
//  - S = Q K^T is wgmma m64n64k16 with both operands K-major in shared
//    memory; the scale (times log2 e) is applied to S before the row max;
//    p = 2^(s - m), masked entries -inf, so their p is exactly 0.  Tiles
//    wholly inside the causal/window band skip the mask.
//  - A consumer overlaps its tiles: S of tile j + 1 starts before P V
//    of tile j, so the tensor cores run S while tile j's P is split, and
//    P V while tile j + 1's softmax runs.
//  - O += P V takes P from registers as the A operand (the S
//    accumulator's layout is the A fragment's) and V N-major (transposed
//    B).  P goes in as two bf16 products into the same float32
//    accumulator, P_hi = bf16(p) and P_lo = bf16(p - P_hi): bf16 P alone
//    strays past one bf16 unit of the float32-P function the Pallas body
//    computes, the split holds it (tests/test_torch_flash_attention.py).
//    The row sum is taken from the float32 p.
//  - Blocks run longest band first (the last q block first, over every
//    head and batch), and a CTA walks only the key tiles that meet its
//    band; a consumer skips a tile outside its own 64 rows' band.
// Head-dim templates 64, 128 and 256 (at 256 the q block and two stages
// of k and v are 192 KB of shared memory).
//
// float32 (flash_attention_kernel): the scalar body, kept for the float32
// agreement gate (2e-5, which TF32 products cannot hold).  One CTA of 256
// threads per (64-row q block, q head, batch) stages the q block and
// 64-key tiles of k and v in shared memory and does its products with
// explicit fmaf (which -fmad=false leaves fused).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "../../csrc/hopper.cuh"

namespace {

constexpr float kNeg = -1e30f;

// ---------------------------------------------------------------- float32

constexpr int kThreads = 256;
constexpr int kBQ = 64;
constexpr int kBK = 64;
constexpr int kLoads = 8;                  // loads per thread in flight

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

// The q block is staged transposed ([d][row], rows padded by one float
// against bank conflicts), k transposed and v as rows; the 16 x 16 threads
// each own four query rows (ty + 16 i) and four keys (tx + 16 j) of the
// 64 x 64 score tile, and four rows by Dh / 16 columns of the accumulator.
template <int kDMax>
__global__ void __launch_bounds__(kThreads, 1) flash_attention_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o, int H, int KV,
    int Lq, int S, int Dh, int window, float scale, long long qsb,
    long long qsh, long long qsl, long long ksb, long long ksh,
    long long ksl, long long vsb, long long vsh, long long vsl,
    long long osb, long long osh, long long osl) {
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
  const float* qp = q + b * qsb + h * qsh;
  const float* kp = k + b * ksb + kvh * ksh;
  const float* vp = v + b * vsb + kvh * vsh;

  for (int e = tid; e < kBQ * Dh; e += kThreads) {
    const int r = e / Dh, d = e - r * Dh;
    const int qi = q0 + r;
    qt[d * (kBQ + 1) + r] = qi < Lq ? qp[qi * qsl + d] : 0.f;
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
        kr[u] = in ? kp[(k0 + c) * ksl + d] : 0.f;
        vr[u] = in ? vp[(k0 + c) * vsl + d] : 0.f;
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

  float* op = o + b * osb + h * osh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= Lq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int n = 0; n < kCols; ++n) {
      const int d = tx + 16 * n;
      if (d < Dh) op[qi * osl + d] = acc[i][n] / den;
    }
  }
}

template <int kDMax>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B,
               int H, int KV, int Lq, int S, int Dh, int window, float scale,
               const long long* st, cudaStream_t stream) {
  static bool configured = false;          // the 48 KB default is too small
  auto kern = flash_attention_kernel<kDMax>;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes(kDMax)));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid((Lq + kBQ - 1) / kBQ, H, B);
  kern<<<grid, kThreads, smem_bytes(Dh), stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), H, KV, Lq, S, Dh,
      window, scale, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], st[9], st[10], st[11]);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------------- bf16

constexpr int kBM = 128;                   // q rows a CTA: 2 consumers x 64
constexpr int kBN = 64;                    // keys a tile
constexpr int kStages = 2;
constexpr int kWgThreads = 128;
constexpr int kBoxCols = 64;               // 128 bytes of bf16: the swizzle
constexpr float kLog2e = 1.4426950408889634f;

template <int kD>
struct Tiles {
  static constexpr int kChunks = kD / kBoxCols;
  static constexpr int kQBytes = kBM * kD * 2;
  static constexpr int kKBytes = kBN * kD * 2;   // one k (or v) stage
  static constexpr int kBarOffset = kQBytes + 2 * kStages * kKBytes;
  // + 1024 to align the base for the swizzle, + the mbarriers
  static constexpr int kSmem = kBarOffset + 1024 + 8 * (4 * kStages + 1);
};

// Where a tensor map puts position, head and batch among its dims 1..3
// (dim 0 is the head dim); the host orders them by stride.
struct Slots {
  int pos, head, batch;
};

// One box of 64 head-dim columns by the map's rows at (col, pos, head, b).
__device__ __forceinline__ void tma_load(const CUtensorMap* map, uint32_t dst,
                                         uint32_t bar, int col, int pos,
                                         int head, int b, Slots sl) {
  const int c1 = sl.pos == 1 ? pos : sl.head == 1 ? head : b;
  const int c2 = sl.pos == 2 ? pos : sl.head == 2 ? head : b;
  const int c3 = sl.pos == 3 ? pos : sl.head == 3 ? head : b;
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// S <- Q K^T for one key tile (started and committed, not waited): 16
// head-dim columns a step; 64-column chunks of 128-byte rows, 8-row
// groups 1024 bytes apart.
template <int kD>
__device__ __forceinline__ void start_scores(float (&sc)[kBN / 2],
                                             uint32_t q_wg, uint32_t k_tile) {
  wgmma_fence();
#pragma unroll
  for (int kc = 0; kc < kD / 16; ++kc) {
    const uint32_t off = (kc / 4) * 128, in = (kc % 4) * 32;
    wgmma_ss(sc, smem_desc(q_wg + off * kBM + in, 16, 1024),
             smem_desc(k_tile + off * kBN + in, 16, 1024), kc > 0);
  }
  wgmma_commit();
}

// The online softmax of one tile of scores, in place: scale (in log2
// units) and mask (-inf outside the band, unless the tile lies wholly
// inside it), the new row maxima over the quad's 4 threads, p = 2^(s - m)
// (exact zeros where masked) and the row sums l = alpha l + sum p.  Rows
// row_a and row_a + 8, keys k0 + 8 j + col (+ 1).  Returns in alpha the
// factors the accumulator's rows take.
__device__ __forceinline__ void softmax_tile(
    float (&sc)[kBN / 2], int k0, int first, int last, int row_a, int col,
    int S, int window, float scale_log2, float (&m)[2], float (&l)[2],
    float (&alpha)[2]) {
  const bool inside = k0 + kBN - 1 <= first && k0 + kBN <= S &&
                      (window <= 0 || k0 > last - window);
  float mx[2] = {kNeg, kNeg};
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) {
    float x = sc[i] * scale_log2;
    if (!inside) {
      const int qi = row_a + 8 * ((i / 2) % 2);
      const int kj = k0 + 8 * (i / 4) + col + i % 2;
      const bool ok = kj < S && kj <= qi && (window <= 0 || kj > qi - window);
      x = ok ? x : __uint_as_float(0xff800000u);    // -inf
    }
    sc[i] = x;
    mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], x);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float mn = fmaxf(m[r], quad_max(mx[r]));
    alpha[r] = ex2(m[r] - mn);
    l[r] *= alpha[r];
    m[r] = mn;
  }
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) {
    sc[i] = ex2(sc[i] - m[(i / 2) % 2]);
    l[(i / 2) % 2] += sc[i];
  }
}

// O += P V for one key tile (started and committed, not waited), 16 keys a
// step: the step's P_hi = bf16(p), P_lo = bf16(p - P_hi) A fragments
// (pairs (i, i + 1) in order) are made just before its two products; V's
// 8-key groups 1024 bytes apart, its 64-column chunks kBN * 128 apart.
template <int kD>
__device__ __forceinline__ void start_pv(float (&acc)[kD / 2],
                                         const float (&p)[kBN / 2],
                                         uint32_t v_tile) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk) {
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float p0 = p[8 * kk + 2 * u], p1 = p[8 * kk + 2 * u + 1];
      hi[u] = bf16x2(p0, p1);
      const float2 back = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&hi[u]));
      lo[u] = bf16x2(p0 - back.x, p1 - back.y);
    }
    if (kk > 0) wgmma_fence();
    const uint64_t dv = smem_desc(v_tile + kk * 16 * 128, kBN * 128, 1024);
    wgmma_rs(acc, hi, dv);
    wgmma_rs(acc, lo, dv);
  }
  wgmma_commit();
}

template <int kD>
__global__ void __launch_bounds__(3 * kWgThreads, 1)
    flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                                 const __grid_constant__ CUtensorMap tk,
                                 const __grid_constant__ CUtensorMap tv,
                                 Slots sq, Slots sk, Slots sv,
                                 __nv_bfloat16* __restrict__ o, int H,
                                 int KV, int Lq, int S, int Dh, int window,
                                 float scale_log2, long long osb,
                                 long long osh, long long osl) {
  using T = Tiles<kD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_smem = base;            // [chunk][kBM rows][64], swizzled
  const uint32_t k_smem = base + T::kQBytes;          // [stage][chunk][kBN][64]
  const uint32_t v_smem = k_smem + kStages * T::kKBytes;
  // mbarriers: k full, v full, k empty, v empty (one per stage each), q
  const uint32_t bars = base + T::kBarOffset;
  auto full_k = [&](int s) { return bars + 8u * s; };
  auto full_v = [&](int s) { return bars + 8u * (kStages + s); };
  auto empty_k = [&](int s) { return bars + 8u * (2 * kStages + s); };
  auto empty_v = [&](int s) { return bars + 8u * (3 * kStages + s); };
  const uint32_t q_bar = bars + 8u * 4 * kStages;

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (static_cast<int>(gridDim.z) - 1 -
                  static_cast<int>(blockIdx.z)) * kBM;    // longest bands first
  const int kvh = h / (H / KV);
  const int q_last = min(q0 + kBM, Lq) - 1;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_begin = (k_lo / kBN) * kBN;
  const int k_hi = min(S, q_last + 1);     // causal: no key past the last row
  const int n_tiles = k_hi > k_begin ? (k_hi - k_begin + kBN - 1) / kBN : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty_k(s), 2);            // one arrival per consumer
      mbar_init(empty_v(s), 2);
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / kWgThreads;
  if (wg == 2) {
    // ------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (threadIdx.x == 2 * kWgThreads) {
      mbar_expect_tx(q_bar, T::kQBytes);
      for (int c = 0; c < T::kChunks; ++c)
        tma_load(&tq, q_smem + c * kBM * 128, q_bar, c * kBoxCols, q0, h, b,
                 sq);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        const uint32_t ph = (it / kStages) & 1;
        const int k0 = k_begin + it * kBN;
        mbar_wait(empty_k(s), ph ^ 1);
        mbar_expect_tx(full_k(s), T::kKBytes);
        for (int c = 0; c < T::kChunks; ++c)
          tma_load(&tk, k_smem + s * T::kKBytes + c * kBN * 128, full_k(s),
                   c * kBoxCols, k0, kvh, b, sk);
        mbar_wait(empty_v(s), ph ^ 1);
        mbar_expect_tx(full_v(s), T::kKBytes);
        for (int c = 0; c < T::kChunks; ++c)
          tma_load(&tv, v_smem + s * T::kKBytes + c * kBN * 128, full_v(s),
                   c * kBoxCols, k0, kvh, b, sv);
      }
    }
  } else {
    // ------------------------------------------------------- consumer
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
    const int t = threadIdx.x % kWgThreads;
    const int warp = t / 32, lane = t % 32;
    const int first = q0 + 64 * wg;        // this warpgroup's 64 rows
    const int last = first + 63;
    const int row_a = first + 16 * warp + lane / 4;    // and row_a + 8
    const int col = 2 * (lane % 4);        // + 8 j (+ 1) in a tile
    const uint32_t q_wg = q_smem + wg * 64 * 128;
    auto phase = [](int it) { return static_cast<uint32_t>(it / kStages) & 1; };
    auto release = [&](uint32_t bar) {
      if (t == 0) mbar_arrive(bar);
    };
    // the tiles [lo, hi) meet this warpgroup's band; the others are only
    // waited for and released
    int lo = 0, hi = n_tiles;
    while (lo < hi && window > 0 &&
           k_begin + lo * kBN + kBN - 1 <= first - window)
      ++lo;
    while (hi > lo && k_begin + (hi - 1) * kBN > last) --hi;
    auto pass = [&](int it) {
      mbar_wait(full_k(it % kStages), phase(it));
      release(empty_k(it % kStages));
      mbar_wait(full_v(it % kStages), phase(it));
      release(empty_v(it % kStages));
    };

    float acc[kD / 2];
#pragma unroll
    for (int i = 0; i < kD / 2; ++i) acc[i] = 0.f;
    float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f}, alpha[2];
    mbar_wait(q_bar, 0);
    for (int it = 0; it < lo; ++it) pass(it);
    if (lo < hi) {
      // S of the first tile alone; then, per tile j, S of tile j + 1 runs
      // on the tensor cores while tile j's P is split, and P V of tile j
      // while tile j + 1's softmax runs
      float p[kBN / 2];
      mbar_wait(full_k(lo % kStages), phase(lo));
      start_scores<kD>(p, q_wg, k_smem + (lo % kStages) * T::kKBytes);
      wgmma_wait<0>();
      fence_regs(p);
      release(empty_k(lo % kStages));
      softmax_tile(p, k_begin + lo * kBN, first, last, row_a, col, S,
                        window, scale_log2, m, l, alpha);
      // tile j's probabilities in cur, tile j + 1's scores into nxt (the
      // two arrays swap roles from one tile to the next, never copied);
      // every step has the same wgmma groups in flight, so that ptxas can
      // tell which one each wait retires
      auto step = [&](int j, float (&cur)[kBN / 2], float (&nxt)[kBN / 2]) {
        const int s = j % kStages, sn = (j + 1) % kStages;
        mbar_wait(full_k(sn), phase(j + 1));
        start_scores<kD>(nxt, q_wg, k_smem + sn * T::kKBytes);
        mbar_wait(full_v(s), phase(j));
        start_pv<kD>(acc, cur, v_smem + s * T::kKBytes);
        wgmma_wait<1>();
        fence_regs(nxt);
        release(empty_k(sn));
        softmax_tile(nxt, k_begin + (j + 1) * kBN, first, last, row_a,
                          col, S, window, scale_log2, m, l, alpha);
        wgmma_wait<0>();
        fence_regs(acc);
        release(empty_v(s));
#pragma unroll
        for (int i = 0; i < kD / 2; ++i) acc[i] *= alpha[(i / 2) % 2];
      };
      auto final_step = [&](int j, float (&cur)[kBN / 2]) {
        mbar_wait(full_v(j % kStages), phase(j));
        start_pv<kD>(acc, cur, v_smem + (j % kStages) * T::kKBytes);
        wgmma_wait<0>();
        fence_regs(acc);
        release(empty_v(j % kStages));
      };
      float p2[kBN / 2];
      int j = lo;
      for (; j + 2 < hi; j += 2) {
        step(j, p, p2);
        step(j + 1, p2, p);
      }
      if (j + 1 < hi) {
        step(j, p, p2);
        final_step(j + 1, p2);
      } else {
        final_step(j, p);
      }
    }
    for (int it = hi; it < n_tiles; ++it) pass(it);

    // o = acc / l, rows row_a and row_a + 8, columns 8 j + col (+ 1)
    const float den[2] = {fmaxf(quad_sum(l[0]), 1e-30f),
                          fmaxf(quad_sum(l[1]), 1e-30f)};
    __nv_bfloat16* op = o + b * osb + h * osh;
    const bool pairs = (Dh % 2) == 0;
#pragma unroll
    for (int i = 0; i < kD / 2; i += 2) {
      const int qi = row_a + 8 * ((i / 2) % 2);
      const int d = 8 * (i / 4) + col;
      if (qi >= Lq || d >= Dh) continue;
      __nv_bfloat16* dst = op + qi * osl + d;
      const float x0 = acc[i] / den[(i / 2) % 2];
      const float x1 = acc[i + 1] / den[(i / 2) % 2];
      if (pairs) {
        *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x0, x1);
      } else {
        dst[0] = __float2bfloat16_rn(x0);
        if (d + 1 < Dh) dst[1] = __float2bfloat16_rn(x1);
      }
    }
  }
}

// A 4-d tensor map of a bf16 (B, L, heads, Dh) operand read in place: dim 0
// the head dim, dims 1..3 position, head and batch in the order of their
// strides (a dim of size 1 last), a box of 64 columns by `rows` positions,
// 128-byte swizzle, zero fill past the ends.  The rules are those of
// kernel.py's reads_in_place: 16-byte aligned base and strides of the
// dims of size > 1, each at least the extent of the dims inside it.
bool encode(CUtensorMap* map, const void* ptr, int Dh, int L, int heads,
            int B, long long sl, long long sh, long long sb, int rows,
            Slots* slots) {
  EncodeFn fn = encode_fn();
  if (fn == nullptr || reinterpret_cast<uintptr_t>(ptr) % 16) return false;
  long long size[3] = {L, heads, B}, stride[3] = {sl, sh, sb};
  int order[3] = {0, 1, 2};
  auto key = [&](int d) { return size[d] == 1 ? (1ll << 62) : stride[d]; };
  for (int i = 0; i < 3; ++i)              // insertion sort of three
    for (int j = i; j > 0 && key(order[j]) < key(order[j - 1]); --j) {
      const int t = order[j];
      order[j] = order[j - 1];
      order[j - 1] = t;
    }
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(Dh), 0, 0, 0};
  cuuint64_t strides[3];
  cuuint32_t box[4] = {kBoxCols, 1, 1, 1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  long long extent = 2ll * Dh;             // bytes spanned by the dims inside
  int slot_of[3];
  for (int i = 0; i < 3; ++i) {
    const int d = order[i];
    long long st = 2 * stride[d];
    if (size[d] == 1) st = (extent + 15) / 16 * 16;
    if (st % 16 || st < extent || st >= (1ll << 40)) return false;
    dims[i + 1] = static_cast<cuuint64_t>(size[d]);
    strides[i] = static_cast<cuuint64_t>(st);
    if (d == 0) box[i + 1] = static_cast<cuuint32_t>(rows);
    slot_of[d] = i + 1;
    extent = st * size[d];
  }
  slots->pos = slot_of[0];
  slots->head = slot_of[1];
  slots->batch = slot_of[2];
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int kD>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int B,
                int H, int KV, int Lq, int S, int Dh, int window, float scale,
                const long long* st, cudaStream_t stream) {
  static bool configured = false;
  auto kern = flash_attention_wgmma_kernel<kD>;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Tiles<kD>::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  CUtensorMap tq, tk, tv;
  Slots sq, sk, sv;
  if (!encode(&tq, q, Dh, Lq, H, B, st[2], st[1], st[0], kBM, &sq) ||
      !encode(&tk, k, Dh, S, KV, B, st[5], st[4], st[3], kBN, &sk) ||
      !encode(&tv, v, Dh, S, KV, B, st[8], st[7], st[6], kBN, &sv))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(H, B, (Lq + kBM - 1) / kBM);
  kern<<<grid, 3 * kWgThreads, Tiles<kD>::kSmem, stream>>>(
      tq, tk, tv, sq, sk, sv, static_cast<__nv_bfloat16*>(o), H, KV, Lq, S,
      Dh, window, scale * kLog2e, st[9], st[10], st[11]);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Dynamic shared memory of the bf16 kernel at head dim Dh (bytes).
extern "C" int flash_attention_bf16_smem(int Dh) {
  return Dh <= 64 ? Tiles<64>::kSmem
                  : Dh <= 128 ? Tiles<128>::kSmem : Tiles<256>::kSmem;
}

// strides: 12 element strides, (batch, head, position) of q, k, v and o;
// the head dim is contiguous.  dtype 0: float32, 1: bf16 (q, k, v bases
// and strides meeting TMA's 16-byte rules).  window <= 0: none.
// Returns a cudaError_t code (0 = launched).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int dtype,
                                      int B, int H, int KV, int Lq, int S,
                                      int Dh, int window, float scale,
                                      const long long* st, void* stream) {
  if (Dh < 1 || Dh > 256 || KV < 1 || H % KV != 0 || Lq < 1 || S < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (Dh <= 64)
      return launch_f32<64>(q, k, v, o, B, H, KV, Lq, S, Dh, window, scale,
                            st, s);
    if (Dh <= 128)
      return launch_f32<128>(q, k, v, o, B, H, KV, Lq, S, Dh, window, scale,
                             st, s);
    return launch_f32<256>(q, k, v, o, B, H, KV, Lq, S, Dh, window, scale,
                           st, s);
  }
  if (dtype == 1) {
    if (Dh <= 64)
      return launch_bf16<64>(q, k, v, o, B, H, KV, Lq, S, Dh, window, scale,
                             st, s);
    if (Dh <= 128)
      return launch_bf16<128>(q, k, v, o, B, H, KV, Lq, S, Dh, window, scale,
                              st, s);
    return launch_bf16<256>(q, k, v, o, B, H, KV, Lq, S, Dh, window, scale,
                            st, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
