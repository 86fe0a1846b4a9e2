// mlstm_chunk: the chunkwise-parallel mLSTM from the zero state, written
// for Hopper (sm_90a), its products on the tensor cores.
//
// Replaces: src/repro/kernels/mlstm_chunk/kernel.py, mlstm_chunkwise
// (Pallas body _mlstm_kernel) of the JAX package.
//
// Inputs as the model plane's mlstm_block builds them: q, k, v
// (B, H, L, Dh) float32 or bf16, read through a (row, matrix) layout (see
// Layout), i_raw and f_raw (B*H, L) float32.  Outputs h (B*H, L, Dh)
// float32 and the final state C (B*H, Dh, Dh), n (B*H, Dh), m (B*H),
// float32.  The sequence is cut into chunks of ck positions (the last one
// may be shorter); any chunking computes the same function.
//
// What bounds it on this card.  Per (b, h, chunk) it needs S = q k^T and
// (S.D) v over the causal half of the chunk (2 Dh ck (ck+1) each), q C0^T
// (2 ck Dh^2, none in the first chunk) and the state update (2 ck Dh^2):
// at xlstm-1.3b's layer (B 2, H 4, L 4096, Dh 1024, ck 256) 150.4 GFLOP,
// 0.152 ms at the 989 TFLOP/s bf16 tensor-core peak.  Its compulsory
// bytes (q, k, v read once, h and the final state written once) are 0.57
// GB for float32 inputs (0.17 ms at 3.35 TB/s: the bytes bound it) and
// 0.37 GB for bf16 inputs (0.11 ms: the operations bound it).  The design
// below adds the piece products' tensor work and its own traffic: the
// pieces, and the chunk-start states written and read once (755 MB).
//
// Precision.  The products run as bf16 wgmma with float32 accumulators.
// One bf16 rounding of an operand, or TF32, breaks the 3e-4 gate over Dh
// 1024; an operand that is not bf16-exact is split into three bf16 pieces
// x = hi + mid + lo (each the rounding of what the ones before leave; the
// remainders are exact in float32), and a product sums the piece pairs
// (i, j) with i + j <= 2: six products for two split operands, three where
// one operand is exact, one where both are (tests/test_torch_mlstm.py
// emulates this).  bf16 q, k, v (the bf16 prefill) are exact and are read
// as they are; w v, S.D and the chunk-start states are always split.  The
// tensor cores' accumulation is not IEEE float32: one accumulator over all
// of K = 1,024 drifted on the card to about twice the plain version's
// distance from the float64 oracle at Dh 1,024, so each stage (K = 64)
// sums its piece pairs, the smallest first, into a fresh accumulator that
// is then added to the running sum in float32.  The tensor work is 902
// GFLOP (0.91 ms at peak) for float32 inputs and 434 GFLOP (0.44 ms) for
// bf16 inputs.
//
// Why it is not the Pallas body: that kernel keeps the whole (Dh, Dh)
// matrix memory in VMEM for the sequence, one grid row per (b, h) with
// the chunks in order.  At Dh 1024 that state is 4 MB, and a CTA has at
// most 227 KB of shared memory.  So the work is five launches:
//
//  0. gate: one CTA per (b, h) over the whole sequence.  The in-chunk
//     cumulative log forget gate b (one thread per chunk, in order, as a
//     sequential cumsum), the intra-chunk stabiliser max_j (b_t - b_j) +
//     i_j, the running stabiliser m chained across chunks, and per
//     position m_t, the inter-chunk weight exp(b + m0 - m_t) and the
//     end-of-chunk weight w = exp(b_last - b + i - m_new); per chunk the
//     state scale exp(b_last + m0 - m_new).  O(L ck) scalar work.
//  1. prep: one thread per (b, h, chunk, two columns) over the chunk's rows
//     writes the bf16 pieces the products read: those of w v (in a
//     chunk-padded layout whose rows past the chunk are zeros) and, for
//     float32 inputs, those of q, k and v; and the chunk's part of n,
//     sum_j w_j k_j.  The pieces are made once in device memory rather than
//     by the consumers after each tile lands: every product then reads
//     TMA tiles only, at the price of the pieces' bytes (1.2 GB moved for
//     float32 inputs at xlstm-1.3b's layer, 0.34 GB for bf16).
//  2. state: one CTA per (b, h, 128 x 128 tile of C) walks the chunks in
//     order with its tile in the accumulators, scales it by the chunk's s
//     and accumulates sum_j (w_j v_j)^T k_j, A = w v M-major and B = k
//     N-major (both transposed reads of the row-major tiles).  Every
//     chunk's starting state (chunks 1..nc-1, 755 MB at xlstm-1.3b's
//     layer) goes to the out pass as three bf16 pieces by TMA stores from
//     a swizzled staging tile, issued while the chunk's first products
//     run: written as 4-byte stores from the accumulators they took most
//     of this pass's time.  The CTAs of the first row of tiles chain n
//     alike.  The final C is written in float32.
//  3. intra: one CTA per (b, h, chunk, 128 rows) computes S = q k^T over
//     128-key tiles up to its last row (both K-major), scales and decays
//     it in registers (masked entries exact zeros, no exp of a masked
//     argument), writes S.D as three bf16 pieces and the row sums, and
//     q.n0 for the chunk's starting n from the q tiles in shared memory
//     while the first key tile's products run.
//  4. out: one CTA per (b, h, chunk, 128 rows, 128 columns of h):
//     q C0^T (both K-major) scaled by the inter-chunk weight, then + (S.D)
//     v (S.D K-major, v N-major) in the same accumulators; den = row sum +
//     inter q.n0, h = num / max(|den|, exp(-m_t)).
//
// Launches 2-4 are warp-specialised CTAs of three warpgroups: warpgroup
// 2's first thread is the TMA producer (setmaxnreg 40), warpgroups 0 and 1
// the consumers (232), each owning 64 rows of the 128-row output tile.
// Tiles arrive by TMA (cp.async.bulk.tensor, 128-byte swizzle, boxes of 64
// bf16 columns) through a ring of 192 KB, each stage the pieces of both
// operands for K = 64 (two stages for float32 inputs, three or six for
// bf16 ones), with a "full" mbarrier (the bytes landed) and an "empty"
// one (both consumers are done with it).  TMA zero-fills past the
// sequence and past Dh, so ragged lengths and small Dh need no branch; a
// box that lies wholly past Dh is not loaded, since only output rows and
// columns that are never stored read it.  The state pass takes its
// chunks in order and nothing uses atomics, so repeated launches are
// bitwise equal.  Products are m64n128k16; the state scale, the decay and
// the epilogues are float32 CUDA-core work (the build's -fmad=false keeps
// their a*b+c as the plain version computes them, a multiply and an add).
// Scratch (the gate vectors, the pieces, the chunk-start states, S.D) is
// allocated by the caller.
#include "../../csrc/hopper.cuh"

namespace {

constexpr float kNeg = -1e30f;
constexpr int kGateThreads = 1024;
constexpr int kPrepThreads = 128;
constexpr int kPrepGroups = 4;            // row groups of a chunk in prep
constexpr int kWg = 128;                  // threads of a warpgroup
constexpr int kThreads = 3 * kWg;         // two consumers and the producer
constexpr int kTile = 128;                // rows and columns of an output tile
constexpr int kBox = 64;                  // bf16 columns of a box: 128 bytes
constexpr int kHalf = 64 * 128;           // bytes of a 64-row box
constexpr int kPiece = kTile * 128;       // bytes of a 128-row box: one piece
// Each kernel's ring fills kRing bytes with as many stages as fit: a stage
// holds the pieces of A, then those of B (float32 inputs: 96 KB, two
// stages; bf16 inputs carry one piece of q, k or v and get three to six)
constexpr int kRing = 2 * 6 * kPiece;
constexpr int kJ = 64;                    // rows of j a stage of the state pass
constexpr int kJHalf = kJ * 128;          // bytes of a kJ-row box
// the state pass stages one piece of its chunk-start state at a time for
// its TMA stores: two consumers' 64 x 128 bf16 tiles
constexpr int kStaging = 2 * 2 * kHalf;
constexpr int kMaxStages = 8;
constexpr int kBarOffset = kRing + kStaging;
constexpr int kSmem = kBarOffset + 1024 + 16 * kMaxStages;
static_assert(kSmem <= 232448, "a CTA's dynamic shared memory");

template <int kStageBytes>
constexpr int kRingStages =
    kRing / kStageBytes < kMaxStages ? kRing / kStageBytes : kMaxStages;

// Where an input's element (b, h, row, d) lies: ((b mb + h mh) L + row) rs
// + d, so both the (B, H, L, Dh) layout (mb = H, mh = 1) and the one an
// einsum leaves, heads outermost (mb = 1, mh = B), are read in place.
struct Layout {
  long long rs;
  int mb, mh;
};

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

// x0 and x1 as three bf16x2 pieces: p[0] = bf16(x), p[1] = bf16(x - p[0]),
// p[2] = bf16(x - p[0] - p[1]), each remainder exact in float32.
__device__ __forceinline__ void split3(float x0, float x1, uint32_t (&p)[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const __nv_bfloat162 b = __floats2bfloat162_rn(x0, x1);
    p[i] = *reinterpret_cast<const uint32_t*>(&b);
    const float2 back = __bfloat1622float2(b);
    x0 = x0 - back.x;
    x1 = x1 - back.y;
  }
}

__device__ __forceinline__ long long in_row(Layout l, int bh, int H, int L,
                                            int t) {
  const int mat = (bh / H) * l.mb + (bh % H) * l.mh;
  return (static_cast<long long>(mat) * L + t) * l.rs;
}

// One box of 64 columns by the map's box rows at (col, row, mat, piece).
__device__ __forceinline__ void tma_load(const CUtensorMap* map, uint32_t dst,
                                         uint32_t bar, int col, int row,
                                         int mat, int piece) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(mat),
      "r"(piece), "r"(bar)
      : "memory");
}

// One box from shared memory to the map's (col, row, mat, piece), in the
// calling thread's bulk async-group; the box is clipped at the ends.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int col, int row, int mat,
                                          int piece) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, "
      "%4, %5}], [%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(col), "r"(row), "r"(mat), "r"(piece)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Waits until this thread's bulk stores have read their shared memory
// (kRead) or completed.
template <bool kRead>
__device__ __forceinline__ void bulk_wait() {
  if constexpr (kRead)
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  else
    asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// Barrier of one consumer warpgroup (ids 1 and 2; 0 is __syncthreads).
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;" ::"r"(wg + 1) : "memory");
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// A ring of kS stages of kBytes each in dynamic shared memory, each stage
// with a "full" and an "empty" mbarrier; ring_init sets them up (the
// CTA's prologue, before the role split).
template <int kS, int kBytes>
struct Ring {
  uint32_t base, bars;
  __device__ uint32_t stage(int it) const {
    return base + static_cast<uint32_t>(it % kS) * kBytes;
  }
  __device__ uint32_t full(int it) const { return bars + 8u * (it % kS); }
  __device__ uint32_t empty(int it) const {
    return bars + 8u * (kS + it % kS);
  }
  __device__ static uint32_t phase(int it) {
    return static_cast<uint32_t>(it / kS) & 1;
  }
};

template <int kS, int kBytes>
__device__ __forceinline__ Ring<kS, kBytes> ring_init(uint8_t* smem_raw) {
  static_assert(kS >= 1 && kS * kBytes <= kRing, "the ring fits");
  Ring<kS, kBytes> r;
  r.base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  r.bars = r.base + kBarOffset;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kS; ++s) {
      mbar_init(r.bars + 8u * s, 1);
      mbar_init(r.bars + 8u * (kS + s), 2);   // one per consumer
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  return r;
}

// Producer side of one stage: wait until both consumers released it, then
// announce the bytes its loads will bring.
template <typename R>
__device__ __forceinline__ uint32_t produce(const R& r, int it,
                                            uint32_t bytes) {
  mbar_wait(r.empty(it), R::phase(it) ^ 1);
  mbar_expect_tx(r.full(it), bytes);
  return r.stage(it);
}

// part = A . B over one stage (issued, not waited for): K = 16 kSteps, the
// piece pairs (a, b) with a + b <= 2, summed into a fresh accumulator,
// the smallest pairs (a + b = 2) first; finish_products then adds it to
// the running sum in float32: the tensor cores'
// own accumulation is not IEEE float32, and a chain over all of K (1,024
// rows at Dh 1,024) drifts.  A piece a at stage + a kPieceA (+ the
// consumer's 64 rows or columns), B piece b at stage + 3 kPieceA + b
// kPieceB.  kTA: A M-major (a box of 64 columns of M per consumer, K rows
// of 128 bytes); else K-major (128 rows of 128 bytes).  kTB: B N-major
// (two boxes, 64 columns of N each, kHalfB bytes apart); else K-major.
template <int kNa, int kNb, int kTA, int kTB, int kSteps, int kPieceA,
          int kPieceB, int kHalfB>
__device__ __forceinline__ void issue_products(float (&part)[64],
                                               uint32_t st, int wg) {
#pragma unroll
  for (int i = 0; i < 64; ++i) part[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int lvl = 2; lvl >= 0; --lvl) {
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
#pragma unroll
      for (int a = 0; a < kNa; ++a) {
#pragma unroll
        for (int b = 0; b < kNb; ++b) {
          if (a + b != lvl) continue;
          const uint32_t pa = st + a * kPieceA + wg * (kPieceA / 2);
          const uint32_t pb = st + kNa * kPieceA + b * kPieceB;
          const uint64_t da = kTA ? smem_desc(pa + kk * 2048, kPieceA / 2, 1024)
                                  : smem_desc(pa + kk * 32, 16, 1024);
          const uint64_t db = kTB ? smem_desc(pb + kk * 2048, kHalfB, 1024)
                                  : smem_desc(pb + kk * 32, 16, 1024);
          wgmma_n128<kTA, kTB>(part, da, db);
        }
      }
    }
  }
  wgmma_commit();
}

// Waits for the products issued into part and adds them to acc.
__device__ __forceinline__ void finish_products(float (&acc)[64],
                                                float (&part)[64]) {
  wgmma_wait<0>();
  fence_regs(part);
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = acc[i] + part[i];
}

// Consumer side of one stage: wait for its bytes, run the products,
// release it.
template <int kNa, int kNb, int kTA, int kTB, int kSteps = 4,
          int kPieceA = kPiece, int kPieceB = kPiece, int kHalfB = kHalf,
          typename R>
__device__ __forceinline__ void consume(const R& r, int it, float (&acc)[64],
                                        int wg, int t) {
  float part[64];
  mbar_wait(r.full(it), R::phase(it));
  issue_products<kNa, kNb, kTA, kTB, kSteps, kPieceA, kPieceB, kHalfB>(
      part, r.stage(it), wg);
  finish_products(acc, part);
  if (t == 0) mbar_arrive(r.empty(it));
}

// The accumulator's element i lies at row row + 8 ((i / 2) % 2), column
// col + 8 (i / 4) (+ i % 2) of the warpgroup's 64 x 128 tile.
__device__ __forceinline__ int acc_row(int i) { return 8 * ((i / 2) % 2); }
__device__ __forceinline__ int acc_col(int i) { return 8 * (i / 4) + i % 2; }

// ---------------------------------------------------------------- 0. gate
__global__ void __launch_bounds__(kGateThreads) mlstm_gate_kernel(
    const float* __restrict__ i_raw, const float* __restrict__ f_raw,
    float* bcum, float* mt, float* inter, float* wj, float* mchain,
    float* cscale, float* mout, int L, int ck, int nc) {
  const long long base = static_cast<long long>(blockIdx.x) * L;
  const float* ir = i_raw + base;
  const float* fr = f_raw + base;
  float* bc = bcum + base;
  float* mp = mt + base;
  float* mc = mchain + static_cast<long long>(blockIdx.x) * (nc + 1);
  for (int c = threadIdx.x; c < nc; c += blockDim.x) {
    const int t1 = min((c + 1) * ck, L);
    float s = 0.f;
    for (int t = c * ck; t < t1; ++t) {
      s = s + log_sigmoid(fr[t]);
      bc[t] = s;
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < L; t += blockDim.x) {
    const float bt = bc[t];
    float mx = kNeg;
    for (int j = (t / ck) * ck; j <= t; ++j) mx = fmaxf(mx, (bt - bc[j]) + ir[j]);
    mp[t] = mx;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float m0 = kNeg;
    for (int c = 0; c < nc; ++c) {
      const int last = min((c + 1) * ck, L) - 1;
      const float m_new = fmaxf(bc[last] + m0, mp[last]);
      cscale[static_cast<long long>(blockIdx.x) * nc + c] =
          expf((bc[last] + m0) - m_new);
      mc[c] = m0;
      m0 = m_new;
    }
    mc[nc] = m0;
    mout[blockIdx.x] = m0;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < L; t += blockDim.x) {
    const int c = t / ck;
    const int last = min((c + 1) * ck, L) - 1;
    const float b = bc[t], m0 = mc[c], m_new = mc[c + 1];
    const float m = fmaxf(b + m0, mp[t]);
    mp[t] = m;
    inter[base + t] = expf((b + m0) - m);
    wj[base + t] = expf(((bc[last] - b) + ir[t]) - m_new);
  }
}

// ---------------------------------------------------------------- 1. prep
// One thread per two columns d, d + 1 of one (b, h, chunk, group of ckp /
// kPrepGroups rows).  wvp: (3, BH, nc ckp, D8) pieces of w v, the rows past
// the chunk zero; qkvp (float32 inputs): (9, BH, L, D8) pieces of q, k, v;
// npart: (BH, nc, kPrepGroups, Dh) the group's sum_j w_j k_j.
template <bool kBf16>
__device__ __forceinline__ float2 load2(const void* p, long long off) {
  if constexpr (kBf16)
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
        static_cast<const __nv_bfloat16*>(p) + off));
  else
    return *reinterpret_cast<const float2*>(static_cast<const float*>(p) + off);
}

template <bool kBf16>
__global__ void __launch_bounds__(kPrepThreads) mlstm_prep_kernel(
    const void* __restrict__ q, const void* __restrict__ k,
    const void* __restrict__ v, Layout lq, Layout lk, Layout lv,
    const float* __restrict__ wj, __nv_bfloat16* __restrict__ qkvp,
    __nv_bfloat16* __restrict__ wvp, float* __restrict__ npart, int H,
    int L, int Dh, int D8, int ck, int ckp, int nc) {
  const int d = 2 * (blockIdx.x * kPrepThreads + threadIdx.x);
  const int c = blockIdx.y / kPrepGroups, grp = blockIdx.y % kPrepGroups;
  const int bh = blockIdx.z;
  if (d >= Dh) return;
  const int t0 = c * ck, len = min(ck, L - t0);
  const int j_lo = grp * (ckp / kPrepGroups), j_hi = j_lo + ckp / kPrepGroups;
  const long long BH = gridDim.z;
  const long long piece = BH * L * D8;
  const long long wpiece = BH * nc * ckp * D8;
  auto* wv = reinterpret_cast<uint32_t*>(
      wvp + (static_cast<long long>(bh) * nc + c) * ckp * D8 + d);
  float n0 = 0.f, n1 = 0.f;
#pragma unroll 4
  for (int j = j_lo; j < min(j_hi, len); ++j) {
    const int t = t0 + j;
    const float w = wj[static_cast<long long>(bh) * L + t];
    const float2 kv = load2<kBf16>(k, in_row(lk, bh, H, L, t) + d);
    const float2 vv = load2<kBf16>(v, in_row(lv, bh, H, L, t) + d);
    n0 = n0 + w * kv.x;
    n1 = n1 + w * kv.y;
    uint32_t pc[3];
    split3(w * vv.x, w * vv.y, pc);
#pragma unroll
    for (int p = 0; p < 3; ++p) wv[(p * wpiece + j * D8) / 2] = pc[p];
    if constexpr (!kBf16) {
      const float2 qv = load2<false>(q, in_row(lq, bh, H, L, t) + d);
      auto* o = reinterpret_cast<uint32_t*>(
          qkvp + (static_cast<long long>(bh) * L + t) * D8 + d);
      const float2 xs[3] = {qv, kv, vv};
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        split3(xs[m].x, xs[m].y, pc);
#pragma unroll
        for (int p = 0; p < 3; ++p) o[(3 * m + p) * piece / 2] = pc[p];
      }
    }
  }
  for (int j = max(j_lo, len); j < j_hi; ++j)
#pragma unroll
    for (int p = 0; p < 3; ++p) wv[(p * wpiece + j * D8) / 2] = 0u;
  float* np = npart + ((static_cast<long long>(bh) * nc + c) * kPrepGroups +
                       grp) * Dh + d;
  np[0] = n0;
  np[1] = n1;
}

// --------------------------------------------------------------- 2. state
// Maps: tw (w v pieces: Dh x nc ckp rows x BH x 3, kJ-row boxes), tk (k
// or its pieces: Dh x L x B H x kNk, kJ-row boxes; matrix b mbk + h mhk),
// tc (the pieces of every chunk-start state after the first: Dh x Dh rows
// x BH (nc - 1) x 3, 64-row boxes, stored).  nstart (BH, nc - 1, Dh);
// cout (BH, Dh, Dh), nout (BH, Dh).
template <bool kBf16>
__global__ void __launch_bounds__(kThreads, 1) mlstm_state_kernel(
    const __grid_constant__ CUtensorMap tw,
    const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tc, int mbk, int mhk,
    const float* __restrict__ cscale, const float* __restrict__ npart,
    float* __restrict__ nstart,
    float* __restrict__ cout, float* __restrict__ nout, int H, int L,
    int Dh, int D8, int ck, int ckp, int nc) {
  constexpr int kNk = kBf16 ? 1 : 3;
  constexpr int kSB = (6 + 2 * kNk) * kJHalf;
  extern __shared__ uint8_t smem_raw[];
  const auto r = ring_init<kRingStages<kSB>, kSB>(smem_raw);
  const int dk0 = blockIdx.x * kTile, dv0 = blockIdx.y * kTile;
  const int bh = blockIdx.z;
  const int wg = threadIdx.x / kWg;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x != 2 * kWg) return;
    const int mat_k = (bh / H) * mbk + (bh % H) * mhk;
    const int na = dv0 + kBox < Dh ? 2 : 1, nb = dk0 + kBox < Dh ? 2 : 1;
    const uint32_t bytes = (3 * na + kNk * nb) * kJHalf;
    int it = 0;
    for (int c = 0; c < nc; ++c) {
      const int len = min(ck, L - c * ck);
      for (int j0 = 0; j0 < len; j0 += kJ, ++it) {
        const uint32_t st = produce(r, it, bytes);
        for (int p = 0; p < 3; ++p)
          for (int h = 0; h < na; ++h)
            tma_load(&tw, st + (2 * p + h) * kJHalf, r.full(it),
                     dv0 + h * kBox, c * ckp + j0, bh, p);
        for (int p = 0; p < kNk; ++p)
          for (int h = 0; h < nb; ++h)
            tma_load(&tk, st + (6 + 2 * p + h) * kJHalf, r.full(it),
                     dk0 + h * kBox, c * ck + j0, mat_k, p);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  const int t = threadIdx.x % kWg, warp = t / 32, lane = t % 32;
  const int row = dv0 + 64 * wg + 16 * warp + lane / 4;
  const int col = dk0 + 2 * (lane % 4);
  // this consumer's staging tile: two 64-column boxes, 128-byte swizzle
  const uint32_t stg = r.base + kRing + wg * 2 * kHalf;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  int it = 0;
  for (int c = 0; c < nc; ++c) {
    const int len = min(ck, L - c * ck);
    for (int j0 = 0; j0 < len; j0 += kJ, ++it) {
      float part[64];
      mbar_wait(r.full(it), r.phase(it));
      issue_products<3, kNk, 1, 1, kJ / 16, 2 * kJHalf, 2 * kJHalf, kJHalf>(
          part, r.stage(it), wg);
      if (j0 == 0) {
        // under the chunk's first products: its starting state (c > 0) to
        // the out pass, as three bf16 pieces by TMA stores, one piece at a
        // time through the staging tile (a tile a piece would cost the
        // ring a stage, which costs more); then the scale s
#pragma unroll
        for (int p = 0; p < 3 && c > 0; ++p) {
          if (t == 0) bulk_wait<true>();   // the tile's last store read it
          wg_sync(wg);
#pragma unroll
          for (int i = 0; i < 64; i += 2) {
            uint32_t pc[3];
            split3(acc[i], acc[i + 1], pc);
            const int rr = 16 * warp + lane / 4 + acc_row(i), g = i / 4;
            const uint32_t a = stg + (g / 8) * kHalf + rr * 128 +
                               (((g % 8) ^ (rr % 8)) << 4) + 4 * (lane % 4);
            asm volatile("st.shared.b32 [%0], %1;" ::"r"(a), "r"(pc[p])
                         : "memory");
          }
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
          wg_sync(wg);
          if (t == 0) {
            for (int hc = 0; hc < 2 && dk0 + hc * kBox < Dh; ++hc)
              if (dv0 + 64 * wg < Dh)
                tma_store(&tc, stg + hc * kHalf, dk0 + hc * kBox,
                          dv0 + 64 * wg, bh * (nc - 1) + c - 1, p);
            bulk_commit();
          }
        }
        const float s = cscale[static_cast<long long>(bh) * nc + c];
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] = s * acc[i];
      }
      finish_products(acc, part);
      if (t == 0) mbar_arrive(r.empty(it));
    }
  }
  if (t == 0) bulk_wait<false>();
  float* co = cout + static_cast<long long>(bh) * Dh * Dh;
#pragma unroll
  for (int i = 0; i < 64; i += 2) {
    const int rr = row + acc_row(i), cc = col + acc_col(i);
    if (rr < Dh && cc < Dh)
      *reinterpret_cast<float2*>(co + static_cast<long long>(rr) * Dh + cc) =
          make_float2(acc[i], acc[i + 1]);
  }
  // n, chained by the first row of tiles: one thread per column
  if (blockIdx.y == 0 && wg == 0 && dk0 + t < Dh) {
    const int d = dk0 + t;
    float n = 0.f;
    for (int c = 0; c < nc; ++c) {
      if (c > 0)
        nstart[(static_cast<long long>(bh) * (nc - 1) + c - 1) * Dh + d] = n;
      const float* np =
          npart + (static_cast<long long>(bh) * nc + c) * kPrepGroups * Dh + d;
      float part = np[0];
      for (int g = 1; g < kPrepGroups; ++g) part = part + np[g * Dh];
      n = cscale[static_cast<long long>(bh) * nc + c] * n + part;
    }
    nout[static_cast<long long>(bh) * Dh + d] = n;
  }
}

// --------------------------------------------------------------- 3. intra
// One CTA per (b, h, chunk, 128-row block rb, 128-key tile kt <= rb), all
// of equal work.  Maps: tq, tk (q, k or their pieces: Dh x L x B H x kN,
// 128-row boxes).  sdp: (3, BH nc, ckp, ckp) pieces of S.D, every row of
// the block and every column of the key tile written (zeros where
// masked); den (ckp / 128, BH, L): the row sums of S.D over key tile kt
// in slot kt; qn (BH, L): scale q.n0 (chunks after the first; the CTAs
// of key tile 0).
template <bool kBf16>
__global__ void __launch_bounds__(kThreads, 1) mlstm_intra_kernel(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tk, int mbq, int mhq, int mbk,
    int mhk, const float* __restrict__ bcum, const float* __restrict__ mt,
    const float* __restrict__ i_raw, const float* __restrict__ nstart,
    __nv_bfloat16* __restrict__ sdp, float* __restrict__ den,
    float* __restrict__ qn, int H, int L, int Dh, int ck, int ckp, int nc,
    float scale) {
  constexpr int kN = kBf16 ? 1 : 3;
  int rb = 0;                     // blockIdx.x enumerates the pairs (rb, kt)
  while ((rb + 1) * (rb + 2) / 2 <= static_cast<int>(blockIdx.x)) ++rb;
  const int kt = blockIdx.x - rb * (rb + 1) / 2;
  const int c = blockIdx.y % nc, bh = blockIdx.y / nc;
  const int t0 = c * ck, len = min(ck, L - t0), r0 = rb * kTile;
  if (r0 >= len) return;
  constexpr int kSB = 2 * kN * kPiece;
  extern __shared__ uint8_t smem_raw[];
  const auto r = ring_init<kRingStages<kSB>, kSB>(smem_raw);
  const int n_dt = (Dh + kBox - 1) / kBox;
  const int wg = threadIdx.x / kWg;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x != 2 * kWg) return;
    const int mat_q = (bh / H) * mbq + (bh % H) * mhq;
    const int mat_k = (bh / H) * mbk + (bh % H) * mhk;
    for (int dt = 0; dt < n_dt; ++dt) {
      const uint32_t st = produce(r, dt, 2 * kN * kPiece);
      for (int p = 0; p < kN; ++p) {
        tma_load(&tq, st + p * kPiece, r.full(dt), dt * kBox, t0 + r0,
                 mat_q, p);
        tma_load(&tk, st + (kN + p) * kPiece, r.full(dt), dt * kBox,
                 t0 + kt * kTile, mat_k, p);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  const int t = threadIdx.x % kWg, warp = t / 32, lane = t % 32;
  const int row = r0 + 64 * wg + 16 * warp + lane / 4;   // chunk rows
  const long long seq = static_cast<long long>(bh) * L + t0;
  __nv_bfloat16* sd = sdp + (static_cast<long long>(bh) * nc + c) * ckp * ckp;
  const long long sd_piece = static_cast<long long>(gridDim.y) * ckp * ckp;
  float bt[2], mrow[2], rsum[2] = {0.f, 0.f};
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int tr = row + 8 * hf < len ? row + 8 * hf : 0;
    bt[hf] = bcum[seq + tr];
    mrow[hf] = mt[seq + tr];
  }
  // q.n0 (chunks after the first, key tile 0): two threads a row, 32
  // columns of each 64-column q tile each, read from the tiles in shared
  // memory while the stage's products run
  const float* n0 = nstart + (static_cast<long long>(bh) * (nc - 1) + c - 1) * Dh;
  const int q_row = 64 * wg + t / 2;       // of the block's 128
  float q_n0 = 0.f;
  {
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    for (int dt = 0; dt < n_dt; ++dt) {
      const int it = dt;
      float part[64];
      mbar_wait(r.full(it), r.phase(it));
      issue_products<kN, kN, 0, 0, 4, kPiece, kPiece, kHalf>(
          part, r.stage(it), wg);
      if (kt == 0 && c > 0) {
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int ch = 4 * (t % 2) + m, d = dt * kBox + 8 * ch;
          float x[8] = {};
#pragma unroll
          for (int pc = 0; pc < kN; ++pc) {
            uint4 u;
            asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
                         : "=r"(u.x), "=r"(u.y), "=r"(u.z), "=r"(u.w)
                         : "r"(r.stage(it) + pc * kPiece + q_row * 128 +
                               ((ch ^ (q_row % 8)) << 4)));
            const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float2 f = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(&w[e]));
              x[2 * e] = x[2 * e] + f.x;
              x[2 * e + 1] = x[2 * e + 1] + f.y;
            }
          }
#pragma unroll
          for (int e = 0; e < 8; ++e)
            if (d + e < Dh) q_n0 = q_n0 + x[e] * n0[d + e];
        }
        wg_sync(wg);     // every thread's reads of the stage are done
      }
      finish_products(acc, part);
      if (t == 0) mbar_arrive(r.empty(it));
    }
    const int col = kt * kTile + 2 * (lane % 4);
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const int tr = row + acc_row(i), j = col + acc_col(i);
      float x[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = tr < len && j + e < len && j + e <= tr;
        const int jj = ok ? j + e : 0;     // a masked key reads key 0
        const float a = ((bt[acc_row(i) / 8] - bcum[seq + jj]) +
                         i_raw[seq + jj]) - mrow[acc_row(i) / 8];
        x[e] = ok ? (acc[i + e] * scale) * expf(a) : 0.f;
        rsum[acc_row(i) / 8] += x[e];
      }
      uint32_t p[3];
      split3(x[0], x[1], p);
      const long long off = static_cast<long long>(tr) * ckp + j;
#pragma unroll
      for (int pc = 0; pc < 3; ++pc)
        *reinterpret_cast<uint32_t*>(sd + pc * sd_piece + off) = p[pc];
    }
  }
  float* den_kt = den + static_cast<long long>(kt) * (gridDim.y / nc) * L;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const float s = quad_sum(rsum[hf]);
    if (lane % 4 == 0 && row + 8 * hf < len) den_kt[seq + row + 8 * hf] = s;
  }
  q_n0 += __shfl_xor_sync(0xffffffffu, q_n0, 1);
  // only the key tile 0 CTA of the row block computed q.n0 and writes it
  if (kt == 0 && c > 0 && t % 2 == 0 && r0 + q_row < len)
    qn[seq + r0 + q_row] = scale * q_n0;
}

// ----------------------------------------------------------------- 4. out
// Maps: tq (q or its pieces, 128-row boxes), tc (chunk-start state pieces:
// Dh x Dh rows x BH (nc - 1) x 3, 128-row boxes), tsd (S.D pieces: ckp x
// ckp rows x BH nc x 3, 128-row boxes), tv (v or its pieces, 64-row
// boxes).
template <bool kBf16>
__global__ void __launch_bounds__(kThreads, 1) mlstm_out_kernel(
    const __grid_constant__ CUtensorMap tq,
    const __grid_constant__ CUtensorMap tc,
    const __grid_constant__ CUtensorMap tsd,
    const __grid_constant__ CUtensorMap tv, int mbq, int mhq, int mbv,
    int mhv, const float* __restrict__ mt, const float* __restrict__ inter,
    const float* __restrict__ den, const float* __restrict__ qn,
    float* __restrict__ h, int H, int L, int Dh, int ck, int nc,
    float scale) {
  constexpr int kN = kBf16 ? 1 : 3;
  const int dv0 = blockIdx.x * kTile, rb = blockIdx.y;
  const int c = blockIdx.z % nc, bh = blockIdx.z / nc;
  const int t0 = c * ck, len = min(ck, L - t0), r0 = rb * kTile;
  if (r0 >= len) return;
  constexpr int kSB = (kN + 3) * kPiece;
  extern __shared__ uint8_t smem_raw[];
  const auto r = ring_init<kRingStages<kSB>, kSB>(smem_raw);
  const int n_a = c > 0 ? (Dh + kBox - 1) / kBox : 0;     // q C0^T steps
  const int n_b = (min(r0 + kTile, len) + 63) / 64;       // (S.D) v steps
  const int wg = threadIdx.x / kWg;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x != 2 * kWg) return;
    const int mat_q = (bh / H) * mbq + (bh % H) * mhq;
    const int mat_v = (bh / H) * mbv + (bh % H) * mhv;
    const int mat_c = bh * (nc - 1) + c - 1;
    const int nv = dv0 + kBox < Dh ? 2 : 1;
    int it = 0;
    for (int dt = 0; dt < n_a; ++dt, ++it) {
      const uint32_t st = produce(r, it, (kN + 3) * kPiece);
      for (int p = 0; p < kN; ++p)
        tma_load(&tq, st + p * kPiece, r.full(it), dt * kBox, t0 + r0,
                 mat_q, p);
      for (int p = 0; p < 3; ++p)
        tma_load(&tc, st + (kN + p) * kPiece, r.full(it), dt * kBox, dv0,
                 mat_c, p);
    }
    for (int jt = 0; jt < n_b; ++jt, ++it) {
      const uint32_t st = produce(r, it, 3 * kPiece + kN * nv * kHalf);
      for (int p = 0; p < 3; ++p)
        tma_load(&tsd, st + p * kPiece, r.full(it), jt * 64, r0,
                 bh * nc + c, p);
      for (int p = 0; p < kN; ++p)
        for (int hv = 0; hv < nv; ++hv)
          tma_load(&tv, st + (3 + p) * kPiece + hv * kHalf, r.full(it),
                   dv0 + hv * kBox, t0 + jt * 64, mat_v, p);
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  const int t = threadIdx.x % kWg, warp = t / 32, lane = t % 32;
  const int row = r0 + 64 * wg + 16 * warp + lane / 4;   // chunk rows
  const int col = dv0 + 2 * (lane % 4);
  const long long seq = static_cast<long long>(bh) * L + t0;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  int it = 0;
  for (int dt = 0; dt < n_a; ++dt, ++it)
    consume<kN, 3, 0, 0>(r, it, acc, wg, t);
  float w[2] = {0.f, 0.f};
  if (c > 0) {                    // inter * scale * (q C0^T)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int tr = row + 8 * hf < len ? row + 8 * hf : 0;   // past len: unused
      w[hf] = inter[seq + tr];
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = (w[acc_row(i) / 8] * scale) * acc[i];
  }
  for (int jt = 0; jt < n_b; ++jt, ++it)
    consume<3, kN, 0, 1>(r, it, acc, wg, t);
  float* hb = h + seq * Dh;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int tr = row + 8 * hf;
    if (tr >= len) continue;
    float d = den[seq + tr];     // the row sums of key tiles 0..rb in order
    for (int kt = 1; kt <= rb; ++kt)
      d = d + den[static_cast<long long>(kt) * (gridDim.z / nc) * L + seq + tr];
    if (c > 0) d = d + w[hf] * qn[seq + tr];
    const float lim = fmaxf(fabsf(d), expf(-mt[seq + tr]));
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      if (acc_row(i) != 8 * hf) continue;
      const int cc = col + acc_col(i);
      if (cc < Dh)
        *reinterpret_cast<float2*>(hb + static_cast<long long>(tr) * Dh + cc) =
            make_float2(acc[i] / lim, acc[i + 1] / lim);
    }
  }
}

// A 4-d tensor map (cols, rows, matrices, pieces) of a bf16 operand: row,
// matrix and piece strides in bytes, boxes of 64 columns by ``rows``,
// 128-byte swizzle, zero fill past the ends.
bool encode(CUtensorMap* map, const void* ptr, long long cols,
            long long n_rows, long long mats, long long pieces,
            long long row_b, long long mat_b, long long piece_b, int rows) {
  EncodeFn fn = encode_fn();
  if (fn == nullptr || reinterpret_cast<uintptr_t>(ptr) % 16) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(n_rows),
                              static_cast<cuuint64_t>(mats),
                              static_cast<cuuint64_t>(pieces)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(row_b),
                                 static_cast<cuuint64_t>(mat_b),
                                 static_cast<cuuint64_t>(piece_b)};
  for (const long long s : strides)
    if (s % 16 || s <= 0 || s >= (1ll << 40)) return false;
  const cuuint32_t box[4] = {kBox, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The map of q, k or v: the input itself (bf16, one piece, its Layout) or
// its three pieces in qkvp (float32 inputs).
bool encode_qkv(CUtensorMap* map, bool bf16, const void* in, Layout l,
                const void* pieces, int BH, int L, int Dh, int D8,
                int rows) {
  if (bf16)
    return encode(map, in, Dh, L, BH, 1, 2 * l.rs, 2 * l.rs * L,
                  2 * l.rs * L * BH, rows);
  return encode(map, pieces, Dh, L, BH, 3, 2ll * D8, 2ll * D8 * L,
                2ll * D8 * L * BH, rows);
}

template <typename K>
cudaError_t opt_in(K kern, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  done = err == cudaSuccess;
  return err;
}

template <bool kBf16>
int launch_products(const void* q, const void* k, const void* v,
                    const Layout* lay, const float* i_raw, float* h,
                    float* c_out, float* n_out, float* g, float* cscale,
                    __nv_bfloat16* qkvp, __nv_bfloat16* wvp, float* npart,
                    float* nstart, __nv_bfloat16* c0p, __nv_bfloat16* sdp,
                    float* den, float* qn, int H, int BH, int L, int Dh,
                    int ck, float scale, cudaStream_t st, int stage) {
  static bool ready[3] = {false, false, false};
  cudaError_t err;
  if ((err = opt_in(mlstm_state_kernel<kBf16>, ready[0])) != cudaSuccess ||
      (err = opt_in(mlstm_intra_kernel<kBf16>, ready[1])) != cudaSuccess ||
      (err = opt_in(mlstm_out_kernel<kBf16>, ready[2])) != cudaSuccess)
    return static_cast<int>(err);
  const int nc = (L + ck - 1) / ck, ckp = (ck + kTile - 1) / kTile * kTile;
  const int D8 = (Dh + 7) / 8 * 8, n1 = nc > 1 ? nc - 1 : 1;
  const long long n = static_cast<long long>(BH) * L;
  const float *bcum = g, *mt = g + n, *inter = g + 2 * n, *wj = g + 3 * n;
  const long long qkv_piece = 3ll * BH * L * D8;
  const void* pq = qkvp;
  const void* pk = qkvp + qkv_piece;
  const void* pv = qkvp + 2 * qkv_piece;
  const unsigned dt = static_cast<unsigned>((Dh + kTile - 1) / kTile);
  const unsigned rt = static_cast<unsigned>(ckp / kTile);
  const unsigned z = static_cast<unsigned>(nc * BH);
  if (stage < 0 || stage == 1) {
    mlstm_prep_kernel<kBf16><<<dim3((Dh + 2 * kPrepThreads - 1) /
                                        (2 * kPrepThreads),
                                    nc * kPrepGroups, BH),
                               kPrepThreads, 0, st>>>(
        q, k, v, lay[0], lay[1], lay[2], wj, qkvp, wvp, npart, H, L, Dh, D8,
        ck, ckp, nc);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  if (stage < 0 || stage == 2) {
    CUtensorMap tw, tk;
    if (!encode(&tw, wvp, Dh, static_cast<long long>(nc) * ckp, BH, 3,
                2ll * D8, 2ll * D8 * nc * ckp, 2ll * D8 * nc * ckp * BH, kJ) ||
        !encode_qkv(&tk, kBf16, k, lay[1], pk, BH, L, Dh, D8, kJ))
      return static_cast<int>(cudaErrorInvalidValue);
    CUtensorMap tc;
    if (!encode(&tc, c0p, Dh, Dh, static_cast<long long>(BH) * n1, 3,
                2ll * D8, 2ll * D8 * Dh, 2ll * D8 * Dh * BH * n1, 64))
      return static_cast<int>(cudaErrorInvalidValue);
    const Layout lk = kBf16 ? lay[1] : Layout{D8, H, 1};
    mlstm_state_kernel<kBf16><<<dim3(dt, dt, BH), kThreads, kSmem, st>>>(
        tw, tk, tc, lk.mb, lk.mh, cscale, npart, nstart, c_out, n_out, H, L,
        Dh, D8, ck, ckp, nc);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  if (stage < 0 || stage == 3) {
    CUtensorMap tq, tk;
    if (!encode_qkv(&tq, kBf16, q, lay[0], pq, BH, L, Dh, D8, kTile) ||
        !encode_qkv(&tk, kBf16, k, lay[1], pk, BH, L, Dh, D8, kTile))
      return static_cast<int>(cudaErrorInvalidValue);
    const Layout lq = kBf16 ? lay[0] : Layout{D8, H, 1};
    const Layout lk = kBf16 ? lay[1] : Layout{D8, H, 1};
    mlstm_intra_kernel<kBf16><<<dim3(rt * (rt + 1) / 2, z), kThreads, kSmem,
                                st>>>(
        tq, tk, lq.mb, lq.mh, lk.mb, lk.mh, bcum, mt, i_raw,
        nstart, sdp, den, qn, H, L, Dh, ck, ckp, nc, scale);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  if (stage < 0 || stage == 4) {
    CUtensorMap tq, tc, tsd, tv;
    if (!encode_qkv(&tq, kBf16, q, lay[0], pq, BH, L, Dh, D8, kTile) ||
        !encode(&tc, c0p, Dh, Dh, static_cast<long long>(BH) * n1, 3,
                2ll * D8, 2ll * D8 * Dh, 2ll * D8 * Dh * BH * n1, kTile) ||
        !encode(&tsd, sdp, ckp, ckp, static_cast<long long>(BH) * nc, 3,
                2ll * ckp, 2ll * ckp * ckp, 2ll * ckp * ckp * BH * nc,
                kTile) ||
        !encode_qkv(&tv, kBf16, v, lay[2], pv, BH, L, Dh, D8, 64))
      return static_cast<int>(cudaErrorInvalidValue);
    const Layout lq = kBf16 ? lay[0] : Layout{D8, H, 1};
    const Layout lv = kBf16 ? lay[2] : Layout{D8, H, 1};
    mlstm_out_kernel<kBf16><<<dim3(dt, rt, z), kThreads, kSmem, st>>>(
        tq, tc, tsd, tv, lq.mb, lq.mh, lv.mb, lv.mh, mt, inter, den, qn, h, H,
        L, Dh, ck, nc, scale);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // namespace

// Dynamic shared memory of a CTA of the state, intra and out kernels.
extern "C" int mlstm_chunk_smem() { return kSmem; }

// The five launches in order on ``stream`` (``stage`` < 0), or only
// launch ``stage`` (0 gate, 1 prep, 2 state, 3 intra, 4 out; to time one
// alone once a full call has filled its inputs).  q, k, v: float32
// (bf16 0) or bf16 (bf16 1), element (b, h, row, d) at ((b mb + h mh) L +
// row) rs + d with lay = {rs, mb, mh} for q, k, v in turn (rs a multiple
// of 4, bf16: of 8; 16-byte aligned bases).  i_raw, f_raw (BH,
// L) float32.  Scratch: gates (4, BH, L) [b, m_t, inter, w], mchain (BH,
// nc + 1), cscale (BH, nc), qkvp (9, BH, L, D8) bf16 (float32 inputs
// only), wvp (3, BH, nc ckp, D8) bf16, npart (BH, nc, 4, Dh), nstart (BH,
// max(nc - 1, 1), Dh), c0p (3, BH max(nc - 1, 1), Dh, D8) bf16, sdp (3,
// BH nc, ckp, ckp) bf16, den (ckp / 128, BH, L), qn (BH, L); D8 = Dh
// rounded up to 8, ckp
// = ck rounded up to 128.  Dh must be a multiple of 4.  Returns a
// cudaError_t code (0 = launched).
extern "C" int mlstm_chunk_launch(
    const void* q, const void* k, const void* v, const long long* lay,
    const void* i_raw, const void* f_raw, void* h, void* c_out, void* n_out,
    void* m_out, void* gates, void* mchain, void* cscale, void* qkvp,
    void* wvp, void* npart, void* nstart, void* c0p, void* sdp, void* den,
    void* qn, int bf16, int B, int H, int L, int Dh, int ck, float scale,
    void* stream, int stage) {
  if (B < 1 || H < 1 || L < 1 || Dh < 4 || Dh % 4 || ck < 1 || ck > L ||
      (bf16 != 0 && bf16 != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int BH = B * H, nc = (L + ck - 1) / ck;
  if (static_cast<long long>(nc) * BH > 65535 || nc * kPrepGroups > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout l3[3] = {{lay[0], static_cast<int>(lay[1]), static_cast<int>(lay[2])},
                        {lay[3], static_cast<int>(lay[4]), static_cast<int>(lay[5])},
                        {lay[6], static_cast<int>(lay[7]), static_cast<int>(lay[8])}};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* g = static_cast<float*>(gates);
  if (stage < 0 || stage == 0) {
    mlstm_gate_kernel<<<BH, kGateThreads, 0, st>>>(
        static_cast<const float*>(i_raw), static_cast<const float*>(f_raw), g,
        g + static_cast<long long>(BH) * L, g + 2ll * BH * L,
        g + 3ll * BH * L, static_cast<float*>(mchain),
        static_cast<float*>(cscale), static_cast<float*>(m_out), L, ck, nc);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || stage == 0) return static_cast<int>(err);
  }
  auto bf = [](void* p) { return static_cast<__nv_bfloat16*>(p); };
  auto fl = [](void* p) { return static_cast<float*>(p); };
  return (bf16 ? launch_products<true> : launch_products<false>)(
      q, k, v, l3, static_cast<const float*>(i_raw), fl(h), fl(c_out),
      fl(n_out), g, fl(cscale), bf(qkvp), bf(wvp), fl(npart), fl(nstart),
      bf(c0p), bf(sdp), fl(den), fl(qn), H, BH, L, Dh, ck, scale, st, stage);
}
