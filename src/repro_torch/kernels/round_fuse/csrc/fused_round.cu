// fused_round: stages 1-3 of the single-device engine round (pop, fan-out,
// co-input fetch + bytecode VM, Listing-2 window gate), written for
// Hopper (sm_90a) as two launches on one stream.
//
// Replaces: src/repro/kernels/round_fuse/kernel.py, fused_round_call
// (Pallas body _fused_round_kernel, stages 2+3 in _apply_body) of the JAX
// package.  The second launch, apply_programs, is also launched alone as
// the port of apply_programs_call (the sharded round's post-exchange
// apply, src/repro/kernels/round_fuse/kernel.py, apply_programs_call).
//
// What bounds it on this card: not bandwidth.  The pop must read about
// 35 KB of queue planes at the default queue=2048; the apply reads at most
// ~1.3 MB of distinct table rows for W = batch * max_out = 1024 work items
// (in_table, program and constant rows, co-input values) — under half a
// microsecond of HBM time.  What costs is the pop's one CTA — the shared-
// memory traffic of its two sorts of the Q slots (see sched_pop.cu; the
// pop is one static order, not `batch` dependent argmins) — and, in the
// apply, latency: each item is a chain of dependent memory trips (its
// row, then the row's co-inputs), then its program, ~20-30 dependent VM
// instructions each reading registers the earlier ones wrote, and each
// item re-reads its row's program (16 B a step) whatever other items
// share the row.
//
// What the design does about it:
//   (a) pop_dispatch — one CTA runs the sorted-selection pop of
//       sched_pop/csrc/pop_select.cuh with the slots' sort words and slot
//       lists in shared memory, then expands each winner to its out_table
//       row with direct loads: targets are -1 for invalid or revoked
//       events, exactly ref.pop_dispatch_ref.
//   (b) apply_programs — a grid of one-warp CTAs, one thread per item,
//       and a second grid dimension over shards: shard s reads its own
//       table slice (n_tab rows at offset s * n_tab) and work items, and
//       every shard reads one shared value/timestamp snapshot of n_snap
//       rows (the sharded round's all-gathered view; the fused round
//       passes one shard with n_tab == n_snap).  The fused round's 1,024
//       items cover 32 SMs, the sharded round's 16,384 every SM.  Each
//       thread stages what its VM reads in shared memory before the VM
//       runs, each trip's loads all in flight before the first is used
//       (16-byte loads of its own rows; on this card these beat
//       cp.async, bulk (TMA) copies of the small rows and warp-cooperative
//       coalesced copies, whose issue or queueing cost more than the
//       scattered rows): (1) its row, target and event; (2) the row's
//       in_table entries and constants, the target's value and the
//       first 16 program steps; (3) the co-inputs' values and timestamps
//       (the trigger slot from the fresh SU) and the next 16 steps; then
//       the rest of the program.  Programs, constants and in_table
//       entries are item-major at pitches that spread a warp's lanes over
//       the banks; registers item-minor (register r of item t at
//       [r * 32 + t]), so a warp's lanes reading any registers hit 32
//       banks.  The VM loop then touches no device memory: it works out
//       the next instruction's operand addresses while the current one's
//       operands load, each warp stops at its lanes' last non-NOP
//       instruction (a NOP tail leaves every register unchanged), and an
//       instruction's value comes from selects, not a switch: each group
//       of opcodes some lane runs is computed for the whole warp and each
//       lane keeps its own (vm_eval), so a warp whose lanes run different
//       programs does not serialize on the opcode.  Lanes past W compute
//       on item W - 1 and store nothing, so every warp is full for its
//       votes.
// The Pallas kernel's one-hot MXU gathers with 16-bit halves and its
// masked-sum lane extraction are TPU idioms: direct loads and plain
// indexing are exact here.  Payload floats move as 32-bit patterns.
//
// Float contract (bitwise with the JAX package's VM on the CPU and with
// the plain torch VM, repro_torch/core/program.py): subnormal inputs of
// every arithmetic op and subnormal results read as zeros of the same
// sign (explicit flush below; the build also passes -ftz=true), no FMA
// contraction (-fmad=false), min/max propagate NaN and order -0.0 below
// +0.0, round is half to even (rintf), sign keeps signed zeros and NaN,
// and division and square root are the correctly rounded intrinsics.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "../../sched_pop/csrc/pop_select.cuh"

namespace {

// Work items per apply CTA: one warp, one thread an item.
constexpr int kApplyItems = 32;

// Cycle stamps of a profiling build (scripts/profile_torch_apply.py);
// nothing in this build.
#ifndef APPLY_STAMP
#define APPLY_STAMP(k)
#endif

// VM opcodes (repro_torch/core/program.py); the transcendental ones
// (EXP, LOG, SIN, COS, POW, TANH) are not fusable and run as NOP here.
enum Op {
  OP_NOP = 0, OP_MOV = 1, OP_CONST = 2, OP_ADD = 3, OP_SUB = 4, OP_MUL = 5,
  OP_DIV = 6, OP_MIN = 7, OP_MAX = 8, OP_NEG = 9, OP_ABS = 10,
  OP_SQRT = 13, OP_FLOOR = 16, OP_LT = 18, OP_LE = 19, OP_EQ = 20,
  OP_NE = 21, OP_AND = 22, OP_OR = 23, OP_NOT = 24, OP_SELECT = 25,
  OP_ROUND = 26, OP_SIGN = 27,
};

struct Layout {
  int max_in, channels, n_regs, reg_inputs, reg_prev, reg_ts, reg_trigger,
      reg_result, reg_pref, reg_postf;
};

__device__ __forceinline__ float flush(float x) {
  const uint32_t u = __float_as_uint(x);
  return (u & 0x7f800000u) == 0 ? __uint_as_float(u & 0x80000000u) : x;
}

__device__ __forceinline__ float neg_bits(float x) {
  return __uint_as_float(__float_as_uint(x) ^ 0x80000000u);
}

__device__ __forceinline__ float abs_bits(float x) {
  return __uint_as_float(__float_as_uint(x) & 0x7fffffffu);
}

__device__ __forceinline__ bool is_nan(float x) {
  return (__float_as_uint(x) & 0x7fffffffu) > 0x7f800000u;
}

__device__ __forceinline__ bool sign_bit(float x) {
  return (__float_as_uint(x) >> 31) != 0;
}

// IEEE minimum / maximum: NaN if either is NaN, -0.0 below +0.0; selects,
// no branches.
__device__ __forceinline__ float vm_min(float a, float b) {
  const bool pick_a = (a < b) | ((a == b) & sign_bit(a));
  return is_nan(a) | is_nan(b) ? __fadd_rn(a, b) : (pick_a ? a : b);
}

__device__ __forceinline__ float vm_max(float a, float b) {
  const bool pick_a = (a > b) | ((a == b) & !sign_bit(a));
  return is_nan(a) | is_nan(b) ? __fadd_rn(a, b) : (pick_a ? a : b);
}

__device__ __forceinline__ float truth(float x) {
  return flush(x) != 0.0f ? 1.0f : 0.0f;
}

// XLA's dynamic read index: a negative index wraps once, then clamps.
__device__ __forceinline__ int read_idx(int i, int n) {
  i = i < 0 ? i + n : i;
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

__device__ __forceinline__ int clamp_row(int i, int n) {
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

// v where op == code, else r: a predicated select the compiler cannot
// turn back into a branch.
template <int code>
__device__ __forceinline__ float when(int op, float v, float r) {
  float out;
  asm("{\n\t.reg .pred q;\n\tsetp.eq.s32 q, %1, %2;\n\t"
      "selp.f32 %0, %3, %4, q;\n\t}"
      : "=f"(out)
      : "r"(op), "n"(code), "f"(v), "f"(r));
  return out;
}

// Whether any lane of the warp runs an opcode in [lo, hi].
__device__ __forceinline__ bool warp_has(int op, int lo, int hi) {
  return __any_sync(0xffffffffu,
                    static_cast<unsigned>(op - lo) <=
                        static_cast<unsigned>(hi - lo));
}

// One VM instruction's value, for every lane of the warp at once (the VM
// loop is warp-uniform).  The opcodes fall in five groups (three ranges,
// division, square root); for each group that some lane runs, the value
// of every opcode in it is computed and the lane's own selected, so lanes
// running different opcodes do not take turns through a switch, and a
// group no lane runs costs one vote.  NOP, every non-fusable opcode and
// every opcode out of range give dv (the destination's own value).
__device__ __forceinline__ float vm_eval(int op, float av, float bv,
                                         float dv, float ca) {
  const float fa = flush(av), fb = flush(bv);
  float r = dv;
  if (warp_has(op, OP_MOV, OP_MUL)) {
    r = when<OP_MOV>(op, av, r);
    r = when<OP_CONST>(op, ca, r);
    r = when<OP_ADD>(op, flush(__fadd_rn(fa, fb)), r);
    r = when<OP_SUB>(op, flush(__fsub_rn(fa, fb)), r);
    r = when<OP_MUL>(op, flush(__fmul_rn(fa, fb)), r);
  }
  if (warp_has(op, OP_MIN, OP_FLOOR)) {
    r = when<OP_MIN>(op, vm_min(fa, fb), r);
    r = when<OP_MAX>(op, vm_max(fa, fb), r);
    r = when<OP_NEG>(op, neg_bits(av), r);
    r = when<OP_ABS>(op, abs_bits(av), r);
    r = when<OP_FLOOR>(op, floorf(fa), r);
  }
  if (warp_has(op, OP_LT, OP_SIGN)) {
    const float ta = truth(av), tb = truth(bv);
    r = when<OP_LT>(op, fa < fb ? 1.0f : 0.0f, r);
    r = when<OP_LE>(op, fa <= fb ? 1.0f : 0.0f, r);
    r = when<OP_EQ>(op, fa == fb ? 1.0f : 0.0f, r);
    r = when<OP_NE>(op, fa != fb ? 1.0f : 0.0f, r);
    r = when<OP_AND>(op, ta * tb, r);
    r = when<OP_OR>(op, fmaxf(ta, tb), r);  // 0 or 1: no NaN, no -0.0
    r = when<OP_NOT>(op, 1.0f - ta, r);
    r = when<OP_SELECT>(op, fa != 0.0f ? bv : dv, r);
    r = when<OP_ROUND>(op, rintf(fa), r);
    r = when<OP_SIGN>(op, fa > 0.0f ? 1.0f : (fa < 0.0f ? -1.0f : fa), r);
  }
  if (warp_has(op, OP_DIV, OP_DIV))
    r = when<OP_DIV>(
        op, abs_bits(bv) < 1e-30f ? 0.0f : flush(__fdiv_rn(fa, fb)), r);
  if (warp_has(op, OP_SQRT, OP_SQRT))
    r = when<OP_SQRT>(op, __fsqrt_rn(vm_max(fa, 0.0f)), r);
  return r;
}

// ---- (a) pop + dispatch ----------------------------------------------------

__global__ void __launch_bounds__(pop_select::kThreads) pop_dispatch_kernel(
    const int* __restrict__ prio, const int* __restrict__ seq,
    const uint8_t* __restrict__ valid, const int* __restrict__ tenant,
    const int* __restrict__ weight, const int* __restrict__ sid,
    const int* __restrict__ ts, const uint32_t* __restrict__ vals,
    const int* __restrict__ out_table, const uint8_t* __restrict__ active,
    int Q, int C, int B, int N, int F, int* __restrict__ take,
    int* __restrict__ e_sid, int* __restrict__ e_ts,
    uint8_t* __restrict__ e_pop, uint8_t* __restrict__ e_act,
    uint32_t* __restrict__ e_vals, int* __restrict__ wi_t) {
  extern __shared__ __align__(16) unsigned char smem[];
  const pop_select::Planes p = pop_select::carve(smem, Q, B);
  pop_select::run(p, Q, B, prio, seq, valid, tenant, weight);
  for (int b = threadIdx.x; b < B; b += blockDim.x) {
    const int i = p.take[b];
    const int s = sid[i];
    take[b] = i;
    e_sid[b] = s;
    e_ts[b] = ts[i];
    e_pop[b] = p.valid[i];
    e_act[b] = active[clamp_row(s, N)] != 0;
  }
  for (int j = threadIdx.x; j < B * C; j += blockDim.x) {
    const int b = j / C, c = j - b * C;
    e_vals[j] = vals[(size_t)p.take[b] * C + c];
  }
  for (int j = threadIdx.x; j < B * F; j += blockDim.x) {
    const int b = j / F, f = j - b * F;
    const int i = p.take[b];
    const int row = clamp_row(sid[i], N);
    const bool live = p.valid[i] && active[row];
    const int t = out_table[(size_t)row * F + f];
    wi_t[j] = (live && t >= 0) ? t : -1;
  }
}

// ---- (b) apply programs ----------------------------------------------------

// Pitches of the item-major planes (item it's entry k at [it * pitch +
// k]).  Programs: an odd number of 16-byte instructions, so that the lanes
// of a warp reading instruction pc of their own items hit distinct banks.
// Constants and in_table entries: a multiple of four words (whole 16-byte
// stores) that is no multiple of eight, so that such reads spread over
// eight banks.
__host__ __device__ inline int odd_pitch(int n) { return n | 1; }
__host__ __device__ inline int quad_pitch(int n) { return ((n + 3) & ~3) | 4; }

// Shared bytes of one apply CTA, per item: its program, its register file
// (R floats), its constants and in_table entries, at those pitches.
__host__ __device__ inline size_t apply_smem_bytes(const Layout& lay, int L,
                                                   int K) {
  return (size_t)kApplyItems *
         (16 * (size_t)odd_pitch(L) +
          4 * ((size_t)lay.n_regs + quad_pitch(K) + quad_pitch(lay.max_in)));
}

// This lane's rows of two tables into shared memory in one pass: n1
// entries from s1 to d1 and n2 from s2 to d2, with up to sixteen loads in
// flight before they are stored.
template <class V>
__device__ __forceinline__ void stage_rows(V* d1, const V* __restrict__ s1,
                                           int n1, V* d2,
                                           const V* __restrict__ s2, int n2) {
  constexpr int kGroup = 16;
  for (int j0 = 0; j0 < n1 + n2; j0 += kGroup) {
    V v[kGroup];
#pragma unroll
    for (int q = 0; q < kGroup; ++q) {
      const int j = j0 + q;
      if (j < n1)
        v[q] = s1[j];
      else if (j < n1 + n2)
        v[q] = s2[j - n1];
    }
#pragma unroll
    for (int q = 0; q < kGroup; ++q) {
      const int j = j0 + q;
      if (j < n1)
        d1[j] = v[q];
      else if (j < n1 + n2)
        d2[j - n1] = v[q];
    }
  }
}

// Sixteen instructions of this lane's program, loaded in one step and
// stored in another, so that their loads overlap other trips.
struct ProgGroup {
  static constexpr int kSize = 16;
  int4 v[kSize];
  __device__ __forceinline__ void load(const int4* __restrict__ src, int k0,
                                       int L) {
#pragma unroll
    for (int q = 0; q < kSize; ++q)
      if (k0 + q < L) v[q] = src[k0 + q];
  }
  __device__ __forceinline__ void store(int4* dst, int k0, int L) const {
#pragma unroll
    for (int q = 0; q < kSize; ++q)
      if (k0 + q < L) dst[k0 + q] = v[q];
  }
};

// Work item w of shard s = blockIdx.y reads its target row from rows[w]
// (clamped into the shard's n_tab table rows) and its previous value from
// t_sid[w] (clamped into the n_snap snapshot rows, as every co-input is),
// its trigger (source id, timestamp, payload) from entry w / rep of the
// shard's per-event planes, and its validity from item_valid[w], or from
// rows[w] >= 0 when item_valid is null (the fused round's -1 targets).
// Every per-item plane holds W entries per shard, every per-event plane
// W / rep.
__global__ void __launch_bounds__(kApplyItems) apply_programs_kernel(
    Layout lay, int W, int n_tab, int n_snap, int L, int K, int rep,
    const int* __restrict__ rows, const int* __restrict__ t_sid,
    const uint8_t* __restrict__ item_valid, const int* __restrict__ wi_src,
    const int* __restrict__ wi_ts, const float* __restrict__ wi_vals,
    const int* __restrict__ in_table, const int4* __restrict__ progs,
    const float* __restrict__ consts, const uint8_t* __restrict__ is_comp,
    const uint8_t* __restrict__ active, const float* __restrict__ values,
    const int* __restrict__ timestamps, float* __restrict__ new_vals,
    int* __restrict__ ts_out, uint8_t* __restrict__ live_out,
    uint8_t* __restrict__ keep_out, uint8_t* __restrict__ keep_ts_out,
    uint8_t* __restrict__ passf_out, uint8_t* __restrict__ badf_out) {
  constexpr int T = kApplyItems;
  extern __shared__ __align__(16) unsigned char smem[];
  const int M = lay.max_in, C = lay.channels, R = lay.n_regs;
  const int Lp = odd_pitch(L), Kp = quad_pitch(K), Mp = quad_pitch(M);
  const int t = threadIdx.x;
  // the CTA's planes: programs, constants and in_table entries item-major
  // (item it's entry k at [it * pitch + k]), registers item-minor
  // ([r * T + it]: lanes reading any registers hit distinct banks)
  int4* sprog = reinterpret_cast<int4*>(smem);         // [T][Lp]
  float* sreg = reinterpret_cast<float*>(sprog + T * Lp);  // [R][T]
  float* scst = sreg + R * T;                          // [T][Kp]
  int* sin = reinterpret_cast<int*>(scst + T * Kp);    // [T][Mp]
  float* rg = sreg + t;                                // rg[r * T]
  APPLY_STAMP(0);

  // trip 1: the item and its event
  const int i = blockIdx.x * T + t;
  const bool store = i < W;
  const size_t sh = blockIdx.y;
  const size_t w = sh * W + (store ? i : W - 1);
  const int raw = rows[w];
  const int tgt = clamp_row(t_sid[w], n_snap);
  const bool item_ok = item_valid ? item_valid[w] != 0 : raw >= 0;
  const size_t e = sh * (W / rep) + (w - sh * W) / rep;
  const int src = wi_src[e];
  const int wts = wi_ts[e];
  const size_t row = sh * n_tab + clamp_row(raw, n_tab);
  APPLY_STAMP(1);

  // trip 2: the row's in_table entries and constants, the target's value
  // and timestamp and the row's flags, all in flight together
  const bool vec = C == 4 && ((reinterpret_cast<uintptr_t>(values) |
                               reinterpret_cast<uintptr_t>(wi_vals)) &
                              15) == 0;
  float4 prev = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (vec) prev = reinterpret_cast<const float4*>(values)[tgt];
  const int prev_ts = timestamps[tgt];
  const bool row_live = (is_comp[row] != 0) & (active[row] != 0);
  // the program's first instructions are in flight meanwhile
  const int4* prog = progs + row * L;
  int4* pg = sprog + t * Lp;
  ProgGroup pgrp;
  pgrp.load(prog, 0, L);
  if (M % 4 == 0 && K % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(in_table) |
        reinterpret_cast<uintptr_t>(consts)) & 15) == 0)
    stage_rows(reinterpret_cast<uint4*>(sin + t * Mp),
               reinterpret_cast<const uint4*>(in_table + row * M), M / 4,
               reinterpret_cast<uint4*>(scst + t * Kp),
               reinterpret_cast<const uint4*>(consts + row * K), K / 4);
  else
    stage_rows(reinterpret_cast<uint32_t*>(sin + t * Mp),
               reinterpret_cast<const uint32_t*>(in_table + row * M), M,
               reinterpret_cast<uint32_t*>(scst + t * Kp),
               reinterpret_cast<const uint32_t*>(consts + row * K), K);
  pgrp.store(pg, 0, L);
  float* px = rg + lay.reg_prev * T;
  if (vec) {
    px[0] = prev.x;
    px[T] = prev.y;
    px[2 * T] = prev.z;
    px[3 * T] = prev.w;
  } else {
    for (int c = 0; c < C; ++c) px[c * T] = values[(size_t)tgt * C + c];
  }
  rg[lay.reg_ts * T] = __int2float_rn(wts);
  for (int r = lay.reg_result; r < R; ++r) rg[r * T] = 0.0f;
  APPLY_STAMP(2);

  // trigger slot: first valid co-input equal to the source, else 0
  const int* in = sin + t * Mp;
  int trig = 0;
  for (int m = M - 1; m >= 0; --m) {
    const int s = in[m];
    if (s >= 0 && s == src) trig = m;
  }
  rg[lay.reg_trigger * T] = __int2float_rn(trig);

  // trip 3: this item's co-inputs, sixteen slots' loads in flight at once;
  // the trigger slot carries the fresh SU, an empty slot reads zeros.  At
  // C = 4 a value row is one 16-byte load.
  const float* wv = wi_vals + e * C;
  int ts_run = INT_MIN;
  pgrp.load(prog, ProgGroup::kSize, L);
  for (int m0 = 0; m0 < M; m0 += 16) {
    float4 v[16];
    int tsv[16];
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const int m = m0 + q;
      const int s = m < M ? in[m] : -1;
      const int ss = clamp_row(s, n_snap);
      tsv[q] = s < 0 ? INT_MIN : (m == trig ? wts : timestamps[ss]);
      if (vec) {
        v[q] = s < 0 ? make_float4(0.0f, 0.0f, 0.0f, 0.0f)
                     : (m == trig ? reinterpret_cast<const float4*>(wv)[0]
                                  : reinterpret_cast<const float4*>(values)[ss]);
      } else if (m < M) {
        float* x = rg + (lay.reg_inputs + m * C) * T;
        const float* vr = m == trig ? wv : values + (size_t)ss * C;
        for (int c = 0; c < C; ++c) x[c * T] = s < 0 ? 0.0f : vr[c];
      }
    }
    if (vec) {
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        if (m0 + q < M) {
          float* x = rg + (lay.reg_inputs + (m0 + q) * 4) * T;
          x[0] = v[q].x;
          x[T] = v[q].y;
          x[2 * T] = v[q].z;
          x[3 * T] = v[q].w;
        }
      }
    }
#pragma unroll
    for (int q = 0; q < 16; ++q) ts_run = max(ts_run, tsv[q]);
  }
  pgrp.store(pg, ProgGroup::kSize, L);
  APPLY_STAMP(3);

  // the rest of the program, then the warp's step count: one past the last
  // non-NOP instruction of any of its lanes
  for (int k0 = 2 * ProgGroup::kSize; k0 < L; k0 += ProgGroup::kSize) {
    pgrp.load(prog, k0, L);
    pgrp.store(pg, k0, L);
  }
  int last = 0;
  for (int pc = 0; pc < L; ++pc)
    if (pg[pc].x != OP_NOP) last = pc + 1;
  const int steps = __reduce_max_sync(0xffffffffu, last);
  APPLY_STAMP(4);

  // the VM: shared memory only, and no branch on the opcode but the long
  // ones (vm_eval); the next instruction and its operands' addresses are
  // worked out while the current one's operands load (the program planes
  // are never written here).  A NOP reads its destination and writes it
  // back; a destination out of range is dropped.
  const float* ck = scst + t * Kp;
  int4 ins = steps > 0 ? pg[0] : make_int4(OP_NOP, 0, 0, 0);
  int ia = read_idx(ins.z, R) * T, ib = read_idx(ins.w, R) * T,
      id = read_idx(ins.y, R) * T, ik = read_idx(ins.z, K);
  for (int pc = 0; pc < steps; ++pc) {
    const float av = rg[ia], bv = rg[ib], dv = rg[id], ca = ck[ik];
    const int op = ins.x;
    const int d = ins.y < 0 ? ins.y + R : ins.y;
    ins = pg[min(pc + 1, L - 1)];
    ia = read_idx(ins.z, R) * T;
    ib = read_idx(ins.w, R) * T;
    id = read_idx(ins.y, R) * T;
    ik = read_idx(ins.z, K);
    const float val = vm_eval(op, av, bv, dv, ca);
    if (d >= 0 && d < R) rg[d * T] = val;
  }
  APPLY_STAMP(5);

  bool bad = false;
  for (int c = 0; c < C; ++c) {
    const float x = rg[(lay.reg_result + c) * T];
    const bool finite = (__float_as_uint(x) & 0x7f800000u) != 0x7f800000u;
    bad |= !finite;
    if (store) new_vals[w * C + c] = finite ? x : 0.0f;
  }
  const bool passf = flush(rg[lay.reg_pref * T]) != 0.0f &&
                     flush(rg[lay.reg_postf * T]) != 0.0f;
  const bool keep_ts = wts > prev_ts;
  int t_out = wts > prev_ts ? wts : prev_ts;
  t_out = ts_run > t_out ? ts_run : t_out;
  const bool live = item_ok && row_live;
  if (store) {
    ts_out[w] = t_out;
    live_out[w] = live;
    keep_out[w] = live && keep_ts && passf;
    keep_ts_out[w] = keep_ts;
    passf_out[w] = passf;
    badf_out[w] = bad;
  }
  APPLY_STAMP(6);
}

}  // namespace

extern "C" int pop_dispatch_launch(
    const void* prio, const void* seq, const void* valid, const void* tenant,
    const void* weight, const void* sid, const void* ts, const void* vals,
    const void* out_table, const void* active, int Q, int C, int B, int N,
    int F, void* take, void* e_sid, void* e_ts, void* e_pop, void* e_act,
    void* e_vals, void* wi_t, void* stream) {
  static size_t smem_set[pop_select::kMaxDevices] = {};
  const size_t smem = pop_select::planes_bytes(Q, B);
  const cudaError_t err = pop_select::opt_in_smem(
      (const void*)pop_dispatch_kernel, smem, smem_set);
  if (err != cudaSuccess) return (int)err;
  pop_dispatch_kernel<<<1, pop_select::threads_for(Q), smem,
                        (cudaStream_t)stream>>>(
      (const int*)prio, (const int*)seq, (const uint8_t*)valid,
      (const int*)tenant, (const int*)weight, (const int*)sid, (const int*)ts,
      (const uint32_t*)vals, (const int*)out_table, (const uint8_t*)active, Q,
      C, B, N, F, (int*)take, (int*)e_sid, (int*)e_ts, (uint8_t*)e_pop,
      (uint8_t*)e_act, (uint32_t*)e_vals, (int*)wi_t);
  return (int)cudaGetLastError();
}

// layout: the ten RegLayout fields, in RegLayout order.  n_shards shards
// of W items each; tables of n_tab rows per shard, one shared snapshot of
// n_snap rows.
extern "C" int apply_programs_launch(
    const int* layout, int n_shards, int W, int n_tab, int n_snap, int L,
    int K, int rep, const void* rows, const void* t_sid,
    const void* item_valid, const void* wi_src, const void* wi_ts,
    const void* wi_vals, const void* in_table, const void* progs,
    const void* consts, const void* is_comp, const void* active,
    const void* values, const void* timestamps, void* new_vals, void* ts_out,
    void* live, void* keep, void* keep_ts, void* passf, void* badf,
    void* stream) {
  if (W == 0 || n_shards == 0) return 0;
  if (n_shards > 65535 || rep <= 0 || W % rep != 0 || n_tab <= 0 ||
      n_snap <= 0 || (uintptr_t)progs % 16 != 0)
    return (int)cudaErrorInvalidValue;
  Layout lay{layout[0], layout[1], layout[2], layout[3], layout[4],
             layout[5], layout[6], layout[7], layout[8], layout[9]};
  static size_t smem_set[pop_select::kMaxDevices] = {};
  const size_t smem = apply_smem_bytes(lay, L, K);
  const cudaError_t err = pop_select::opt_in_smem(
      (const void*)apply_programs_kernel, smem, smem_set);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + kApplyItems - 1) / kApplyItems, n_shards);
  apply_programs_kernel<<<grid, kApplyItems, smem, (cudaStream_t)stream>>>(
      lay, W, n_tab, n_snap, L, K, rep, (const int*)rows, (const int*)t_sid,
      (const uint8_t*)item_valid, (const int*)wi_src, (const int*)wi_ts,
      (const float*)wi_vals, (const int*)in_table, (const int4*)progs,
      (const float*)consts, (const uint8_t*)is_comp, (const uint8_t*)active,
      (const float*)values, (const int*)timestamps, (float*)new_vals,
      (int*)ts_out, (uint8_t*)live, (uint8_t*)keep, (uint8_t*)keep_ts,
      (uint8_t*)passf, (uint8_t*)badf);
  return (int)cudaGetLastError();
}

// The shared bytes apply_programs_launch gives one CTA at these widths,
// and its items per CTA: the wrapper's fit check is held to them.
extern "C" long long apply_programs_smem(const int* layout, int L, int K) {
  Layout lay{layout[0], layout[1], layout[2], layout[3], layout[4],
             layout[5], layout[6], layout[7], layout[8], layout[9]};
  return (long long)apply_smem_bytes(lay, L, K);
}

extern "C" int apply_programs_items() { return kApplyItems; }
