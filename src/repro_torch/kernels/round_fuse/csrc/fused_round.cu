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
// ~1.3 MB of table rows for W = batch * max_out = 1024 work items
// (in_table, program and constant rows, co-input values) — under half a
// microsecond of HBM time.  What costs is the pop's one CTA — the shared-
// memory traffic of its two sorts of the Q slots (see sched_pop.cu; the
// pop is one static order, not `batch` dependent argmins) — and the
// latency of each of the two launches.
//
// What the design does about it:
//   (a) pop_dispatch — one CTA runs the sorted-selection pop of
//       sched_pop/csrc/pop_select.cuh with the slots' sort words and slot
//       lists in shared memory, then expands each winner to its out_table
//       row with direct loads: targets are -1 for invalid or revoked
//       events, exactly ref.pop_dispatch_ref.
//   (b) apply_programs — a grid of 128-thread CTAs, one thread per work
//       item, and a second grid dimension over shards: shard s reads its
//       own table slice (n_tab rows at offset s * n_tab) and work items,
//       and every shard reads one shared value/timestamp snapshot of
//       n_snap rows (the sharded round's all-gathered view; the fused
//       round passes one shard with n_tab == n_snap).  The Pallas megakernel kept the whole (W, R) register file
//       in VMEM (377 KB at the defaults), more than an SM holds; here each
//       CTA keeps its 128 items' files in shared memory (128 * R * 4 B,
//       47 KB at R = 92), laid out register-major so that the 128 threads
//       of a CTA reading any register each hit their own bank.  Each
//       thread fetches its co-inputs (the trigger slot overridden by the
//       fresh SU), runs its own program up to its last non-NOP
//       instruction, and writes the verdict.
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

constexpr int kApplyThreads = 128;

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

__device__ __forceinline__ float vm_min(float a, float b) {
  if (is_nan(a) || is_nan(b)) return __fadd_rn(a, b);
  if (a < b) return a;
  if (b < a) return b;
  return sign_bit(a) ? a : b;
}

__device__ __forceinline__ float vm_max(float a, float b) {
  if (is_nan(a) || is_nan(b)) return __fadd_rn(a, b);
  if (a > b) return a;
  if (b > a) return b;
  return sign_bit(a) ? b : a;
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

__device__ float vm_op(int op, float av, float bv, float dv, float ca) {
  const float fa = flush(av), fb = flush(bv);
  switch (op) {
    case OP_MOV: return av;
    case OP_CONST: return ca;
    case OP_ADD: return flush(__fadd_rn(fa, fb));
    case OP_SUB: return flush(__fsub_rn(fa, fb));
    case OP_MUL: return flush(__fmul_rn(fa, fb));
    case OP_DIV:
      return abs_bits(bv) < 1e-30f ? 0.0f : flush(__fdiv_rn(fa, fb));
    case OP_MIN: return vm_min(fa, fb);
    case OP_MAX: return vm_max(fa, fb);
    case OP_NEG: return neg_bits(av);
    case OP_ABS: return abs_bits(av);
    case OP_SQRT: return __fsqrt_rn(vm_max(fa, 0.0f));
    case OP_FLOOR: return floorf(fa);
    case OP_LT: return fa < fb ? 1.0f : 0.0f;
    case OP_LE: return fa <= fb ? 1.0f : 0.0f;
    case OP_EQ: return fa == fb ? 1.0f : 0.0f;
    case OP_NE: return fa != fb ? 1.0f : 0.0f;
    case OP_AND: return truth(av) * truth(bv);
    case OP_OR: return vm_max(truth(av), truth(bv));
    case OP_NOT: return 1.0f - truth(av);
    case OP_SELECT: return fa != 0.0f ? bv : dv;
    case OP_ROUND: return rintf(fa);
    case OP_SIGN: return fa > 0.0f ? 1.0f : (fa < 0.0f ? -1.0f : fa);
    default: return dv;  // NOP and every non-fusable opcode
  }
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

// Work item w of shard s = blockIdx.y reads its target row from rows[w]
// (clamped into the shard's n_tab table rows) and its previous value from
// t_sid[w] (clamped into the n_snap snapshot rows, as every co-input is),
// its trigger (source id, timestamp, payload) from entry w / rep of the
// shard's per-event planes, and its validity from item_valid[w], or from
// rows[w] >= 0 when item_valid is null (the fused round's -1 targets).
// Every per-item plane holds W entries per shard, every per-event plane
// W / rep.
__global__ void __launch_bounds__(kApplyThreads) apply_programs_kernel(
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
  extern __shared__ __align__(16) unsigned char smem[];
  const int i = blockIdx.x * kApplyThreads + threadIdx.x;
  if (i >= W) return;
  float* rg = reinterpret_cast<float*>(smem) + threadIdx.x;  // rg[r * 128]
  const int M = lay.max_in, C = lay.channels, R = lay.n_regs;
  const size_t sh = blockIdx.y;
  const size_t w = sh * W + i;                 // this shard's item planes
  const size_t tab = sh * n_tab;               // and its table slice

  const int raw = rows[w];
  const size_t row = tab + clamp_row(raw, n_tab);
  const int tgt = clamp_row(t_sid[w], n_snap);
  const bool item_ok = item_valid ? item_valid[w] != 0 : raw >= 0;
  const size_t e = sh * (W / rep) + i / rep;
  const int src = wi_src[e];
  const int wts = wi_ts[e];
  const float* wv = wi_vals + e * C;
  const int* in_row = in_table + row * M;

  // trigger slot: first valid co-input equal to the source, else 0
  int trig = 0;
  for (int m = M - 1; m >= 0; --m) {
    const int s = in_row[m];
    if (s >= 0 && s == src) trig = m;
  }
  // co-inputs; the trigger slot carries the fresh SU
  int ts_run = INT_MIN;
  for (int m = 0; m < M; ++m) {
    const int s = in_row[m];
    const bool ok = s >= 0;
    const int ss = clamp_row(s, n_snap);
    const bool is_trig = m == trig;
    for (int c = 0; c < C; ++c) {
      const float x = is_trig ? wv[c] : values[(size_t)ss * C + c];
      rg[(lay.reg_inputs + m * C + c) * kApplyThreads] = ok ? x : 0.0f;
    }
    if (ok) {
      const int tm = is_trig ? wts : timestamps[ss];
      ts_run = tm > ts_run ? tm : ts_run;
    }
  }
  for (int c = 0; c < C; ++c)
    rg[(lay.reg_prev + c) * kApplyThreads] = values[(size_t)tgt * C + c];
  rg[lay.reg_ts * kApplyThreads] = __int2float_rn(wts);
  rg[lay.reg_trigger * kApplyThreads] = __int2float_rn(trig);
  for (int r = lay.reg_result; r < R; ++r) rg[r * kApplyThreads] = 0.0f;
  const int prev_ts = timestamps[tgt];

  const int4* prog = progs + row * L;
  const float* cst = consts + row * K;
  for (int pc = 0; pc < L; ++pc) {
    const int4 ins = prog[pc];  // (op, dst, a, b)
    const int op = ins.x;
    if (op == OP_NOP) continue;  // a NOP writes its dst back unchanged
    const float av = rg[read_idx(ins.z, R) * kApplyThreads];
    const float bv = rg[read_idx(ins.w, R) * kApplyThreads];
    const float dv = rg[read_idx(ins.y, R) * kApplyThreads];
    const float ca = cst[read_idx(ins.z, K)];
    const float val = vm_op(op, av, bv, dv, ca);
    const int d = ins.y < 0 ? ins.y + R : ins.y;  // out of range: dropped
    if (d >= 0 && d < R) rg[d * kApplyThreads] = val;
  }

  bool bad = false;
  for (int c = 0; c < C; ++c) {
    const float x = rg[(lay.reg_result + c) * kApplyThreads];
    const bool finite = (__float_as_uint(x) & 0x7f800000u) != 0x7f800000u;
    bad |= !finite;
    new_vals[w * C + c] = finite ? x : 0.0f;
  }
  const bool passf = flush(rg[lay.reg_pref * kApplyThreads]) != 0.0f &&
                     flush(rg[lay.reg_postf * kApplyThreads]) != 0.0f;
  const bool keep_ts = wts > prev_ts;
  int t_out = wts > prev_ts ? wts : prev_ts;
  t_out = ts_run > t_out ? ts_run : t_out;
  const bool live = item_ok && is_comp[row] && active[row];
  ts_out[w] = t_out;
  live_out[w] = live;
  keep_out[w] = live && keep_ts && passf;
  keep_ts_out[w] = keep_ts;
  passf_out[w] = passf;
  badf_out[w] = bad;
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
      n_snap <= 0)
    return (int)cudaErrorInvalidValue;
  Layout lay{layout[0], layout[1], layout[2], layout[3], layout[4],
             layout[5], layout[6], layout[7], layout[8], layout[9]};
  static size_t smem_set[pop_select::kMaxDevices] = {};
  const size_t smem = sizeof(float) * (size_t)lay.n_regs * kApplyThreads;
  const cudaError_t err = pop_select::opt_in_smem(
      (const void*)apply_programs_kernel, smem, smem_set);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + kApplyThreads - 1) / kApplyThreads, n_shards);
  apply_programs_kernel<<<grid, kApplyThreads, smem, (cudaStream_t)stream>>>(
      lay, W, n_tab, n_snap, L, K, rep, (const int*)rows, (const int*)t_sid,
      (const uint8_t*)item_valid, (const int*)wi_src, (const int*)wi_ts,
      (const float*)wi_vals, (const int*)in_table, (const int4*)progs,
      (const float*)consts, (const uint8_t*)is_comp, (const uint8_t*)active,
      (const float*)values, (const int*)timestamps, (float*)new_vals,
      (int*)ts_out, (uint8_t*)live, (uint8_t*)keep, (uint8_t*)keep_ts,
      (uint8_t*)passf, (uint8_t*)badf);
  return (int)cudaGetLastError();
}
