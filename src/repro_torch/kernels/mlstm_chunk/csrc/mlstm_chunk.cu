// mlstm_chunk: the chunkwise-parallel mLSTM from the zero state, written
// for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/mlstm_chunk/kernel.py, mlstm_chunkwise
// (Pallas body _mlstm_kernel) of the JAX package.
//
// Inputs as the model plane's mlstm_block builds them: q, k, v
// (B*H, L, Dh) float32, i_raw and f_raw (B*H, L) float32.  Outputs h
// (B*H, L, Dh) float32 and the final state C (B*H, Dh, Dh), n (B*H, Dh),
// m (B*H), float32.  The sequence is cut into chunks of ck positions (the
// last one may be shorter); any chunking computes the same function.
//
// What bounds it on this card: operations.  Per (b, h, chunk) it needs
// S = q k^T and (S.D) v over the causal half of the chunk (2 Dh ck (ck+1)
// each), q C0^T (2 ck Dh^2, none in the first chunk) and the state update
// (2 ck Dh^2): at xlstm-1.3b's layer (B 2, H 4, L 4096, Dh 1024, ck 256)
// 150 GFLOP, ~2.2 ms at the 67 TFLOP/s float32 rate, while its bytes
// (q, k, v, h and the final state, ~0.57 GB) take ~0.17 ms at 3.35 TB/s.
//
// Why it is not the Pallas body: that kernel keeps the whole (Dh, Dh)
// matrix memory in VMEM for the sequence, one grid row per (b, h) with
// the chunks in order.  At Dh 1024 that state is 4 MB, and a CTA has at
// most 227 KB of shared memory.  So the work is split into four launches:
//
//  1. gate: one CTA per (b, h) over the whole sequence.  The in-chunk
//     cumulative log forget gate b (one thread per chunk, in order, as a
//     sequential cumsum), the intra-chunk stabiliser max_j (b_t - b_j) +
//     i_j, the running stabiliser m chained across chunks, and per
//     position m_t, the inter-chunk weight exp(b + m0 - m_t) and the
//     end-of-chunk weight exp(b_last - b + i - m_new); per chunk the state
//     scale exp(b_last + m0 - m_new).  O(L ck) scalar work.
//  2. state: one CTA per (b, h, 64 x 64 tile of C) runs the chunks in
//     order, C <- scale C + sum_j w_j v_j k_j^T, keeping its tile in
//     registers, and writes the state at every chunk's start (chunks
//     1..nc-1; chunk 0 starts from zero) and the final one.  CTAs of the
//     first row of tiles carry n alike.
//  3. intra: one CTA per (b, h, chunk, 64 x 64 tile of the lower triangle
//     of the chunk's (ck, ck) score matrix) writes S.D, with the masked
//     entries stored as exact zeros (no exp of -1e30 - -1e30).
//  4. out: one CTA per (b, h, chunk, 64 rows, 64 columns of h) computes
//     num = (S.D) v + inter q C0^T and den = sum_j (S.D) + inter q.n0 and
//     h = num / max(|den|, exp(-m_t)).
//
// The products are scalar float32 FMAs (explicit fmaf) from 16-deep
// shared-memory slices, 4 x 4 outputs a thread: a first version that is
// right, not fast.  The build's -fmad=false leaves those fmaf calls fused
// and keeps the gates' and the epilogues' a*b+c as the plain version
// computes them, a multiply and an add.  Scratch (the gate vectors, the
// chunk-start states and S.D) is allocated by the caller.
#include <cuda_runtime.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kT = 64;          // output tile edge
constexpr int kK = 16;          // depth of one shared-memory slice
constexpr int kThreads = 256;   // 16 x 16 threads, 4 x 4 outputs each
constexpr int kLd = kT + 4;     // row of a transposed tile (float4-aligned)
constexpr int kGateThreads = 1024;

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// acc[r][e] += a[r] * b[e] over one 16-deep slice: a from as[kk][ty*4+r],
// b from bs[kk][tx*4+e].
template <int kLa, int kLb>
__device__ __forceinline__ void slice_fma(const float (*as)[kLa],
                                          const float (*bs)[kLb], int ty,
                                          int tx, float acc[4][4]) {
#pragma unroll
  for (int kk = 0; kk < kK; ++kk) {
    const float4 a = ld4(&as[kk][ty * 4]);
    const float4 b = ld4(&bs[kk][tx * 4]);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][e] = fmaf(av[r], bv[e], acc[r][e]);
  }
}

// ---------------------------------------------------------------- 1. gate
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

// --------------------------------------------------------------- 2. state
__global__ void __launch_bounds__(kThreads) mlstm_state_kernel(
    const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ wj, const float* __restrict__ cscale,
    float* __restrict__ cstates, float* __restrict__ nstates,
    float* __restrict__ cout, float* __restrict__ nout, int L, int Dh,
    int ck, int nc) {
  __shared__ __align__(16) float vs[kK][kT];
  __shared__ __align__(16) float ks[kK][kT];
  __shared__ float ws[kK];
  const int bh = blockIdx.z, v0 = blockIdx.y * kT, k0 = blockIdx.x * kT;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int lr = tid / 16, lc = (tid % 16) * 4;   // load: row, column
  const long long seq = static_cast<long long>(bh) * L;
  const float* kb = k + seq * Dh;
  const float* vb = v + seq * Dh;
  const bool carry_n = blockIdx.y == 0 && tid < kT && k0 + tid < Dh;
  const long long dd = static_cast<long long>(Dh) * Dh;
  float acc[4][4] = {};
  float n_acc = 0.f;
  for (int c = 0; c < nc; ++c) {
    const int t0 = c * ck, len = min(ck, L - t0);
    if (c > 0) {                  // the state at the start of chunk c
      float* cs = cstates + (static_cast<long long>(bh) * (nc - 1) + c - 1) * dd;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = v0 + ty * 4 + r, col = k0 + tx * 4;
        if (row < Dh && col < Dh)
          *reinterpret_cast<float4*>(cs + static_cast<long long>(row) * Dh + col) =
              make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
      }
      if (carry_n)
        nstates[(static_cast<long long>(bh) * (nc - 1) + c - 1) * Dh + k0 + tid] = n_acc;
    }
    float part[4][4] = {};
    float n_part = 0.f;
    for (int j0 = 0; j0 < len; j0 += kK) {
      const int j = j0 + lr;
      float4 vv = make_float4(0.f, 0.f, 0.f, 0.f), kv = vv;
      if (j < len) {
        const long long row = static_cast<long long>(t0 + j) * Dh;
        const float w = wj[seq + t0 + j];
        if (v0 + lc < Dh) {
          vv = ld4(vb + row + v0 + lc);
          vv = make_float4(w * vv.x, w * vv.y, w * vv.z, w * vv.w);
        }
        if (k0 + lc < Dh) kv = ld4(kb + row + k0 + lc);
        if (lc == 0) ws[lr] = w;
      } else if (lc == 0) {
        ws[lr] = 0.f;
      }
      *reinterpret_cast<float4*>(&vs[lr][lc]) = vv;
      *reinterpret_cast<float4*>(&ks[lr][lc]) = kv;
      __syncthreads();
      slice_fma<kT, kT>(vs, ks, ty, tx, part);
      if (carry_n) {
#pragma unroll
        for (int kk = 0; kk < kK; ++kk) n_part = fmaf(ws[kk], ks[kk][tid], n_part);
      }
      __syncthreads();
    }
    const float s = cscale[static_cast<long long>(bh) * nc + c];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][e] = s * acc[r][e] + part[r][e];
    n_acc = s * n_acc + n_part;
  }
  float* co = cout + bh * dd;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = v0 + ty * 4 + r, col = k0 + tx * 4;
    if (row < Dh && col < Dh)
      *reinterpret_cast<float4*>(co + static_cast<long long>(row) * Dh + col) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  }
  if (carry_n) nout[static_cast<long long>(bh) * Dh + k0 + tid] = n_acc;
}

// Load rows [r0, r0 + 64) x columns [c0, c0 + 16) of a row-major matrix
// (row stride ld, rows < n_rows, columns < n_cols valid, zero elsewhere)
// transposed into dst[col][row], times scale.  Returns the sum of the
// four values this thread loaded (its row is tid / 4), or with ``dot``
// (read only where Dh % 4 == 0 bounds the columns) their dot product
// with dot[c0 + col ...].
__device__ __forceinline__ float load_t(float (*dst)[kLd], const float* src,
                                        long long ld, int r0, int n_rows,
                                        int c0, int n_cols, float scale,
                                        const float* dot = nullptr) {
  const int row = threadIdx.x / 4, col = (threadIdx.x % 4) * 4;
  float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
  if (r0 + row < n_rows && c0 + col < n_cols) {
    const float* p = src + (r0 + row) * ld + c0 + col;
    if (ld % 4 == 0 && c0 + col + 3 < n_cols) {
      x = ld4(p);
    } else {                      // a ragged edge: element by element
      x.x = p[0];
      x.y = c0 + col + 1 < n_cols ? p[1] : 0.f;
      x.z = c0 + col + 2 < n_cols ? p[2] : 0.f;
      x.w = c0 + col + 3 < n_cols ? p[3] : 0.f;
    }
    x = make_float4(x.x * scale, x.y * scale, x.z * scale, x.w * scale);
  }
  dst[col][row] = x.x;
  dst[col + 1][row] = x.y;
  dst[col + 2][row] = x.z;
  dst[col + 3][row] = x.w;
  if (dot == nullptr) return ((x.x + x.y) + x.z) + x.w;
  if (c0 + col >= n_cols) return 0.f;
  const float4 d = ld4(dot + c0 + col);
  return fmaf(x.w, d.w, fmaf(x.z, d.z, fmaf(x.y, d.y, x.x * d.x)));
}

// --------------------------------------------------------------- 3. intra
__global__ void __launch_bounds__(kThreads) mlstm_intra_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ i_raw, const float* __restrict__ bcum,
    const float* __restrict__ mt, float* __restrict__ sd, int L, int Dh,
    int ck, int nc, float scale) {
  const int jt = blockIdx.x, tt = blockIdx.y;
  const int c = blockIdx.z % nc, bh = blockIdx.z / nc;
  const int t0 = c * ck, len = min(ck, L - t0);
  const int r0 = tt * kT, j0 = jt * kT;
  if (jt > tt || r0 >= len) return;
  __shared__ __align__(16) float qs[kK][kLd];
  __shared__ __align__(16) float ks[kK][kLd];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const long long seq = static_cast<long long>(bh) * L + t0;
  const float* qb = q + seq * Dh;
  const float* kb = k + seq * Dh;
  float acc[4][4] = {};
  for (int d0 = 0; d0 < Dh; d0 += kK) {
    load_t(qs, qb, Dh, r0, len, d0, Dh, scale);
    load_t(ks, kb, Dh, j0, len, d0, Dh, 1.f);
    __syncthreads();
    slice_fma<kLd, kLd>(qs, ks, ty, tx, acc);
    __syncthreads();
  }
  float* out = sd + (static_cast<long long>(bh) * nc + c) * ck * ck;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int t = r0 + ty * 4 + r;
    if (t >= len) continue;
    const float bt = bcum[seq + t], m = mt[seq + t];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = j0 + tx * 4 + e;
      if (j >= len) continue;
      out[static_cast<long long>(t) * ck + j] =
          j <= t ? acc[r][e] * expf(((bt - bcum[seq + j]) + i_raw[seq + j]) - m)
                 : 0.f;
    }
  }
}

// ----------------------------------------------------------------- 4. out
__global__ void __launch_bounds__(kThreads) mlstm_out_kernel(
    const float* __restrict__ q, const float* __restrict__ v,
    const float* __restrict__ sd, const float* __restrict__ cstates,
    const float* __restrict__ nstates, const float* __restrict__ inter,
    const float* __restrict__ mt, float* __restrict__ h, int L, int Dh,
    int ck, int nc, float scale) {
  const int v0 = blockIdx.x * kT, r0 = blockIdx.y * kT;
  const int c = blockIdx.z % nc, bh = blockIdx.z / nc;
  const int t0 = c * ck, len = min(ck, L - t0);
  if (r0 >= len) return;
  __shared__ __align__(16) float as[kK][kLd];
  __shared__ __align__(16) float bs[kK][kLd];
  __shared__ float den_s[kT], qn_s[kT];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const long long seq = static_cast<long long>(bh) * L + t0;
  // num = (S.D) v over the keys of this chunk up to the tile's last row
  const float* sdb = sd + (static_cast<long long>(bh) * nc + c) * ck * ck;
  const float* vb = v + seq * Dh;
  const int j_end = min(r0 + kT, len);
  float acc[4][4] = {};
  float den = 0.f;
  for (int j0 = 0; j0 < j_end; j0 += kK) {
    den += load_t(as, sdb, ck, r0, len, j0, j_end, 1.f);
    const int lr = tid / 16, lc = (tid % 16) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (j0 + lr < j_end && v0 + lc < Dh)
      x = ld4(vb + static_cast<long long>(j0 + lr) * Dh + v0 + lc);
    *reinterpret_cast<float4*>(&bs[lr][lc]) = x;
    __syncthreads();
    slice_fma<kLd, kLd>(as, bs, ty, tx, acc);
    __syncthreads();
  }
  // the carried state's term: inter q C0^T and inter q.n0 (chunk 0
  // starts from zero)
  float acc2[4][4] = {};
  float qn = 0.f;
  if (c > 0) {
    const long long slot = static_cast<long long>(bh) * (nc - 1) + c - 1;
    const float* c0 = cstates + slot * Dh * Dh;
    const float* n0 = nstates + slot * Dh;
    const float* qb = q + seq * Dh;
    for (int d0 = 0; d0 < Dh; d0 += kK) {
      qn += load_t(as, qb, Dh, r0, len, d0, Dh, scale, n0);
      load_t(bs, c0, Dh, v0, Dh, d0, Dh, 1.f);
      __syncthreads();
      slice_fma<kLd, kLd>(as, bs, ty, tx, acc2);
      __syncthreads();
    }
  }
  // the four threads of a loaded row hold its partial sums
  den += __shfl_xor_sync(0xffffffffu, den, 1);
  den += __shfl_xor_sync(0xffffffffu, den, 2);
  qn += __shfl_xor_sync(0xffffffffu, qn, 1);
  qn += __shfl_xor_sync(0xffffffffu, qn, 2);
  if (tid % 4 == 0) {
    den_s[tid / 4] = den;
    qn_s[tid / 4] = qn;
  }
  __syncthreads();
  float* hb = h + seq * Dh;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = ty * 4 + r, t = r0 + row, col = v0 + tx * 4;
    if (t >= len || col >= Dh) continue;
    const float m = mt[seq + t];
    float num[4] = {acc[r][0], acc[r][1], acc[r][2], acc[r][3]};
    float d = den_s[row];
    if (c > 0) {
      const float w = inter[seq + t];
#pragma unroll
      for (int e = 0; e < 4; ++e) num[e] = num[e] + w * acc2[r][e];
      d = d + w * qn_s[row];
    }
    const float lim = fmaxf(fabsf(d), expf(-m));
    *reinterpret_cast<float4*>(hb + static_cast<long long>(t) * Dh + col) =
        make_float4(num[0] / lim, num[1] / lim, num[2] / lim, num[3] / lim);
  }
}

}  // namespace

// The four launches in order on ``stream`` (``stage`` < 0), or only
// launch ``stage`` (0 gate, 1 state, 2 intra, 3 out; to time one alone
// once a full call has filled its inputs).  Dh must be a multiple of 4;
// scratch: gates (4, BH, L) [b, m_t, inter, w], mchain (BH, nc + 1),
// cscale (BH, nc), cstates (BH, nc - 1, Dh, Dh), nstates (BH, nc - 1, Dh),
// sd (BH, nc, ck, ck).  Returns a cudaError_t code (0 = launched).
extern "C" int mlstm_chunk_launch(const void* q, const void* k, const void* v,
                                  const void* i_raw, const void* f_raw,
                                  void* h, void* c_out, void* n_out,
                                  void* m_out, void* gates, void* mchain,
                                  void* cscale, void* cstates, void* nstates,
                                  void* sd, int BH, int L, int Dh, int ck,
                                  float scale, void* stream, int stage) {
  if (BH < 1 || L < 1 || Dh < 4 || Dh % 4 || ck < 1 || ck > L)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nc = (L + ck - 1) / ck;
  if (static_cast<long long>(nc) * BH > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* fq = static_cast<const float*>(q);
  const auto* fk = static_cast<const float*>(k);
  const auto* fv = static_cast<const float*>(v);
  const auto* fi = static_cast<const float*>(i_raw);
  auto* g = static_cast<float*>(gates);
  const long long n = static_cast<long long>(BH) * L;
  float *bcum = g, *mt = g + n, *inter = g + 2 * n, *wj = g + 3 * n;
  auto* cs = static_cast<float*>(cscale);
  auto* cst = static_cast<float*>(cstates);
  auto* nst = static_cast<float*>(nstates);
  auto* fsd = static_cast<float*>(sd);

  const unsigned dt = static_cast<unsigned>((Dh + kT - 1) / kT);
  const unsigned ct = static_cast<unsigned>((ck + kT - 1) / kT);
  const unsigned z = static_cast<unsigned>(nc * BH);
  cudaError_t err = cudaSuccess;
  if (stage < 0 || stage == 0) {
    mlstm_gate_kernel<<<BH, kGateThreads, 0, st>>>(
        fi, static_cast<const float*>(f_raw), bcum, mt, inter, wj,
        static_cast<float*>(mchain), cs, static_cast<float*>(m_out), L, ck,
        nc);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  if (stage < 0 || stage == 1) {
    mlstm_state_kernel<<<dim3(dt, dt, BH), kThreads, 0, st>>>(
        fk, fv, wj, cs, cst, nst, static_cast<float*>(c_out),
        static_cast<float*>(n_out), L, Dh, ck, nc);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  if (stage < 0 || stage == 2) {
    mlstm_intra_kernel<<<dim3(ct, ct, z), kThreads, 0, st>>>(
        fq, fk, fi, bcum, mt, fsd, L, Dh, ck, nc, scale);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  if (stage < 0 || stage == 3) {
    mlstm_out_kernel<<<dim3(dt, ct, z), kThreads, 0, st>>>(
        fq, fv, fsd, cst, nst, inter, mt, static_cast<float*>(h), L, Dh, ck,
        nc, scale);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}
