// Backward of prefill GQA attention (causal, optional sliding window and
// attention sinks): dq, dk and dv from q, k, v, the forward's output o and
// the output's gradient dO.
//
// Replaces no Pallas kernel: the JAX package trains with impl="ref" and lets
// autodiff differentiate the plain body repro/kernels/ref.py::
// flash_attention_ref, the function whose forward is the TPU kernel
// repro/kernels/flash_attention.py::flash_attention (pl.pallas_call at :97).
// Training on the card runs ops.flash_attention's forward kernels, so their
// backward is a kernel too. Same contract as the forward: q (B,Sq,Hq,D), k/v
// (B,Sk,Hkv,D), o/dO like q, f32 or bf16, f32 arithmetic, dq/dk/dv in the
// inputs' dtype; key j is attended by query row i (absolute position
// i + q_offset) iff j <= row (causal), j > row - window (window>0), or
// j < sink (sink>0, only with a window); the scale is 1/sqrt(D) as the
// forward's. dk and dv of a kv head sum over its GQA group's query heads.
//
// With P = softmax(scale·q·kᵀ) over the allowed keys, dP = dO·vᵀ and
// Δ_i = Σ_d dO_i·o_i (= Σ_j P_ij·dP_ij):
//   dS = P∘(dP − Δ),  dq = scale·dS·k,  dk = scale·dSᵀ·q,  dv = Pᵀ·dO.
// P is recomputed in f32 from q and k, so this is the gradient of the
// unrounded function: the bf16 tensor-core forward rounds P to bf16 before
// P·V, the backward does not. A row with no allowed key (never built by a
// causal caller) has P = 0 and adds nothing, as the forward returns 0 there.
//
// Tolerance against ref.flash_attention_bwd_ref run on the same inputs
// widened to f32: the kernel's arithmetic is f32 like the plain version's,
// in another order, so in f32 the two differ by summation order alone
// (1e-4·max|plain| + 1e-5, a tensor's largest value scaling the order term:
// dq and dk are sums of signed terms that cancel). In bf16 each output is
// also rounded once to bf16, at most half a bf16 step, 2^-9 of its value;
// no P-rounding term enters, since both sides take P in f32. So bf16 is held
// to 2^-8·|plain| + 1e-4·max|plain| + 1e-5.
//
// What bounds it on the H100: the work is about 2.5 times the forward's
// products (S = q·kᵀ and dP = dO·vᵀ, then dq, dk and dv: five D-long
// products a pair against the forward's two) plus launch 1's recompute of
// q·kᵀ, all on the FMA units at 67 TFLOP/s f32: compute-bound at the
// training shapes. A simple design first (no tensor cores, three launches,
// no atomics, so the results are deterministic, which resume-exactness
// needs):
//   1. stats: per (64-row q tile, q head, batch) the row's log-sum-exp
//      L = m + log l over its allowed keys, and Δ;
//   2. dq: per (64-row q tile, q head, batch), over the key tiles the rows
//      can see (causal and window tiles skipped as in the forward): S and
//      dP from Qᵀ/dOᵀ tiles and padded K/V rows in shared memory, dS into
//      shared memory, dq += dS·K in registers (4 rows x D/8 columns a
//      thread);
//   3. dk, dv: per (key tile, kv head, batch), over the group's query
//      heads and the q tiles that can see the tile (a tile holding a sink
//      key is seen by every later row, so it loops over every q tile past
//      it): Sᵀ and dPᵀ from Kᵀ/Vᵀ tiles and padded Q/dO rows, P and dS
//      into shared memory, dk and dv in registers.
// Thread layout as the forward's: 128 threads, 16 row groups x 8 column
// lanes; output columns 32u + 4·tx + e (at D = 80 the third 32-column
// group's upper half, columns 80-95, predicated off, D = 128's lanes). The
// key tile is 64 keys for D <= 64 in launch 3 and D <= 128 in launch 2, 32
// above, so that the accumulators fit in registers (launch 3: 2 x 2 x D/8
// floats at 32 keys; 4 x 2 x D/8 at 64) and the tiles in shared memory (at
// D = 256: 214 KB in launch 2, 224 KB in launch 3, one block an SM).
#include <math.h>

#include "common.cuh"

namespace h2eal {

struct BwdArgs {
  const void *q, *k, *v, *o, *dout;
  void *dq, *dk, *dv;
  float *lse, *delta;  // (B, Hq, Sq) f32: the rows' log-sum-exp and Δ
  int b, sq, sk, hq, hkv, causal, window, sink, q_offset;
  float scale;
  cudaStream_t stream;
};
cudaError_t flash_bwd_f32(int d, const BwdArgs& a);
cudaError_t flash_bwd_bf16(int d, const BwdArgs& a);

namespace {

constexpr int NT = 128;     // 16 row groups x 8 column lanes
constexpr int BQ = 64;      // query rows a tile
constexpr int QS = BQ + 4;  // transposed q-tile row stride (float4-aligned)

__device__ __forceinline__ bool allowed(int row, int col, int sk, int causal, int window,
                                        int sink) {
  bool ok = col < sk;
  if (causal) ok = ok && col <= row;
  if (window > 0) ok = ok && (col > row - window || col < sink);
  return ok;
}

// key tiles [0, end) that the rows i_min..i_max can see; tile kt is skipped
// by the caller where no key of it is in any row's window and none is a sink
__device__ __forceinline__ int key_tiles_end(int sk, int bk, int i_max, int causal) {
  int end = (sk + bk - 1) / bk;
  if (causal) end = min(end, i_max / bk + 1);
  return end;
}

__device__ __forceinline__ bool tile_unseen(int c0, int bk, int i_min, int window, int sink) {
  return window > 0 && c0 >= sink && c0 + bk - 1 <= i_min - window;
}

// ---------------------------------------------------------------------------
// 1. the rows' log-sum-exp and Δ
// ---------------------------------------------------------------------------

constexpr int SBK = 64;      // keys a tile
constexpr int SKS = SBK + 1;  // Kt[d][c] row stride

template <int D>
__host__ __device__ constexpr int stats_smem() {
  return (D * QS + D * SKS) * 4;
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) stats_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ o,
    const T* __restrict__ dout, float* __restrict__ lse, float* __restrict__ delta, int sq,
    int sk, int hq, int hkv, int causal, int window, int sink, int q_offset, float scale) {
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);  // [D][QS]
  float* Kt = Qt + D * QS;                      // [D][SKS]

  const int r0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int tid = threadIdx.x;
  const int ty = tid >> 3;
  const int tx = tid & 7;
  const long q_rs = (long)hq * D;
  const long k_rs = (long)hkv * D;
  const T* qb = q + ((long)b * sq * hq + h) * D;
  const T* kb = k + ((long)b * sk * hkv + hk) * D;
  float* lse_b = lse + ((long)b * hq + h) * sq;
  float* delta_b = delta + ((long)b * hq + h) * sq;

  for (int idx = tid; idx < BQ * D; idx += NT) {
    const int r = idx / D, d = idx % D;
    Qt[d * QS + r] = r0 + r < sq ? to_f32(qb[(long)(r0 + r) * q_rs + d]) : 0.f;
  }
  {  // Δ: two threads a row, half of D each
    const int r = tid >> 1, s = r0 + r;
    float acc = 0.f;
    if (s < sq) {
      const long off = (((long)b * sq + s) * hq + h) * D;
      for (int d = (tid & 1); d < D; d += 2) acc += to_f32(dout[off + d]) * to_f32(o[off + d]);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (s < sq && (tid & 1) == 0) delta_b[s] = acc;
  }

  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }
  const int i_min = r0 + q_offset;
  const int i_max = r0 + BQ - 1 + q_offset;
  const int kt_end = key_tiles_end(sk, SBK, i_max, causal);
  for (int kt = 0; kt < kt_end; ++kt) {
    const int c0 = kt * SBK;
    if (tile_unseen(c0, SBK, i_min, window, sink)) continue;
    __syncthreads();  // the previous tile's reads of Kt are done
    for (int idx = tid; idx < SBK * D; idx += NT) {
      const int c = idx / D, d = idx % D;
      Kt[d * SKS + c] = c0 + c < sk ? to_f32(kb[(long)(c0 + c) * k_rs + d]) : 0.f;
    }
    __syncthreads();
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) s[i][jj] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(&Qt[d * QS + ty * 4]);
      const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const float kk = Kt[d * SKS + tx + 8 * jj];
#pragma unroll
        for (int i = 0; i < 4; ++i) s[i][jj] = fmaf(qa[i], kk, s[i][jj]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + ty * 4 + i + q_offset;
      float mx = kNegInf;
      bool ok[8];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        ok[jj] = allowed(row, c0 + tx + 8 * jj, sk, causal, window, sink);
        s[i][jj] = ok[jj] ? s[i][jj] * scale : kNegInf;
        mx = fmaxf(mx, s[i][jj]);
      }
      mx = group8_max(mx);
      const float m_new = fmaxf(m[i], mx);
      float ps = 0.f;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) ps += ok[jj] ? expf(s[i][jj] - m_new) : 0.f;
      l[i] = l[i] * expf(m[i] - m_new) + group8_sum(ps);
      m[i] = m_new;
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int s = r0 + ty * 4 + i;
      // no allowed key: P = exp(x - inf) = 0 in launches 2 and 3
      if (s < sq) lse_b[s] = l[i] > 0.f ? m[i] + logf(l[i]) : INFINITY;
    }
  }
}

// ---------------------------------------------------------------------------
// 2. dq
// ---------------------------------------------------------------------------

template <int D>
__host__ __device__ constexpr int dq_bk() {
  return D <= 128 ? 64 : 32;
}

template <int D>
__host__ __device__ constexpr int dq_smem() {
  constexpr int bk = dq_bk<D>();
  return (2 * D * QS + 2 * bk * (D + 1) + bk * QS + 2 * BQ) * 4;
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq, int sq, int sk, int hq, int hkv,
    int causal, int window, int sink, int q_offset, float scale) {
  constexpr int BK = dq_bk<D>();
  constexpr int JJ = BK / 8;        // key columns a thread
  constexpr int KR = D + 1;         // Ks/Vs row stride (conflict-free column reads)
  constexpr int U = (D + 31) / 32;  // 32-column groups of the output
  constexpr int DC = 4 * U;
  static_assert(D % 4 == 0, "a thread's 4 columns of a group lie wholly in or past D");
  static_assert(dq_smem<D>() <= 232448, "launch 2's tiles exceed a block's shared memory");
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);  // [D][QS]
  float* dOt = Qt + D * QS;                     // [D][QS]
  float* Ks = dOt + D * QS;                     // [BK][KR]
  float* Vs = Ks + BK * KR;                     // [BK][KR]
  float* dSt = Vs + BK * KR;                    // [BK][QS]
  float* Lr = dSt + BK * QS;                    // [BQ]
  float* Dr = Lr + BQ;                          // [BQ]

  const int qtile = gridDim.x - 1 - blockIdx.x;  // the heaviest tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int tid = threadIdx.x;
  const int ty = tid >> 3;
  const int tx = tid & 7;
  const int r0 = qtile * BQ;
  const long q_rs = (long)hq * D;
  const long k_rs = (long)hkv * D;
  const long qoff = ((long)b * sq * hq + h) * D;
  const T* kb = k + ((long)b * sk * hkv + hk) * D;
  const T* vb = v + ((long)b * sk * hkv + hk) * D;
  const long soff = ((long)b * hq + h) * sq;

  for (int idx = tid; idx < BQ * D; idx += NT) {
    const int r = idx / D, d = idx % D;
    const bool in = r0 + r < sq;
    const long off = qoff + (long)(r0 + r) * q_rs + d;
    Qt[d * QS + r] = in ? to_f32(q[off]) : 0.f;
    dOt[d * QS + r] = in ? to_f32(dout[off]) : 0.f;
  }
  for (int r = tid; r < BQ; r += NT) {
    const bool in = r0 + r < sq;
    Lr[r] = in ? lse[soff + r0 + r] : INFINITY;
    Dr[r] = in ? delta[soff + r0 + r] : 0.f;
  }

  float acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;

  const int i_min = r0 + q_offset;
  const int i_max = r0 + BQ - 1 + q_offset;
  const int kt_end = key_tiles_end(sk, BK, i_max, causal);
  for (int kt = 0; kt < kt_end; ++kt) {
    const int c0 = kt * BK;
    if (tile_unseen(c0, BK, i_min, window, sink)) continue;
    __syncthreads();  // the previous tile's reads of Ks and dSt are done
    for (int idx = tid; idx < BK * D; idx += NT) {
      const int c = idx / D, d = idx % D;
      float kv = 0.f, vv = 0.f;
      if (c0 + c < sk) {
        const long off = (long)(c0 + c) * k_rs + d;
        kv = to_f32(kb[off]);
        vv = to_f32(vb[off]);
      }
      Ks[c * KR + d] = kv;
      Vs[c * KR + d] = vv;
    }
    __syncthreads();

    float s[4][JJ], dp[4][JJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < JJ; ++jj) s[i][jj] = dp[i][jj] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(&Qt[d * QS + ty * 4]);
      const float4 gv = *reinterpret_cast<const float4*>(&dOt[d * QS + ty * 4]);
      const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
      const float ga[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
      for (int jj = 0; jj < JJ; ++jj) {
        const float kk = Ks[(tx + 8 * jj) * KR + d];
        const float vv = Vs[(tx + 8 * jj) * KR + d];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[i][jj] = fmaf(qa[i], kk, s[i][jj]);
          dp[i][jj] = fmaf(ga[i], vv, dp[i][jj]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      const int row = r0 + r + q_offset;
#pragma unroll
      for (int jj = 0; jj < JJ; ++jj) {
        const int c = tx + 8 * jj;
        const float p = allowed(row, c0 + c, sk, causal, window, sink)
                            ? expf(s[i][jj] * scale - Lr[r]) : 0.f;
        dSt[c * QS + r] = p * (dp[i][jj] - Dr[r]);
      }
    }
    __syncthreads();

#pragma unroll 2
    for (int j = 0; j < BK; ++j) {
      const float4 dv4 = *reinterpret_cast<const float4*>(&dSt[j * QS + ty * 4]);
      const float da[4] = {dv4.x, dv4.y, dv4.z, dv4.w};
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (32 * u + 4 * tx >= D) break;  // at D = 80, the last group's upper half
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float kk = Ks[j * KR + 32 * u + 4 * tx + e];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][4 * u + e] = fmaf(da[i], kk, acc[i][4 * u + e]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int srow = r0 + ty * 4 + i;
    if (srow >= sq) continue;
    T* out = dq + qoff + (long)srow * q_rs;
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (32 * u + 4 * tx < D) store(&out[32 * u + 4 * tx + e], acc[i][4 * u + e] * scale);
  }
}

// ---------------------------------------------------------------------------
// 3. dk and dv
// ---------------------------------------------------------------------------

template <int D>
__host__ __device__ constexpr int kv_bk() {
  return D <= 64 ? 64 : 32;
}

template <int D>
__host__ __device__ constexpr int kv_smem() {
  constexpr int bk = kv_bk<D>();
  return (2 * D * (bk + 4) + 2 * BQ * (D + 1) + 2 * BQ * (bk + 4) + 2 * BQ) * 4;
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int sq, int sk,
    int hq, int hkv, int causal, int window, int sink, int q_offset, float scale) {
  constexpr int BK = kv_bk<D>();
  constexpr int RK = BK / 16;       // key rows a thread
  constexpr int KS = BK + 4;        // Kt/Vt/Pt/dSt row stride
  constexpr int QR = D + 1;         // Qs/dOs row stride (conflict-free column reads)
  constexpr int U = (D + 31) / 32;
  constexpr int DC = 4 * U;
  static_assert(D % 4 == 0, "a thread's 4 columns of a group lie wholly in or past D");
  static_assert(kv_smem<D>() <= 232448, "launch 3's tiles exceed a block's shared memory");
  extern __shared__ float4 smem4[];
  float* Kt = reinterpret_cast<float*>(smem4);  // [D][KS]
  float* Vt = Kt + D * KS;                      // [D][KS]
  float* Qs = Vt + D * KS;                      // [BQ][QR]
  float* dOs = Qs + BQ * QR;                    // [BQ][QR]
  float* Pt = dOs + BQ * QR;                    // [BQ][KS]: P[r][c]
  float* dSt = Pt + BQ * KS;                    // [BQ][KS]: dS[r][c]
  float* Lr = dSt + BQ * KS;                    // [BQ]
  float* Dr = Lr + BQ;                          // [BQ]

  const int kt = blockIdx.x;  // under causal, the first key tiles are the heaviest
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int group = hq / hkv;
  const int tid = threadIdx.x;
  const int ty = tid >> 3;  // key rows ty*RK .. ty*RK + RK-1
  const int tx = tid & 7;   // query columns tx + 8*jj; output columns 32u + 4tx + e
  const int c0 = kt * BK;
  const long q_rs = (long)hq * D;
  const long k_rs = (long)hkv * D;
  const long koff = ((long)b * sk * hkv + hk) * D;

  for (int idx = tid; idx < BK * D; idx += NT) {
    const int c = idx / D, d = idx % D;
    const bool in = c0 + c < sk;
    const long off = koff + (long)(c0 + c) * k_rs + d;
    Kt[d * KS + c] = in ? to_f32(k[off]) : 0.f;
    Vt[d * KS + c] = in ? to_f32(v[off]) : 0.f;
  }

  float ak[RK][DC], av[RK][DC];
#pragma unroll
  for (int i = 0; i < RK; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) ak[i][c] = av[i][c] = 0.f;

  // the q tiles whose rows can see a key of [c0, c1]
  const int nqt = (sq + BQ - 1) / BQ;
  const int c1 = min(c0 + BK, sk) - 1;
  int qt_lo = causal ? max(0, c0 - q_offset) / BQ : 0;
  int qt_hi = nqt - 1;
  if (window > 0 && c0 >= sink) {  // no sink key here: rows up to c1 + window - 1
    const int last = c1 + window - 1 - q_offset;
    qt_hi = last < 0 ? -1 : min(qt_hi, last / BQ);
  }

  for (int hh = 0; hh < group; ++hh) {
    const int h = hk * group + hh;
    const long qoff = ((long)b * sq * hq + h) * D;
    const long soff = ((long)b * hq + h) * sq;
    for (int qt = qt_lo; qt <= qt_hi; ++qt) {
      const int r0 = qt * BQ;
      __syncthreads();  // the previous tile's reads of Qs, dOs, Pt and dSt are done
      for (int idx = tid; idx < BQ * D; idx += NT) {
        const int r = idx / D, d = idx % D;
        const bool in = r0 + r < sq;
        const long off = qoff + (long)(r0 + r) * q_rs + d;
        Qs[r * QR + d] = in ? to_f32(q[off]) : 0.f;
        dOs[r * QR + d] = in ? to_f32(dout[off]) : 0.f;
      }
      for (int r = tid; r < BQ; r += NT) {
        const bool in = r0 + r < sq;
        Lr[r] = in ? lse[soff + r0 + r] : INFINITY;
        Dr[r] = in ? delta[soff + r0 + r] : 0.f;
      }
      __syncthreads();

      float s[RK][8], dp[RK][8];
#pragma unroll
      for (int i = 0; i < RK; ++i)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) s[i][jj] = dp[i][jj] = 0.f;
#pragma unroll 2
      for (int d = 0; d < D; ++d) {
        float ka[RK], va[RK];
#pragma unroll
        for (int i = 0; i < RK; ++i) {
          ka[i] = Kt[d * KS + ty * RK + i];
          va[i] = Vt[d * KS + ty * RK + i];
        }
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const float qq = Qs[(tx + 8 * jj) * QR + d];
          const float gg = dOs[(tx + 8 * jj) * QR + d];
#pragma unroll
          for (int i = 0; i < RK; ++i) {
            s[i][jj] = fmaf(ka[i], qq, s[i][jj]);
            dp[i][jj] = fmaf(va[i], gg, dp[i][jj]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < RK; ++i) {
        const int c = ty * RK + i;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int r = tx + 8 * jj;
          const float p = allowed(r0 + r + q_offset, c0 + c, sk, causal, window, sink)
                              ? expf(s[i][jj] * scale - Lr[r]) : 0.f;
          Pt[r * KS + c] = p;
          dSt[r * KS + c] = p * (dp[i][jj] - Dr[r]);
        }
      }
      __syncthreads();

#pragma unroll 2
      for (int r = 0; r < BQ; ++r) {
        float pa[RK], da[RK];
#pragma unroll
        for (int i = 0; i < RK; ++i) {
          pa[i] = Pt[r * KS + ty * RK + i];
          da[i] = dSt[r * KS + ty * RK + i];
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (32 * u + 4 * tx >= D) break;  // at D = 80, the last group's upper half
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = 32 * u + 4 * tx + e;
            const float gg = dOs[r * QR + col];
            const float qq = Qs[r * QR + col];
#pragma unroll
            for (int i = 0; i < RK; ++i) {
              av[i][4 * u + e] = fmaf(pa[i], gg, av[i][4 * u + e]);
              ak[i][4 * u + e] = fmaf(da[i], qq, ak[i][4 * u + e]);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RK; ++i) {
    const int key = c0 + ty * RK + i;
    if (key >= sk) continue;
    const long off = koff + (long)key * k_rs;
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 32 * u + 4 * tx + e;
        if (32 * u + 4 * tx < D) {
          store(&dk[off + col], ak[i][4 * u + e] * scale);
          store(&dv[off + col], av[i][4 * u + e]);
        }
      }
  }
}

template <typename Kern>
cudaError_t opt_in(Kern kern, int bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T, int D>
cudaError_t launch(const BwdArgs& a) {
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* g = static_cast<const T*>(a.dout);
  cudaError_t err;
  if ((err = opt_in(stats_kernel<T, D>, stats_smem<D>())) != cudaSuccess) return err;
  if ((err = opt_in(dq_kernel<T, D>, dq_smem<D>())) != cudaSuccess) return err;
  if ((err = opt_in(dkdv_kernel<T, D>, kv_smem<D>())) != cudaSuccess) return err;
  const int nqt = (a.sq + BQ - 1) / BQ;
  stats_kernel<T, D><<<dim3(nqt, a.hq, a.b), NT, stats_smem<D>(), a.stream>>>(
      q, k, static_cast<const T*>(a.o), g, a.lse, a.delta, a.sq, a.sk, a.hq, a.hkv, a.causal,
      a.window, a.sink, a.q_offset, a.scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dq_kernel<T, D><<<dim3(nqt, a.hq, a.b), NT, dq_smem<D>(), a.stream>>>(
      q, k, v, g, a.lse, a.delta, static_cast<T*>(a.dq), a.sq, a.sk, a.hq, a.hkv, a.causal,
      a.window, a.sink, a.q_offset, a.scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int nkt = (a.sk + kv_bk<D>() - 1) / kv_bk<D>();
  dkdv_kernel<T, D><<<dim3(nkt, a.hkv, a.b), NT, kv_smem<D>(), a.stream>>>(
      q, k, v, g, a.lse, a.delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.sq, a.sk,
      a.hq, a.hkv, a.causal, a.window, a.sink, a.q_offset, a.scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int d, const BwdArgs& a) {
  switch (d) {
    case 32: return launch<T, 32>(a);
    case 64: return launch<T, 64>(a);
    case 80: return launch<T, 80>(a);
    case 128: return launch<T, 128>(a);
    case 256: return launch<T, 256>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The f32 and bf16 instantiations are the two parts of the build
// (kernels/_build.py PARTS compiles this file once a part, with
// -DH2EAL_PART=0 or 1, at once); compiled without H2EAL_PART, the file
// holds both.
#ifndef H2EAL_PART
#define H2EAL_PART -1
#endif
#if H2EAL_PART < 0 || H2EAL_PART == 0
cudaError_t flash_bwd_f32(int d, const BwdArgs& a) { return dispatch_d<float>(d, a); }
#endif
#if H2EAL_PART < 0 || H2EAL_PART == 1
cudaError_t flash_bwd_bf16(int d, const BwdArgs& a) {
  return dispatch_d<__nv_bfloat16>(d, a);
}
#endif

}  // namespace h2eal

#if H2EAL_PART < 0 || H2EAL_PART == 0
// lse and delta: (B, Hq, Sq) f32 scratch the wrapper allocates; dtype: kF32 or kBF16
extern "C" int h2eal_flash_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* o, const void* dout, void* dq, void* dk,
                                         void* dv, void* lse, void* delta, int dtype, int b,
                                         int sq, int sk, int hq, int hkv, int d, int causal,
                                         int window, int sink, int q_offset, float scale,
                                         void* stream) {
  using namespace h2eal;
  const BwdArgs a{q, k, v, o, dout, dq, dk, dv, static_cast<float*>(lse),
                  static_cast<float*>(delta), b, sq, sk, hq, hkv, causal, window, sink,
                  q_offset, scale, static_cast<cudaStream_t>(stream)};
  return dtype == kBF16 ? flash_bwd_bf16(d, a) : flash_bwd_f32(d, a);
}
#endif
