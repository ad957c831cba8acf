// Backward of prefill GQA attention (causal, optional sliding window and
// attention sinks): dq, dk and dv from q, k, v, the forward's output o, its
// rows' log-sum-exp L and the output's gradient dO.
//
// Replaces no Pallas kernel: the JAX package trains with impl="ref" and lets
// autodiff differentiate the plain body repro/kernels/ref.py::
// flash_attention_ref, the function whose forward is the TPU kernel
// repro/kernels/flash_attention.py::flash_attention (pl.pallas_call at :97).
// Training on the card runs ops.flash_attention's forward kernels, so their
// backward is a kernel too. Same contract as the forward: q (B,Sq,Hq,D), k/v
// (B,Sk,Hkv,D), o/dO like q, f32 or bf16, dq/dk/dv in the inputs' dtype; key
// j is attended by query row i (absolute position i + q_offset) iff j <= row
// (causal), j > row - window (window>0), or j < sink (sink>0, only with a
// window); the scale is 1/sqrt(D) as the forward's. dk and dv of a kv head
// sum over its GQA group's query heads.
//
// With P = softmax(scale·q·kᵀ) over the allowed keys, dP = dO·vᵀ and
// Δ_i = Σ_d dO_i·o_i (= Σ_j P_ij·dP_ij):
//   dS = P∘(dP − Δ),  dq = scale·dS·k,  dk = scale·dSᵀ·q,  dv = Pᵀ·dO.
// P = 2^(s·scale·log2e − L·log2e) is recomputed in f32 from q, k and the L
// that the forward kernel saved (flash_attention.cu, flash_attention_sm90.cu:
// L = m + log l, natural log, −inf for a row with no allowed key, whose P is
// then 0), so this is the gradient of the unrounded function.
//
// Two launches a call, on one stream, no atomic adds into the sums, so every
// sum has one fixed order and the results are deterministic
// (resume-exactness needs it):
//   1. dq, per (q tile, q head, batch), over the key tiles its rows see
//      (causal and window tiles skipped as in the forward); its prologue
//      computes Δ of its rows from o and dO and writes it for launch 2;
//   2. dk and dv, per (key tile, kv head, batch), over the group's query
//      heads and the q tiles that see the tile, with the keys as the M rows
//      of Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ, so that dk and dv stay in registers;
//      under a window with sink keys, key tile 0 (seen by every q tile) is
//      cut into runs of several blocks whose partial sums the last one adds
//      in a fixed order (flash_bwd.cuh: sink_parts).
// Launch 1 recomputes S and dP, which launch 2 computes too: 2 of the 7
// products a pair are spent on not keeping dS, a (Sq x Sk) f32 array, in
// memory or accumulating dq across blocks with atomics.
//
// Routes, by dtype and head_dim (ops.flash_attention_bwd states the rule):
//   f32, D <= 128: this file, on the tensor cores as 3xTF32 (below);
//   bf16, D <= 128: flash_attention_bwd_sm90.cu, wgmma fed by TMA;
//   D = 256, both dtypes: this file's FMA kernels (a 64-key tile's dk and dv
//     accumulators, 2 x 64 x 256 f32, do not fit a warpgroup's registers;
//     no training path runs head_dim 256).
//
// What bounds it on the H100: the function is five D-long products a pair
// (S, dP, dq, dk, dv: 2.5 times the forward's), compute-bound at the
// training shapes. In f32 the FMA units give 67 TFLOP/s; TF32 tensor cores
// 495, and f32-accurate products from them as 3xTF32 (three TF32 products
// for one) at most 165.
//
// 3xTF32 (f32 route), the technique of CUTLASS's OpMultiplyAddFastF32, which
// PyTorch's memory-efficient attention selects for float operands (its
// installed headers mem_eff_attention/gemm/mma_from_smem.h and
// custom_mma_multistage.h): mma.sync.m16n8k8 tf32. (wgmma takes tf32
// operands only K-major from shared memory, and three of the five products
// need a transposed operand: dq = dS·K reads K, dk = dSᵀ·Q reads Q, dv =
// Pᵀ·dO reads dO along their rows; transposed hi and lo copies of the Q and
// dO tiles do not fit beside K and V at D = 128.) mma.sync takes its
// fragments from registers, which each thread loads from one f32 tile in
// shared memory, in either orientation, and splits there: x = hi + lo, hi =
// x rounded to tf32 (to nearest, ties away, as cvt.rna.tf32 rounds, on the
// int32 bits), lo = x − hi (exact in f32; the MMA reads its top 19 bits).
// Each product is lo·hi + hi·lo + hi·hi, issued in that order into the f32
// accumulators; lo·lo is dropped. (cvt.rna.tf32.f32 for both halves, a
// conversion instruction four times an operand, was measured slower:
// PERF.md §6.) Tiles of f32 rows (row stride D + 4 floats, so that both
// orientations' fragment loads are free of bank conflicts) arrive by
// cp.async into a double-buffered pair. P and dS are split in registers:
// the m16n8 accumulator fragment is a k8 A fragment once the k index t maps
// to column 2t and t + 4 to 2t + 1, and the B fragment's rows are read in
// the same order.
//   Error: hi keeps 11 significant bits, |x − hi| <= 2^-11·|x|, and the
//   MMA's 11 bits of lo leave |x − hi − lo| < 2^-21·|x|; with lo·lo (<=
//   2^-22·|ab|) dropped, a product is within about 2^-21 + 2^-21 + 2^-22 =
//   5·2^-22 ≈ 2^-19.7 of |ab| before the f32 sums, against 2^-24 for an
//   FMA. Summed over D (or keys, or rows) that is far inside the check's
//   1e-4·max|plain| + 1e-5 (tests/test_torch_bwd_design.py emulates it on
//   the int32 bits, scores of magnitude ~30 included).
//   Sums across tiles: the tensor cores' adds into an accumulator truncate
//   rather than round, so a chain of thousands of MMAs into one register
//   drifts one way (llama3-8b's dk and dv, 8192 rows x 4 heads, 12288 MMAs a
//   chain: 5.4e-4 past the check on the card). So a chain stops at 192 MMAs
//   (drift <= 192·2^-24 ≈ 1.1e-5 of the partial sum): every FLUSH tiles a
//   warp adds its accumulators into its own rows of the f32 output in device
//   memory by rounding f32 adds (no other block writes those rows, so the
//   order is fixed) and restarts them from zero. Summing each tile from zero
//   in registers instead would need a second set of accumulators, or a
//   chain of 12 dependent MMAs an output fragment: measured 4% slower at
//   smollm-360m's shape (PERF.md §6).
//   Tiles: launch 1 a q tile of 128 rows (8 warps of 16 rows), key tiles of
//   64 (32 at D = 128); launch 2 a key tile of 128 keys (8 warps of 16 keys),
//   q tiles of 64 rows (32 at D = 128), so that a thread's accumulators
//   (launch 2: dk and dv, 2 x D/2 f32; Sᵀ and dPᵀ, 2 x rows/2) stay in its
//   registers. Shared memory at D = 128: 199 KB in launch 1 and in launch 2.
//
// FMA kernels (D = 256): 128 threads, 16 row groups x 8 column lanes, a
// thread's 4 rows x D/8 columns; 64-row q tiles and 32-key tiles; Qᵀ/dOᵀ
// and Kᵀ/Vᵀ transposed in shared memory (214 KB in launch 1, 224 KB in
// launch 2, one block an SM). bf16 operands are widened to f32 as loaded.
//
// Tolerance against ref.flash_attention_bwd_ref run on the same inputs
// widened to f32 (which recomputes its own softmax from q and k, never L):
// in f32 the two differ by summation order and the 3xTF32 term above
// (1e-4·max|plain| + 1e-5, a tensor's largest value scaling the order term:
// dq and dk are sums of signed terms that cancel); in bf16 each output is
// also rounded once to bf16, at most half a bf16 step, 2^-9 of its value,
// so bf16 is held to 2^-8·|plain| + 1e-4·max|plain| + 1e-5. The bf16 route's
// own terms are derived in flash_attention_bwd_sm90.cu.
#include <math.h>

#include <cstdint>

#include "common.cuh"
#include "flash_bwd.cuh"

namespace h2eal {
namespace bwd {

// flash_attention_bwd_sm90.cu
cudaError_t flash_bwd_bf16_sm90(int d, const BwdArgs& a);
long flash_bwd_bf16_sm90_parts(int d, int b, int sq, int hkv, int window, int sink);

namespace {

// ---------------------------------------------------------------------------
// 3xTF32 on mma.sync, and cp.async
// ---------------------------------------------------------------------------

// x = hi + lo + r: hi is x rounded to tf32, to nearest with ties away from
// zero (half a tf32 ulp added to the bits, the 13 dropped bits cleared: what
// cvt.rna.tf32.f32 gives, in two integer operations instead of a
// conversion); lo = x − hi, exact in f32, is passed whole and the MMA reads
// its top 19 bits (a truncation: |r| < 2^-10·|x − hi| <= 2^-21·|x|)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}
// d += a·b, m16n8k8, tf32 operands, f32 accumulators
__device__ __forceinline__ void mma8(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                     uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// A fragment of a 16 x 8 tile, split: a[0] (g, t), a[1] (g+8, t),
// a[2] (g, t+4), a[3] (g+8, t+4)
struct Frag {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ void set(float x0, float x1, float x2, float x3) {
    split(x0, hi[0], lo[0]);
    split(x1, hi[1], lo[1]);
    split(x2, hi[2], lo[2]);
    split(x3, hi[3], lo[3]);
  }
};
// d += a·b as 3xTF32: lo·hi + hi·lo + hi·hi, in that order; b = (b0, b1)
__device__ __forceinline__ void mma3(float (&d)[4], const Frag& a, float b0, float b1) {
  uint32_t h0, l0, h1, l1;
  split(b0, h0, l0);
  split(b1, h1, l1);
  mma8(d, a.lo, h0, h1);
  mma8(d, a.hi, l0, l1);
  mma8(d, a.hi, h0, h1);
}

__device__ __forceinline__ void cp16(float* dst, const float* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// `rows` rows of D f32 (row r at src + r·rs) into dst, row stride D + 4; rows
// at or past n are zero-filled
template <int D, int ROWS, int NT>
__device__ __forceinline__ void load_rows(float* dst, const float* src, long rs, int n,
                                          int tid) {
  constexpr int C4 = D / 4;
#pragma unroll 4
  for (int i = tid; i < ROWS * C4; i += NT) {
    const int r = i / C4, c = (i % C4) * 4;
    const bool in = r < n;
    cp16(dst + r * (D + 4) + c, src + (in ? r * rs : 0) + c, in);
  }
}

// ---------------------------------------------------------------------------
// f32, launch 1: dq (and Δ)
// ---------------------------------------------------------------------------

template <int D>
struct DqF32 {
  static constexpr int NT = 256;  // 8 warps of 16 rows
  static constexpr int BQ = 128;
  static constexpr int BK = D >= 128 ? 32 : 64;
  static constexpr int DP = D + 4;
  static constexpr int FLUSH = 192 / (3 * BK / 8);  // key tiles a chain of 192 MMAs
  static constexpr int bytes = (2 * BQ * DP + 2 * 2 * BK * DP + 2 * BQ) * 4;
  static_assert(bytes <= 232448, "launch 1's tiles exceed a block's shared memory");
};

template <int D>
__global__ void __launch_bounds__(256, 1) dq_tf32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ o, const float* __restrict__ dout, const float* __restrict__ lse,
    float* __restrict__ delta, float* __restrict__ dq, int sq, int sk, int hq, int hkv,
    int causal, int window, int sink, int q_offset, float scale) {
  using C = DqF32<D>;
  constexpr int BQ = C::BQ, BK = C::BK, DP = C::DP, NT = C::NT;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [BQ][DP]
  float* dOs = Qs + BQ * DP;                    // [BQ][DP]
  float* KV = dOs + BQ * DP;                    // [2][K, V][BK][DP]
  float* Lr = KV + 4 * BK * DP;                 // [BQ]: L·log2e
  float* Dr = Lr + BQ;                          // [BQ]: Δ

  const int qt = gridDim.x - 1 - blockIdx.x;  // the heaviest tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = qt * BQ;
  const long q_rs = (long)hq * D;
  const long k_rs = (long)hkv * D;
  const long qoff = ((long)b * sq * hq + h) * D + r0 * q_rs;
  const float* kb = k + ((long)b * sk * hkv + hk) * D;
  const float* vb = v + ((long)b * sk * hkv + hk) * D;
  const long soff = ((long)b * hq + h) * sq;
  const int n_rows = min(BQ, sq - r0);

  load_rows<D, BQ, NT>(Qs, q + qoff, q_rs, n_rows, tid);
  load_rows<D, BQ, NT>(dOs, dout + qoff, q_rs, n_rows, tid);
  const int i_min = r0 + q_offset;
  const int i_max = r0 + n_rows - 1 + q_offset;
  const Span span(key_tiles_end(sk, BK, i_max, causal), BK, i_min, window, sink);
  auto load_kv = [&](int kt, int buf) {
    const int c0 = kt * BK;
    float* Ks = KV + buf * 2 * BK * DP;
    load_rows<D, BK, NT>(Ks, kb + c0 * k_rs, k_rs, sk - c0, tid);
    load_rows<D, BK, NT>(Ks + BK * DP, vb + c0 * k_rs, k_rs, sk - c0, tid);
  };
  int kt = span.next(0);
  if (kt < span.end) load_kv(kt, 0);
  cp_commit();

  {  // Δ and L of the rows, two threads a row; Δ is written for launch 2
    const int r = tid >> 1, s = r0 + r;
    float acc = 0.f;
    if (s < sq) {
      const float* op = o + qoff + r * q_rs;
      const float* gp = dout + qoff + r * q_rs;
#pragma unroll 4
      for (int d = (tid & 1) * 4; d < D; d += 8) {
        const float4 a = *reinterpret_cast<const float4*>(op + d);
        const float4 c = *reinterpret_cast<const float4*>(gp + d);
        acc = fmaf(a.x, c.x, fmaf(a.y, c.y, fmaf(a.z, c.z, fmaf(a.w, c.w, acc))));
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if ((tid & 1) == 0) {
      Dr[r] = acc;
      Lr[r] = s < sq ? lse_log2(lse[soff + s]) : INFINITY;
      if (s < sq) delta[soff + s] = acc;
    }
  }
  __syncthreads();
  const int wr = warp * 16;  // the warp's first row in the tile
  const float lr[2] = {Lr[wr + g], Lr[wr + g + 8]};
  const float dr[2] = {Dr[wr + g], Dr[wr + g + 8]};
  const int w_min = r0 + wr + q_offset, w_max = w_min + 15;  // the warp's rows
  const float scale_log2 = scale * kLog2e;

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  // dq += scale·acc in device memory (the first time dq = scale·acc), acc
  // restarted from zero: every FLUSH key tiles and at the end
  auto flush = [&](bool first) {
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      const int r = wr + g + 8 * e2;
      float* out = dq + qoff + r * q_rs + 2 * t;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        if (r0 + r < sq) {
          float2 x = first ? make_float2(0.f, 0.f) : *reinterpret_cast<float2*>(out + 8 * n);
          x.x = fmaf(acc[n][2 * e2], scale, x.x);
          x.y = fmaf(acc[n][2 * e2 + 1], scale, x.y);
          *reinterpret_cast<float2*>(out + 8 * n) = x;
        }
        acc[n][2 * e2] = acc[n][2 * e2 + 1] = 0.f;
      }
    }
  };
  int done = 0;  // key tiles summed

  for (int buf = 0; kt < span.end; buf ^= 1) {
    const int nkt = span.next(kt + 1);
    cp_wait_all();
    __syncthreads();  // the tile has landed; every warp is done with the other buffer
    if (nkt < span.end) load_kv(nkt, buf ^ 1);
    cp_commit();
    const float* Ks = KV + buf * 2 * BK * DP;
    const float* Vs = Ks + BK * DP;
    const int c0 = kt * BK;

    // S = Q·Kᵀ and dP = dO·Vᵀ: the warp's 16 rows x BK keys
    float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < D / 8; ++kk) {
      const float* qa = Qs + (wr + g) * DP + 8 * kk + t;
      const float* ga = dOs + (wr + g) * DP + 8 * kk + t;
      Frag fq, fg;
      fq.set(qa[0], qa[8 * DP], qa[4], qa[8 * DP + 4]);
      fg.set(ga[0], ga[8 * DP], ga[4], ga[8 * DP + 4]);
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
        const float* kp = Ks + (8 * n + g) * DP + 8 * kk + t;
        const float* vp = Vs + (8 * n + g) * DP + 8 * kk + t;
        mma3(s[n], fq, kp[0], kp[4]);
        mma3(dp[n], fg, vp[0], vp[4]);
      }
    }

    // dS = P∘(dP − Δ), over S; element e: row g + 8(e/2), key 8n + 2t + e%2
    const bool need_mask = c0 + BK > sk || (causal && c0 + BK - 1 > w_min) ||
                           (window > 0 && c0 <= w_max - window);
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = ex2(fmaf(s[n][e], scale_log2, -lr[e >> 1]));
        if (need_mask && !allowed(w_min + g + 8 * (e >> 1), c0 + 8 * n + 2 * t + (e & 1), sk,
                                  causal, window, sink))
          p = 0.f;
        s[n][e] = p * (dp[n][e] - dr[e >> 1]);
      }

    // dq += dS·K over the tile's keys, 8 a step: the step's k index t is key
    // 2t and t + 4 is key 2t + 1, so the accumulator fragment is the A fragment
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      Frag fa;
      fa.set(s[j][0], s[j][2], s[j][1], s[j][3]);
      const float* kp = Ks + (8 * j + 2 * t) * DP + g;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) mma3(acc[n], fa, kp[8 * n], kp[DP + 8 * n]);
    }
    if (++done % C::FLUSH == 0) flush(done == C::FLUSH);
    kt = nkt;
  }
  cp_wait_all();
  if (done == 0 || done % C::FLUSH != 0) flush(done < C::FLUSH);
}

// ---------------------------------------------------------------------------
// f32, launch 2: dk and dv
// ---------------------------------------------------------------------------

template <int D>
struct KvF32 {
  static constexpr int NT = 256;  // 8 warps of 16 keys
  static constexpr int BKV = 128;
  static constexpr int BR = D >= 128 ? 32 : 64;
  static constexpr int DP = D + 4;
  static constexpr int FLUSH = 192 / (3 * BR / 8);  // q tiles a chain of 192 MMAs
  static constexpr int bytes = (2 * BKV * DP + 2 * 2 * BR * DP + 2 * 2 * BR) * 4;
  static_assert(bytes <= 232448, "launch 2's tiles exceed a block's shared memory");
};

template <int D>
__global__ void __launch_bounds__(256, 1) dkdv_tf32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv,
    float* __restrict__ parts_buf, int* __restrict__ arrivals, int parts, int sq, int sk,
    int hq, int hkv, int causal, int window, int sink, int q_offset, float scale) {
  using C = KvF32<D>;
  constexpr int BKV = C::BKV, BR = C::BR, DP = C::DP, NT = C::NT;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);  // [BKV][DP]
  float* Vs = Ks + BKV * DP;                    // [BKV][DP]
  float* QG = Vs + BKV * DP;                    // [2][Q, dO][BR][DP]
  float* LD = QG + 4 * BR * DP;                 // [2][L·log2e, Δ][BR]
  __shared__ int last_part;

  // blocks [0, parts) take the runs of key tile 0 (one block, parts = 1,
  // without a cut); under causal, the first key tiles are the heaviest
  const bool cut = blockIdx.x < parts && parts > 1;
  const int kt = cut ? 0 : blockIdx.x - (parts - 1);
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int group = hq / hkv;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int c0 = kt * BKV;
  const int wk = warp * 16;  // the warp's first key in the tile
  const long q_rs = (long)hq * D;
  const long k_rs = (long)hkv * D;
  const long koff = ((long)b * sk * hkv + hk) * D + c0 * k_rs;

  load_rows<D, BKV, NT>(Ks, k + koff, k_rs, sk - c0, tid);
  load_rows<D, BKV, NT>(Vs, v + koff, k_rs, sk - c0, tid);
  const QSpan qs(c0, min(c0 + BKV, sk) - 1, sq, BR, causal, window, sink, q_offset);
  const int n_q = qs.count();
  const int total = group * n_q;  // (head, q tile) items, head-major
  const int i0 = cut ? blockIdx.x * total / parts : 0;
  const int i1 = cut ? (blockIdx.x + 1) * total / parts : total;
  auto load_q = [&](int i, int buf) {
    const int h = hk * group + i / n_q, r0 = (qs.lo + i % n_q) * BR;
    const long qoff = ((long)b * sq * hq + h) * D + r0 * q_rs;
    float* Qs = QG + buf * 2 * BR * DP;
    load_rows<D, BR, NT>(Qs, q + qoff, q_rs, sq - r0, tid);
    load_rows<D, BR, NT>(Qs + BR * DP, dout + qoff, q_rs, sq - r0, tid);
    const long soff = ((long)b * hq + h) * sq + r0;
    float* L = LD + buf * 2 * BR;
    for (int r = tid; r < BR; r += NT) {
      const bool in = r0 + r < sq;
      L[r] = in ? lse_log2(lse[soff + r]) : INFINITY;
      L[BR + r] = in ? delta[soff + r] : 0.f;
    }
  };
  if (i0 < i1) load_q(i0, 0);
  cp_commit();

  const int k_min = c0 + wk, k_max = k_min + 15;  // the warp's keys
  const float scale_log2 = scale * kLog2e;
  float ak[D / 8][4], av[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) ak[n][e] = av[n][e] = 0.f;
  // dk += scale·ak and dv += av in device memory (the first time, =), the
  // accumulators restarted from zero: every FLUSH q tiles and at the end;
  // a run of a cut tile 0 sums into its part of parts_buf
  auto flush = [&](bool first) {  // its addresses from the arguments: no live registers
    float* fk = cut ? parts_buf + (((long)blockIdx.x * gridDim.z + b) * hkv + hk) * 2 * BKV * D
                    : dk + koff;
    float* fv = cut ? fk + BKV * D : dv + koff;
    const long f_rs = cut ? D : k_rs;
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      const int key = wk + g + 8 * e2;
      const long off = key * f_rs + 2 * t;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        // at most 4 columns' loads in flight: hoisting all of them would
        // spill the accumulators
        if (n % 4 == 0) asm volatile("" ::: "memory");
        if (c0 + key < sk) {
          float2 xk = make_float2(0.f, 0.f), xv = xk;
          if (!first) {
            xk = *reinterpret_cast<float2*>(fk + off + 8 * n);
            xv = *reinterpret_cast<float2*>(fv + off + 8 * n);
          }
          xk.x = fmaf(ak[n][2 * e2], scale, xk.x);
          xk.y = fmaf(ak[n][2 * e2 + 1], scale, xk.y);
          xv.x += av[n][2 * e2];
          xv.y += av[n][2 * e2 + 1];
          *reinterpret_cast<float2*>(fk + off + 8 * n) = xk;
          *reinterpret_cast<float2*>(fv + off + 8 * n) = xv;
        }
        ak[n][2 * e2] = ak[n][2 * e2 + 1] = av[n][2 * e2] = av[n][2 * e2 + 1] = 0.f;
      }
    }
  };

  for (int i = i0; i < i1; ++i) {
    const int buf = (i - i0) & 1;
    cp_wait_all();
    __syncthreads();  // the tile has landed; every warp is done with the other buffer
    if (i + 1 < i1) load_q(i + 1, buf ^ 1);
    cp_commit();
    const float* Qs = QG + buf * 2 * BR * DP;
    const float* dOs = Qs + BR * DP;
    const float* Lr = LD + buf * 2 * BR;
    const float* Dr = Lr + BR;
    const int a0 = (qs.lo + i % n_q) * BR + q_offset;  // absolute position of row 0

    // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ: the warp's 16 keys x BR rows
    float st[BR / 8][4], dpt[BR / 8][4];
#pragma unroll
    for (int n = 0; n < BR / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const float* ka = Ks + (wk + g) * DP + 8 * kk + t;
      const float* va = Vs + (wk + g) * DP + 8 * kk + t;
      Frag fk, fv;
      fk.set(ka[0], ka[8 * DP], ka[4], ka[8 * DP + 4]);
      fv.set(va[0], va[8 * DP], va[4], va[8 * DP + 4]);
#pragma unroll
      for (int n = 0; n < BR / 8; ++n) {
        const float* qp = Qs + (8 * n + g) * DP + 8 * kk + t;
        const float* gp = dOs + (8 * n + g) * DP + 8 * kk + t;
        mma3(st[n], fk, qp[0], qp[4]);
        mma3(dpt[n], fv, gp[0], gp[4]);
      }
    }

    // Pᵀ over Sᵀ and dSᵀ over dPᵀ; element e: key g + 8(e/2), row 8n + 2t + e%2.
    // Keys past Sk are not masked: their rows of dk and dv are not stored.
    const bool need_mask =
        (causal && k_max > a0) || (window > 0 && k_min <= a0 + BR - 1 - window);
#pragma unroll
    for (int n = 0; n < BR / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 8 * n + 2 * t + (e & 1);
        float p = ex2(fmaf(st[n][e], scale_log2, -Lr[r]));
        if (need_mask && !allowed(a0 + r, k_min + g + 8 * (e >> 1), sk, causal, window, sink))
          p = 0.f;
        st[n][e] = p;
        dpt[n][e] = p * (dpt[n][e] - Dr[r]);
      }

    // dv += Pᵀ·dO and dk += dSᵀ·Q over the tile's rows, 8 a step (k index t:
    // row 2t, t + 4: row 2t + 1)
#pragma unroll
    for (int j = 0; j < BR / 8; ++j) {
      Frag fp, fs;
      fp.set(st[j][0], st[j][2], st[j][1], st[j][3]);
      fs.set(dpt[j][0], dpt[j][2], dpt[j][1], dpt[j][3]);
      const float* gp = dOs + (8 * j + 2 * t) * DP + g;
      const float* qp = Qs + (8 * j + 2 * t) * DP + g;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        mma3(av[n], fp, gp[8 * n], gp[DP + 8 * n]);
        mma3(ak[n], fs, qp[8 * n], qp[DP + 8 * n]);
      }
    }
    if ((i - i0 + 1) % C::FLUSH == 0) flush(i - i0 + 1 == C::FLUSH);
  }
  cp_wait_all();
  if (i1 == i0 || (i1 - i0) % C::FLUSH != 0) flush(i1 - i0 < C::FLUSH);
  if (cut) {  // the last run of tile 0 to finish sums the parts
    __threadfence();
    __syncthreads();
    if (tid == 0) last_part = atomicAdd(&arrivals[b * hkv + hk], 1) == parts - 1;
    __syncthreads();
    if (last_part) {
      __threadfence();
      merge_parts<float, D, BKV>(parts_buf, parts, gridDim.z, hkv, b, hk, sk, dk, dv, koff, k_rs,
                                 tid, NT);
      if (tid == 0) arrivals[b * hkv + hk] = 0;
    }
  }
}

// ---------------------------------------------------------------------------
// D = 256, both dtypes: the FMA kernels
// ---------------------------------------------------------------------------

constexpr int FD = 256;
constexpr int NT = 128;     // 16 row groups x 8 column lanes
constexpr int BQ = 64;      // query rows a tile
constexpr int QS = BQ + 4;  // transposed q-tile row stride (float4-aligned)
constexpr int FBK = 32;     // keys a tile
constexpr int U = FD / 32;  // 32-column groups of the output
constexpr int DC = 4 * U;   // output columns a thread

constexpr int dq_fma_smem() { return (2 * FD * QS + 2 * FBK * (FD + 1) + FBK * QS + 2 * BQ) * 4; }
constexpr int kv_fma_smem() {
  return (2 * FD * (FBK + 4) + 2 * BQ * (FD + 1) + 2 * BQ * (FBK + 4) + 2 * BQ) * 4;
}
static_assert(dq_fma_smem() <= 232448 && kv_fma_smem() <= 232448, "FMA tiles");

template <typename T>
__global__ void __launch_bounds__(NT) dq_fma_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ o, const T* __restrict__ dout, const float* __restrict__ lse,
    float* __restrict__ delta, T* __restrict__ dq, int sq, int sk, int hq, int hkv,
    int causal, int window, int sink, int q_offset, float scale) {
  constexpr int D = FD, BK = FBK, JJ = BK / 8, KR = D + 1;
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);  // [D][QS]
  float* dOt = Qt + D * QS;                     // [D][QS]
  float* Ks = dOt + D * QS;                     // [BK][KR]
  float* Vs = Ks + BK * KR;                     // [BK][KR]
  float* dSt = Vs + BK * KR;                    // [BK][QS]
  float* Lr = dSt + BK * QS;                    // [BQ]: L·log2e
  float* Dr = Lr + BQ;                          // [BQ]: Δ

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
  const float scale_log2 = scale * kLog2e;

  for (int idx = tid; idx < BQ * D; idx += NT) {
    const int r = idx / D, d = idx % D;
    const bool in = r0 + r < sq;
    const long off = qoff + (long)(r0 + r) * q_rs + d;
    Qt[d * QS + r] = in ? to_f32(q[off]) : 0.f;
    dOt[d * QS + r] = in ? to_f32(dout[off]) : 0.f;
  }
  {  // Δ and L: two threads a row, half of D each; Δ is written for launch 2
    const int r = tid >> 1, s = r0 + r;
    float acc = 0.f;
    if (s < sq) {
      const long off = qoff + (long)s * q_rs;
      for (int d = (tid & 1); d < D; d += 2) acc += to_f32(dout[off + d]) * to_f32(o[off + d]);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if ((tid & 1) == 0) {
      Dr[r] = acc;
      Lr[r] = s < sq ? lse_log2(lse[soff + s]) : INFINITY;
      if (s < sq) delta[soff + s] = acc;
    }
  }

  float acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;

  const int i_min = r0 + q_offset;
  const int i_max = r0 + BQ - 1 + q_offset;
  const Span span(key_tiles_end(sk, BK, i_max, causal), BK, i_min, window, sink);
  for (int kt = span.next(0); kt < span.end; kt = span.next(kt + 1)) {
    const int c0 = kt * BK;
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
                            ? ex2(fmaf(s[i][jj], scale_log2, -Lr[r])) : 0.f;
        dSt[c * QS + r] = p * (dp[i][jj] - Dr[r]);
      }
    }
    __syncthreads();

#pragma unroll 2
    for (int j = 0; j < BK; ++j) {
      const float4 dv4 = *reinterpret_cast<const float4*>(&dSt[j * QS + ty * 4]);
      const float da[4] = {dv4.x, dv4.y, dv4.z, dv4.w};
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float kk = Ks[j * KR + 32 * u + 4 * tx + e];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][4 * u + e] = fmaf(da[i], kk, acc[i][4 * u + e]);
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
      for (int e = 0; e < 4; ++e) store(&out[32 * u + 4 * tx + e], acc[i][4 * u + e] * scale);
  }
}

template <typename T>
__global__ void __launch_bounds__(NT) dkdv_fma_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int sq, int sk,
    int hq, int hkv, int causal, int window, int sink, int q_offset, float scale) {
  constexpr int D = FD, BK = FBK, RK = BK / 16, KS = BK + 4, QR = D + 1;
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
  const float scale_log2 = scale * kLog2e;

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

  const QSpan qs(c0, min(c0 + BK, sk) - 1, sq, BQ, causal, window, sink, q_offset);
  for (int hh = 0; hh < group; ++hh) {
    const int h = hk * group + hh;
    const long qoff = ((long)b * sq * hq + h) * D;
    const long soff = ((long)b * hq + h) * sq;
    for (int qt = qs.lo; qt <= qs.hi; ++qt) {
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
        Lr[r] = in ? lse_log2(lse[soff + r0 + r]) : INFINITY;
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
                              ? ex2(fmaf(s[i][jj], scale_log2, -Lr[r])) : 0.f;
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
        for (int u = 0; u < U; ++u)
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
        store(&dk[off + col], ak[i][4 * u + e] * scale);
        store(&dv[off + col], av[i][4 * u + e]);
      }
  }
}

template <typename Kern>
cudaError_t opt_in(Kern kern, int bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int D>
cudaError_t launch_tf32(const BwdArgs& a) {
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  const float* g = static_cast<const float*>(a.dout);
  cudaError_t err;
  if ((err = opt_in(dq_tf32_kernel<D>, DqF32<D>::bytes)) != cudaSuccess) return err;
  if ((err = opt_in(dkdv_tf32_kernel<D>, KvF32<D>::bytes)) != cudaSuccess) return err;
  const int nqt = (a.sq + DqF32<D>::BQ - 1) / DqF32<D>::BQ;
  dq_tf32_kernel<D><<<dim3(nqt, a.hq, a.b), DqF32<D>::NT, DqF32<D>::bytes, a.stream>>>(
      q, k, v, static_cast<const float*>(a.o), g, a.lse, a.delta, static_cast<float*>(a.dq),
      a.sq, a.sk, a.hq, a.hkv, a.causal, a.window, a.sink, a.q_offset, a.scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  using K = KvF32<D>;
  const int nkt = (a.sk + K::BKV - 1) / K::BKV;
  const int parts = sink_parts(a.sq, a.window, a.sink, K::BR, K::BKV);
  dkdv_tf32_kernel<D><<<dim3(nkt + parts - 1, a.hkv, a.b), K::NT, K::bytes, a.stream>>>(
      q, k, v, g, a.lse, a.delta, static_cast<float*>(a.dk), static_cast<float*>(a.dv),
      a.parts_buf, a.arrivals, parts, a.sq, a.sk, a.hq, a.hkv, a.causal, a.window, a.sink,
      a.q_offset, a.scale);
  return cudaGetLastError();
}

template <int D>
long tf32_parts_floats(int b, int sq, int hkv, int window, int sink) {
  using K = KvF32<D>;
  return parts_floats(sink_parts(sq, window, sink, K::BR, K::BKV), b, hkv, K::BKV, D);
}

template <typename T>
cudaError_t launch_fma(const BwdArgs& a) {
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* g = static_cast<const T*>(a.dout);
  cudaError_t err;
  if ((err = opt_in(dq_fma_kernel<T>, dq_fma_smem())) != cudaSuccess) return err;
  if ((err = opt_in(dkdv_fma_kernel<T>, kv_fma_smem())) != cudaSuccess) return err;
  const int nqt = (a.sq + BQ - 1) / BQ;
  dq_fma_kernel<T><<<dim3(nqt, a.hq, a.b), NT, dq_fma_smem(), a.stream>>>(
      q, k, v, static_cast<const T*>(a.o), g, a.lse, a.delta, static_cast<T*>(a.dq), a.sq,
      a.sk, a.hq, a.hkv, a.causal, a.window, a.sink, a.q_offset, a.scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int nkt = (a.sk + FBK - 1) / FBK;
  dkdv_fma_kernel<T><<<dim3(nkt, a.hkv, a.b), NT, kv_fma_smem(), a.stream>>>(
      q, k, v, g, a.lse, a.delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.sq, a.sk,
      a.hq, a.hkv, a.causal, a.window, a.sink, a.q_offset, a.scale);
  return cudaGetLastError();
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
long flash_bwd_f32_parts(int d, int b, int sq, int hkv, int window, int sink) {
  switch (d) {
    case 32: return tf32_parts_floats<32>(b, sq, hkv, window, sink);
    case 64: return tf32_parts_floats<64>(b, sq, hkv, window, sink);
    case 80: return tf32_parts_floats<80>(b, sq, hkv, window, sink);
    case 128: return tf32_parts_floats<128>(b, sq, hkv, window, sink);
    default: return 0;  // the FMA kernels (D = 256) cut nothing
  }
}

cudaError_t flash_bwd_f32(int d, const BwdArgs& a) {
  switch (d) {
    case 32: return launch_tf32<32>(a);
    case 64: return launch_tf32<64>(a);
    case 80: return launch_tf32<80>(a);
    case 128: return launch_tf32<128>(a);
    case 256: return launch_fma<float>(a);
    default: return cudaErrorInvalidValue;
  }
}
#endif
#if H2EAL_PART < 0 || H2EAL_PART == 1
cudaError_t flash_bwd_bf16_fma(const BwdArgs& a) { return launch_fma<__nv_bfloat16>(a); }
#else
cudaError_t flash_bwd_bf16_fma(const BwdArgs& a);
#endif

}  // namespace bwd
}  // namespace h2eal

#if H2EAL_PART < 0 || H2EAL_PART == 0
// f32 floats of scratch for launch 2's cut of key tile 0 (flash_bwd.cuh:
// sink_parts), 0 where it is not cut; dtype: kF32 or kBF16
extern "C" long long h2eal_flash_attention_bwd_parts(int dtype, int d, int b, int sq, int hkv,
                                                     int window, int sink) {
  using namespace h2eal;
  using namespace h2eal::bwd;
  return dtype == kBF16 ? flash_bwd_bf16_sm90_parts(d, b, sq, hkv, window, sink)
                        : flash_bwd_f32_parts(d, b, sq, hkv, window, sink);
}

// lse: the forward's (B, Hq, Sq) f32 row log-sum-exp; delta: (B, Hq, Sq) f32
// scratch; parts_buf: h2eal_flash_attention_bwd_parts' floats (null for 0);
// arrivals: (B, Hkv) int32, zero and left zero; the wrapper allocates them
extern "C" int h2eal_flash_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* o, const void* dout, const void* lse,
                                         void* dq, void* dk, void* dv, void* delta,
                                         void* parts_buf, void* arrivals, int dtype, int b,
                                         int sq, int sk, int hq, int hkv, int d, int causal,
                                         int window, int sink, int q_offset, float scale,
                                         void* stream) {
  using namespace h2eal;
  using namespace h2eal::bwd;
  const BwdArgs a{q, k, v, o, dout, static_cast<const float*>(lse), dq, dk, dv,
                  static_cast<float*>(delta), static_cast<float*>(parts_buf),
                  static_cast<int*>(arrivals), b, sq, sk, hq, hkv, causal, window, sink,
                  q_offset, scale, static_cast<cudaStream_t>(stream)};
  if (dtype != kBF16) return flash_bwd_f32(d, a);
  return d == 256 ? flash_bwd_bf16_fma(a) : flash_bwd_bf16_sm90(d, a);
}
#endif
