// Backward of prefill GQA attention in bf16 on Hopper's tensor cores, head_dim
// 32, 64, 80 and 128: the bf16 route of flash_attention_bwd.cu, whose note
// gives the contract, the formulas and the two launches (dq with Δ, then dk
// and dv); head_dim 256 keeps that file's FMA kernels.
//
// Replaces no Pallas kernel (flash_attention_bwd.cu says why it exists).
//
// Design (the shape of the forward, flash_attention_sm90.cu): blocks of three
// warpgroups; warpgroup 0 is the producer, which gives up registers
// (setmaxnreg) and whose one thread loads tiles by TMA into a ring of stages
// with full and empty mbarriers; warpgroups 1 and 2 are consumers with f32
// accumulators, issuing wgmma on the tiles that have arrived.
//   Launch 1 (dq), a block a (128-row q tile, q head, batch), the heaviest
//   causal tiles first: the Q and dO tiles once, then K and V tiles of 64
//   keys into the ring (as many stages as shared memory holds: 5 at D = 128).
//   Each consumer owns 64 rows: S = Q·Kᵀ and dP = dO·Vᵀ, wgmma m64n64k16 with
//   both operands K-major in shared memory; P and dS = P∘(dP − Δ) on the
//   accumulator fragment in f32; dq += dS·K with dS as the register A
//   operand (the m64nN accumulator layout is the k16 A fragment layout) and
//   K read through the transpose bit. Δ of the consumer's rows comes first,
//   from o and dO in device memory, four threads a row, and is written for
//   launch 2.
//   Launch 2 (dk, dv), a block a (128-key tile, kv head, batch), the first
//   (heaviest under causal) tiles first: the K and V tiles once, then the Q
//   and dO tiles of 32 rows of each head of the group and each q tile that
//   sees the keys, in turn, into the ring (8 stages). Each consumer owns 64
//   keys as the M rows: Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ (m64n32k16, K-major), Pᵀ and
//   dSᵀ in f32, then dv += Pᵀ·dO and dk += dSᵀ·Q with Pᵀ and dSᵀ as register A
//   operands and dO and Q read through the transpose bit. A consumer holds
//   dk and dv, 2 x D/2 f32 a thread (128 at D = 128) beside Sᵀ, dPᵀ and the
//   packed operands: q tiles of 32 rows keep that inside the 232 registers
//   that setmaxnreg gives it. A stage goes back to the producer once both
//   products that read it have completed.
//   Within a consumer a tile's products and its softmax do not overlap (the
//   two consumers' interleave): issuing the next tile's S and dP before this
//   tile's last products, as the forward does, was measured slower (ptxas
//   serialises the wgmma there, PERF.md §6).
// Masks run only on tiles that cross the causal diagonal, the window edge or
// the ragged end of the keys (TMA zero-fills rows past S: a zero key scores
// 0, not −inf, so the column mask excludes it; a row past Sq has L = +inf
// and so P = 0). No atomic adds: each output element is one block's sum in
// a fixed order (tile 0's cut runs are added in part order by the last one
// to arrive; only the arrivals are counted atomically).
//
// Numerics and tolerance. Q, K, V and dO are bf16, so S and dP are exact
// products summed in f32. P and dS are f32; an MMA takes them as bf16
// operands. Rounding each once (2^-9 relative) moves dv_j by up to
// 2^-9·Σ_i P_ij·|dO_i| and dq_i by up to 2^-9·scale·Σ_j |dS_ij|·|k_j|
// (dk alike): sums of terms that cancel in dv, dq and dk themselves, so
// the move is not bounded by 2^-8·|plain| + 1e-4·max|plain| + 1e-5, the
// check's tolerance. The CPU emulation of the single rounding
// (tests/test_torch_bwd_design.py, split=False) exceeds that bound by up to
// 1.5e-2 (PERF.md §6), so the check stays as it is and the design
// changes: P and dS are each split into two bf16 operands, x = hi + lo with
// hi = bf16(x), lo = bf16(x − hi), |x − hi − lo| <= 2^-18·|x|, and each of
// the three products that reads them is two wgmma (lo first, then hi) into
// the same f32 accumulators: 8 products a pair instead of 5. The moves
// above shrink by 2^-9, far inside 1e-4·max|plain| (the emulation holds it,
// scores of magnitude ~30 included); the outputs' own rounding to bf16
// stays 2^-9 of the value. exp2 is ex2.approx (2^-22 relative). The wgmma
// accumulators' adds truncate (flash_attention_bwd.cu's note); over the
// longest chain here, 4096 products into dv at llama3-8b's shape, that
// drift stays inside the bf16 check's 2^-8·|plain|.
#include <cuda.h>

#include "common.cuh"
#include "flash_bwd.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace h2eal {
namespace bwd {
namespace {

constexpr int NCWG = 2;  // consumer warpgroups
constexpr int NT = 128 * (NCWG + 1);
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kEntryRegs = (128 * kProducerRegs + NCWG * 128 * kConsumerRegs) / NT;

using sm90::mbar_arrive;
using sm90::mbar_expect_tx;
using sm90::mbar_init;
using sm90::mbar_wait;
using sm90::pack_bf16;
using sm90::tma_load_4d;

// swizzle of a tile of D bf16 columns: the widest of 128, 64 and 32 bytes
// whose atoms tile D (32 at D = 80: five atoms of 16 columns)
template <int D>
struct Atoms {
  static constexpr int SW = D % 64 == 0 ? 128 : (D % 32 == 0 ? 64 : 32);
  static constexpr int AC = SW / 2;  // bf16 columns of one atom
  static constexpr int NA = D / AC;  // atoms across D
  static_assert(D % AC == 0 && D % 16 == 0, "the atoms and the k16 steps tile D");
};

template <int D>
struct DqCfg : Atoms<D> {
  static constexpr int BQ = 128, BK = 64;
  static constexpr int Q_BYTES = BQ * D * 2;   // the Q tile, and the dO tile
  static constexpr int KV_BYTES = BK * D * 2;  // one K or V tile
  static constexpr int FIT = (232448 - 1024 - 2 * Q_BYTES - 8 * 17) / (2 * KV_BYTES);
  static constexpr int STAGES = FIT < 8 ? FIT : 8;
  static constexpr int bytes = 1024 + 2 * Q_BYTES + 2 * STAGES * KV_BYTES + 8 * (1 + 2 * STAGES);
  static_assert(STAGES >= 2, "ring");
};

template <int D>
struct KvCfg : Atoms<D> {
  static constexpr int BKV = 128, BR = 32;
  static constexpr int KV_BYTES = BKV * D * 2;  // the K tile, and the V tile
  static constexpr int Q_BYTES = BR * D * 2;    // one Q or dO tile
  static constexpr int FIT = (232448 - 1024 - 2 * KV_BYTES - 8 * 17) / (2 * Q_BYTES);
  static constexpr int STAGES = FIT < 8 ? FIT : 8;
  static constexpr int bytes = 1024 + 2 * KV_BYTES + 2 * STAGES * Q_BYTES + 8 * (1 + 2 * STAGES);
  static_assert(STAGES >= 2, "ring");
};

__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(raw) + 1023) &
                                          ~uintptr_t(1023));
}

// x0, x1 as two bf16 pairs, hi = bf16(x), lo = bf16(x − hi)
__device__ __forceinline__ void split_pack(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - hf.x, x1 - hf.y);
}

// An m64nN accumulator fragment as k16 A fragments, split: for each 16
// columns kk, hi[kk] and lo[kk]
template <int N>
__device__ __forceinline__ void split_frag(const float (&x)[N / 2], uint32_t (&hi)[N / 16][4],
                                           uint32_t (&lo)[N / 16][4]) {
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
    split_pack(x[4 * i], x[4 * i + 1], hi[i / 2][(i & 1) * 2], lo[i / 2][(i & 1) * 2]);
    split_pack(x[4 * i + 2], x[4 * i + 3], hi[i / 2][(i & 1) * 2 + 1],
               lo[i / 2][(i & 1) * 2 + 1]);
  }
}

// Δ of one row from o and dO in device memory: the 4 threads of a quad take
// 8 columns in turn; every thread of the quad returns the sum
template <int D>
__device__ __forceinline__ float row_delta(const __nv_bfloat16* o, const __nv_bfloat16* g,
                                           int quad_lane) {
  float acc = 0.f;
#pragma unroll
  for (int c = quad_lane * 8; c < D; c += 32) {
    const uint4 a = *reinterpret_cast<const uint4*>(o + c);
    const uint4 b = *reinterpret_cast<const uint4*>(g + c);
    const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 x = __bfloat1622float2(a2[e]), y = __bfloat1622float2(b2[e]);
      acc = fmaf(x.x, y.x, fmaf(x.y, y.y, acc));
    }
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  return acc;
}

// ---------------------------------------------------------------------------
// launch 1: dq (and Δ)
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(NT, 1) dq_sm90_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tg,
    const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
    const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, float* __restrict__ delta, __nv_bfloat16* __restrict__ dq,
    int sq, int sk, int hq, int hkv, int causal, int window, int sink, int q_offset,
    float scale_log2, float scale) {
  using C = DqCfg<D>;
  constexpr int S = C::STAGES, BQ = C::BQ, BK = C::BK, SW = C::SW, AC = C::AC;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = aligned_smem(smem_raw);
  unsigned char* q_s = base;                  // [NA][BQ][AC]
  unsigned char* g_s = base + C::Q_BYTES;     // [NA][BQ][AC]: dO
  unsigned char* kv_s = g_s + C::Q_BYTES;     // [S][K, V][NA][BK][AC]
  uint64_t* bars = reinterpret_cast<uint64_t*>(kv_s + 2 * S * C::KV_BYTES);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = full + S;

  const int qt = gridDim.x - 1 - blockIdx.x;  // the heaviest tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int i_min = qt * BQ + q_offset;
  const int i_max = min(qt * BQ + BQ, sq) - 1 + q_offset;
  const Span span(key_tiles_end(sk, BK, i_max, causal), BK, i_min, window, sink);

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NCWG * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = tid / 128;
  if (wg == 0) {
    // ---- producer: thread 0 loads Q and dO, then the K/V ring ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid == 0) {
      mbar_expect_tx(q_full, 2 * C::Q_BYTES);
#pragma unroll
      for (int a = 0; a < C::NA; ++a) {
        tma_load_4d(q_s + a * BQ * SW, &tq, q_full, a * AC, h, qt * BQ, b);
        tma_load_4d(g_s + a * BQ * SW, &tg, q_full, a * AC, h, qt * BQ, b);
      }
      int it = 0;
      for (int kt = span.next(0); kt < span.end; kt = span.next(kt + 1), ++it) {
        const int st = it % S;
        mbar_wait(&empty[st], ((it / S) & 1) ^ 1);
        mbar_expect_tx(&full[st], 2 * C::KV_BYTES);
        unsigned char* dst = kv_s + st * 2 * C::KV_BYTES;
#pragma unroll
        for (int a = 0; a < C::NA; ++a) {
          tma_load_4d(dst + a * BK * SW, &tk, &full[st], a * AC, hk, kt * BK, b);
          tma_load_4d(dst + C::KV_BYTES + a * BK * SW, &tv, &full[st], a * AC, hk, kt * BK, b);
        }
      }
    }
  } else {
    // ---- consumers: 64 q rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int cw = wg - 1;
    const int t = tid % 128, warp = t / 32, lane = t % 32;
    const int col_t = 2 * (lane % 4);
    const int row_lo = qt * BQ + 64 * cw + 16 * warp + lane / 4;  // and row_lo + 8
    const int wg_min = qt * BQ + 64 * cw + q_offset, wg_max = wg_min + 63;
    const long soff = ((long)b * hq + h) * sq;
    float lr[2], dr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row_lo + 8 * r;
      const long off = (((long)b * sq + min(row, sq - 1)) * hq + h) * D;
      dr[r] = row_delta<D>(o + off, dout + off, lane % 4);
      if (row >= sq) dr[r] = 0.f;
      lr[r] = row < sq ? lse_log2(lse[soff + row]) : INFINITY;
      if (row < sq && lane % 4 == 0) delta[soff + row] = dr[r];
    }
    const unsigned char* q_wg = q_s + 64 * cw * SW;
    const unsigned char* g_wg = g_s + 64 * cw * SW;
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float s[BK / 2], dp[BK / 2];
    uint32_t ah[BK / 16][4], al[BK / 16][4];
    mbar_wait(q_full, 0);

    const int n_live = span.live();
    for (int it = 0, kt = span.next(0); it < n_live; ++it, kt = span.next(kt + 1)) {
      const int st = it % S;
      mbar_wait(&full[st], (it / S) & 1);
      const unsigned char* k_st = kv_s + st * 2 * C::KV_BYTES;
      const unsigned char* v_st = k_st + C::KV_BYTES;
      sm90::fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {  // S = Q·Kᵀ
        const int a = kk * 16 / AC, cb = (kk * 16 % AC) * 2;
        sm90::mma_ss<BK>(s, sm90::make_desc(q_wg + a * BQ * SW + cb, 16, 8 * SW, SW),
                         sm90::make_desc(k_st + a * BK * SW + cb, 16, 8 * SW, SW), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {  // dP = dO·Vᵀ
        const int a = kk * 16 / AC, cb = (kk * 16 % AC) * 2;
        sm90::mma_ss<BK>(dp, sm90::make_desc(g_wg + a * BQ * SW + cb, 16, 8 * SW, SW),
                         sm90::make_desc(v_st + a * BK * SW + cb, 16, 8 * SW, SW), kk > 0);
      }
      sm90::commit();
      sm90::wait<0>();
      sm90::fence_regs(s);
      sm90::fence_regs(dp);

      // dS = P∘(dP − Δ) over S; element 4i + e: row row_lo + 8(e/2), key
      // c0 + 8i + col_t + e%2
      const int c0 = kt * BK;
      const bool need_mask = c0 + BK > sk || (causal && c0 + BK - 1 > wg_min) ||
                             (window > 0 && c0 <= wg_max - window);
#pragma unroll
      for (int i = 0; i < BK / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = ex2(fmaf(s[4 * i + e], scale_log2, -lr[e >> 1]));
          if (need_mask && !allowed(row_lo + 8 * (e >> 1) + q_offset,
                                    c0 + 8 * i + col_t + (e & 1), sk, causal, window, sink))
            p = 0.f;
          s[4 * i + e] = p * (dp[4 * i + e] - dr[e >> 1]);
        }
      split_frag<BK>(s, ah, al);

      // dq += dS·K: K is keys x D with D contiguous, read transposed
      sm90::fence_regs(acc);
      sm90::fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t dk = sm90::make_desc(k_st + kk * 16 * SW, BK * SW, 8 * SW, SW);
        sm90::mma_rs<D>(acc, al[kk], dk);
        sm90::mma_rs<D>(acc, ah[kk], dk);
      }
      sm90::commit();
      sm90::wait<0>();
      sm90::fence_regs(acc);
      mbar_arrive(&empty[st]);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row_lo + 8 * r;
      if (row < sq) {
        __nv_bfloat16* op = dq + (((long)b * sq + row) * hq + h) * D + col_t;
#pragma unroll
        for (int i = 0; i < D / 8; ++i)
          *reinterpret_cast<uint32_t*>(op + 8 * i) =
              pack_bf16(acc[4 * i + 2 * r] * scale, acc[4 * i + 2 * r + 1] * scale);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launch 2: dk and dv
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(NT, 1) dkdv_sm90_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tg,
    const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
    const float* __restrict__ lse, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
    float* __restrict__ parts_buf, int* __restrict__ arrivals, int parts, int sq, int sk,
    int hq, int hkv, int causal, int window, int sink, int q_offset, float scale_log2,
    float scale) {
  using C = KvCfg<D>;
  constexpr int S = C::STAGES, BKV = C::BKV, BR = C::BR, SW = C::SW, AC = C::AC;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = aligned_smem(smem_raw);
  unsigned char* k_s = base;                  // [NA][BKV][AC]
  unsigned char* v_s = base + C::KV_BYTES;    // [NA][BKV][AC]
  unsigned char* qg_s = v_s + C::KV_BYTES;    // [S][Q, dO][NA][BR][AC]
  uint64_t* bars = reinterpret_cast<uint64_t*>(qg_s + 2 * S * C::Q_BYTES);
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = full + S;

  __shared__ int last_part;

  // blocks [0, parts) take the runs of key tile 0 (flash_bwd.cuh: sink_parts;
  // one block, parts = 1, without a cut); under causal, the first key tiles
  // are the heaviest
  const bool cut = blockIdx.x < parts && parts > 1;
  const int kt = cut ? 0 : blockIdx.x - (parts - 1);
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int group = hq / hkv;
  const int c0 = kt * BKV;
  const QSpan qs(c0, min(c0 + BKV, sk) - 1, sq, BR, causal, window, sink, q_offset);
  const int n_q = qs.count();
  const int total = group * n_q;  // (head, q tile) items, head-major
  const int i0 = cut ? blockIdx.x * total / parts : 0;
  const int i1 = cut ? (blockIdx.x + 1) * total / parts : total;

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NCWG * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = tid / 128;
  if (wg == 0) {
    // ---- producer: thread 0 loads K and V, then the Q/dO ring ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid == 0) {
      mbar_expect_tx(kv_full, 2 * C::KV_BYTES);
#pragma unroll
      for (int a = 0; a < C::NA; ++a) {
        tma_load_4d(k_s + a * BKV * SW, &tk, kv_full, a * AC, hk, c0, b);
        tma_load_4d(v_s + a * BKV * SW, &tv, kv_full, a * AC, hk, c0, b);
      }
      for (int i = i0; i < i1; ++i) {
        const int h = hk * group + i / n_q, r0 = (qs.lo + i % n_q) * BR;
        const int st = (i - i0) % S;
        mbar_wait(&empty[st], (((i - i0) / S) & 1) ^ 1);
        mbar_expect_tx(&full[st], 2 * C::Q_BYTES);
        unsigned char* dst = qg_s + st * 2 * C::Q_BYTES;
#pragma unroll
        for (int a = 0; a < C::NA; ++a) {
          tma_load_4d(dst + a * BR * SW, &tq, &full[st], a * AC, h, r0, b);
          tma_load_4d(dst + C::Q_BYTES + a * BR * SW, &tg, &full[st], a * AC, h, r0, b);
        }
      }
    }
  } else {
    // ---- consumers: 64 keys each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int cw = wg - 1;
    const int t = tid % 128, warp = t / 32, lane = t % 32;
    const int col_t = 2 * (lane % 4);
    const int key_lo = c0 + 64 * cw + 16 * warp + lane / 4;  // and key_lo + 8
    const int wg_min = c0 + 64 * cw, wg_max = wg_min + 63;
    const unsigned char* k_wg = k_s + 64 * cw * SW;
    const unsigned char* v_wg = v_s + 64 * cw * SW;
    float ak[D / 2], av[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) ak[i] = av[i] = 0.f;
    float st_[BR / 2], dpt[BR / 2];
    uint32_t ph[BR / 16][4], pl[BR / 16][4], sh[BR / 16][4], sl[BR / 16][4];
    mbar_wait(kv_full, 0);

    for (int i = i0; i < i1; ++i) {
      const int h = hk * group + i / n_q, r0 = (qs.lo + i % n_q) * BR;
      const int st = (i - i0) % S;
      // L and Δ of the rows this thread's columns hold: r0 + 8j + col_t + {0, 1}
      const long soff = ((long)b * hq + h) * sq + r0;
      float lr[BR / 4], dr[BR / 4];
#pragma unroll
      for (int j = 0; j < BR / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = 8 * j + col_t + e;
          const bool in = r0 + r < sq;
          lr[2 * j + e] = in ? lse_log2(lse[soff + r]) : INFINITY;
          dr[2 * j + e] = in ? delta[soff + r] : 0.f;
        }
      mbar_wait(&full[st], ((i - i0) / S) & 1);
      const unsigned char* q_st = qg_s + st * 2 * C::Q_BYTES;
      const unsigned char* g_st = q_st + C::Q_BYTES;
      sm90::fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {  // Sᵀ = K·Qᵀ
        const int a = kk * 16 / AC, cb = (kk * 16 % AC) * 2;
        sm90::mma_ss<BR>(st_, sm90::make_desc(k_wg + a * BKV * SW + cb, 16, 8 * SW, SW),
                         sm90::make_desc(q_st + a * BR * SW + cb, 16, 8 * SW, SW), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {  // dPᵀ = V·dOᵀ
        const int a = kk * 16 / AC, cb = (kk * 16 % AC) * 2;
        sm90::mma_ss<BR>(dpt, sm90::make_desc(v_wg + a * BKV * SW + cb, 16, 8 * SW, SW),
                         sm90::make_desc(g_st + a * BR * SW + cb, 16, 8 * SW, SW), kk > 0);
      }
      sm90::commit();
      sm90::wait<0>();
      sm90::fence_regs(st_);
      sm90::fence_regs(dpt);

      // Pᵀ and dSᵀ; element 4j + e: key key_lo + 8(e/2), row r0 + 8j + col_t +
      // e%2. Keys past Sk are not masked: their rows of dk and dv are not stored
      const int a0 = r0 + q_offset;
      const bool need_mask =
          (causal && wg_max > a0) || (window > 0 && wg_min <= a0 + BR - 1 - window);
#pragma unroll
      for (int j = 0; j < BR / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int x = 2 * j + (e & 1);
          float p = ex2(fmaf(st_[4 * j + e], scale_log2, -lr[x]));
          if (need_mask && !allowed(a0 + 8 * j + col_t + (e & 1), key_lo + 8 * (e >> 1), sk,
                                    causal, window, sink))
            p = 0.f;
          st_[4 * j + e] = p;
          dpt[4 * j + e] = p * (dpt[4 * j + e] - dr[x]);
        }
      split_frag<BR>(st_, ph, pl);
      split_frag<BR>(dpt, sh, sl);

      // dv += Pᵀ·dO and dk += dSᵀ·Q: dO and Q are rows x D with D contiguous,
      // read transposed
      sm90::fence_regs(av);
      sm90::fence_regs(ak);
      sm90::fence();
#pragma unroll
      for (int kk = 0; kk < BR / 16; ++kk) {
        const uint64_t dg = sm90::make_desc(g_st + kk * 16 * SW, BR * SW, 8 * SW, SW);
        const uint64_t dq_ = sm90::make_desc(q_st + kk * 16 * SW, BR * SW, 8 * SW, SW);
        sm90::mma_rs<D>(av, pl[kk], dg);
        sm90::mma_rs<D>(av, ph[kk], dg);
        sm90::mma_rs<D>(ak, sl[kk], dq_);
        sm90::mma_rs<D>(ak, sh[kk], dq_);
      }
      sm90::commit();
      sm90::wait<0>();
      sm90::fence_regs(av);
      sm90::fence_regs(ak);
      mbar_arrive(&empty[st]);
    }

    const long koff = ((long)b * sk * hkv + hk) * D;  // key 0's row
    if (!cut) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int key = key_lo + 8 * r;
        if (key < sk) {
          const long off = koff + (long)key * hkv * D + col_t;
#pragma unroll
          for (int i = 0; i < D / 8; ++i) {
            *reinterpret_cast<uint32_t*>(dk + off + 8 * i) =
                pack_bf16(ak[4 * i + 2 * r] * scale, ak[4 * i + 2 * r + 1] * scale);
            *reinterpret_cast<uint32_t*>(dv + off + 8 * i) =
                pack_bf16(av[4 * i + 2 * r], av[4 * i + 2 * r + 1]);
          }
        }
      }
      return;
    }
    // a run of a cut tile 0: its partial (f32, dk scaled) into its part of
    // parts_buf; the last run to finish sums the parts
    float* pk = parts_buf + (((long)blockIdx.x * gridDim.z + b) * hkv + hk) * 2 * BKV * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = key_lo + 8 * r;  // c0 = 0
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        *reinterpret_cast<float2*>(pk + key * D + 8 * i + col_t) =
            make_float2(ak[4 * i + 2 * r] * scale, ak[4 * i + 2 * r + 1] * scale);
        *reinterpret_cast<float2*>(pk + (BKV + key) * D + 8 * i + col_t) =
            make_float2(av[4 * i + 2 * r], av[4 * i + 2 * r + 1]);
      }
    }
    __threadfence();
    asm volatile("bar.sync 1, %0;\n" ::"n"(NCWG * 128) : "memory");  // the consumers
    if (tid == 128) last_part = atomicAdd(&arrivals[b * hkv + hk], 1) == parts - 1;
    asm volatile("bar.sync 1, %0;\n" ::"n"(NCWG * 128) : "memory");
    if (last_part) {
      __threadfence();
      merge_parts<__nv_bfloat16, D, BKV>(parts_buf, parts, gridDim.z, hkv, b, hk, sk, dk, dv,
                                         koff, (long)hkv * D, tid - 128, NCWG * 128);
      if (tid == 128) arrivals[b * hkv + hk] = 0;
    }
  }
}

// (B, S, H, D) bf16 as a 4-D map {D, H, S, B}; a box is `rows` rows of one
// head, `ac` columns wide (one swizzle atom); rows past S read as zeros
bool make_map(sm90::EncodeTiled enc, CUtensorMap* map, const void* ptr, int b, int s, int h,
              int d, int ac, int rows, int sw) {
  return sm90::make_map_4d(enc, map, ptr, {d, h, s, b}, {ac, 1, rows, 1}, sw);
}

// setmaxnreg moves registers within the block: the consumers' 232 need the
// block to start with (128·40 + 256·232) / 384 = 168 a thread, or their
// setmaxnreg.inc would wait forever; refuse to launch rather than hang
template <typename Kern>
cudaError_t prepare(Kern kern, int bytes) {
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  if ((err = cudaFuncGetAttributes(&attr, kern)) != cudaSuccess) return err;
  return attr.numRegs < kEntryRegs ? cudaErrorInvalidConfiguration : cudaSuccess;
}

template <int D>
cudaError_t launch(const BwdArgs& a) {
  using Q = DqCfg<D>;
  using K = KvCfg<D>;
  const sm90::EncodeTiled enc = sm90::encoder();
  if (enc == nullptr) return cudaErrorNotSupported;
  CUtensorMap q1, g1, k1, v1, q2, g2, k2, v2;
  if (!make_map(enc, &q1, a.q, a.b, a.sq, a.hq, D, Q::AC, Q::BQ, Q::SW) ||
      !make_map(enc, &g1, a.dout, a.b, a.sq, a.hq, D, Q::AC, Q::BQ, Q::SW) ||
      !make_map(enc, &k1, a.k, a.b, a.sk, a.hkv, D, Q::AC, Q::BK, Q::SW) ||
      !make_map(enc, &v1, a.v, a.b, a.sk, a.hkv, D, Q::AC, Q::BK, Q::SW) ||
      !make_map(enc, &q2, a.q, a.b, a.sq, a.hq, D, K::AC, K::BR, K::SW) ||
      !make_map(enc, &g2, a.dout, a.b, a.sq, a.hq, D, K::AC, K::BR, K::SW) ||
      !make_map(enc, &k2, a.k, a.b, a.sk, a.hkv, D, K::AC, K::BKV, K::SW) ||
      !make_map(enc, &v2, a.v, a.b, a.sk, a.hkv, D, K::AC, K::BKV, K::SW))
    return cudaErrorInvalidValue;
  cudaError_t err;
  if ((err = prepare(dq_sm90_kernel<D>, Q::bytes)) != cudaSuccess) return err;
  if ((err = prepare(dkdv_sm90_kernel<D>, K::bytes)) != cudaSuccess) return err;
  const float scale_log2 = a.scale * kLog2e;
  const int nqt = (a.sq + Q::BQ - 1) / Q::BQ;
  dq_sm90_kernel<D><<<dim3(nqt, a.hq, a.b), NT, Q::bytes, a.stream>>>(
      q1, g1, k1, v1, static_cast<const __nv_bfloat16*>(a.o),
      static_cast<const __nv_bfloat16*>(a.dout), a.lse, a.delta,
      static_cast<__nv_bfloat16*>(a.dq), a.sq, a.sk, a.hq, a.hkv, a.causal, a.window, a.sink,
      a.q_offset, scale_log2, a.scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int nkt = (a.sk + K::BKV - 1) / K::BKV;
  const int parts = sink_parts(a.sq, a.window, a.sink, K::BR, K::BKV);
  dkdv_sm90_kernel<D><<<dim3(nkt + parts - 1, a.hkv, a.b), NT, K::bytes, a.stream>>>(
      q2, g2, k2, v2, a.lse, a.delta, static_cast<__nv_bfloat16*>(a.dk),
      static_cast<__nv_bfloat16*>(a.dv), a.parts_buf, a.arrivals, parts, a.sq, a.sk, a.hq,
      a.hkv, a.causal, a.window, a.sink, a.q_offset, scale_log2, a.scale);
  return cudaGetLastError();
}

template <int D>
long parts_floats_of(int b, int sq, int hkv, int window, int sink) {
  using K = KvCfg<D>;
  return parts_floats(sink_parts(sq, window, sink, K::BR, K::BKV), b, hkv, K::BKV, D);
}

}  // namespace

long flash_bwd_bf16_sm90_parts(int d, int b, int sq, int hkv, int window, int sink) {
  switch (d) {
    case 32: return parts_floats_of<32>(b, sq, hkv, window, sink);
    case 64: return parts_floats_of<64>(b, sq, hkv, window, sink);
    case 80: return parts_floats_of<80>(b, sq, hkv, window, sink);
    case 128: return parts_floats_of<128>(b, sq, hkv, window, sink);
    default: return 0;
  }
}

cudaError_t flash_bwd_bf16_sm90(int d, const BwdArgs& a) {
  switch (d) {
    case 32: return launch<32>(a);
    case 64: return launch<64>(a);
    case 80: return launch<80>(a);
    case 128: return launch<128>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace bwd
}  // namespace h2eal
