// Prefill GQA attention in bf16 on Hopper's tensor cores: causal, optional
// sliding window and attention sinks.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (the pl.pallas_call at :97) for bf16 operands; ops.py routes by dtype, and
// f32 operands keep the FMA kernel of flash_attention.cu (TF32 tensor cores
// would not hold f32's 1e-4 tolerance, and the serving path is bf16). Same
// contract: q (B,Sq,Hq,D), k/v (B,Sk,Hkv,D), D in {32, 64, 128}, Hq a
// multiple of Hkv; key j is attended by query row i (absolute position
// i + q_offset) iff j <= row (causal), j > row - window (window > 0), or
// j < sink (sink > 0, only together with a window). A row with every key
// masked returns 0. Output bf16.
//
// What bounds it on the H100: the retrieval (full causal) heads are
// compute-bound: 5.5e11 FLOP per layer at B=2, S=8192, 16 heads, D=128, so
// 0.56 ms at the 989 TFLOP/s bf16 tensor-core peak, where the f32 FMA units
// (67 TFLOP/s) could not go below 8.2 ms. The streaming heads (window 256 +
// 4 sinks) are bound by the bytes of q, k, v and the output.
//
// Design (the shape of FlashAttention-3): one block of three warpgroups per
// (q tile of BQ = 128 rows, q head, batch), the blocks of the heaviest
// (last) causal tiles launched first. Warpgroup 0 is the producer: it gives
// up registers (setmaxnreg), and one thread loads the q tile once by TMA,
// then keeps K and V tiles of BK = 128 keys in flight through a ring of
// STAGES buffers, each with a full and an empty mbarrier. Warpgroups 1 and 2
// are consumers of 64 q rows each, with the registers the producer gave up:
//   S = Q·Kᵀ: wgmma m64n128k16, Q and K read from shared memory K-major
//     through descriptors of the 128-byte swizzle TMA wrote (64-byte at
//     D = 32), f32 accumulators in registers;
//   online softmax on the accumulator fragment: a thread holds two rows,
//     whose max and sum need two shuffles among the 4 threads of a quad; the
//     masks run only on tiles that cross the causal diagonal, the window
//     edge or the ragged end (TMA zero-fills keys past Sk, and a zero key
//     scores 0, not -inf, so the column mask still excludes them);
//   O += P·V: the unnormalised P, rounded to bf16 in registers, is wgmma's
//     register A operand (the m64nN accumulator layout is the k16 A
//     fragment layout), V is the shared-memory B operand read transposed
//     (V is keys x D with D contiguous); O is f32 in registers.
// A consumer releases a ring stage (256 arrivals on its empty barrier) only
// after the P·V that read it has completed. The epilogue divides by
// max(l, 1e-30), so a row with no attended key gives 0, and writes bf16. Key
// tiles wholly outside causal ∪ (window + sink) are never loaded, so the
// streaming heads cost O(S·(window + sink)).
//
// Numerics and tolerance: products are exact bf16 x bf16 in f32, sums f32.
// The one rounding the plain version on f32-widened inputs does not make is
// P to bf16 before P·V. Each p = exp(s - m_running) lies in [0, 1], and the
// key at the running max has p = 1 exactly; rounding to nearest bf16 moves
// p by at most 2^-8·p, so the output moves by at most 2^-8·Σ p|v| / l =
// 2^-8·(softmax(s)·|V|), on top of the output's own rounding (2^-8·|out|).
// So the kernel is held to |kernel - plain| <= 2^-8·(softmax(s)·|V|) +
// 2^-8·|plain| + 1e-5 (chip_smoke.py::check_flash, tests/test_torch_cuda.py).
#include <cuda.h>

#include "common.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace h2eal {
namespace {

constexpr int BQ = 128;  // q rows per block: 64 per consumer warpgroup
constexpr int BK = 128;  // keys per ring stage
constexpr int NCWG = 2;  // consumer warpgroups
constexpr int NT = 128 * (NCWG + 1);
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kEntryRegs = (128 * kProducerRegs + NCWG * 128 * kConsumerRegs) / NT;

template <int D>
struct Cfg {
  static constexpr int SW = D >= 64 ? 128 : 64;  // swizzle span = bytes of an atom row
  static constexpr int AC = SW / 2;               // bf16 columns of one swizzle atom
  static constexpr int NA = D / AC;               // atoms across D
  static constexpr int STAGES = D == 128 ? 2 : 3;
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;     // one K or V tile
  static constexpr int BAR_BYTES = 8 * (1 + 2 * STAGES);
  static constexpr int bytes = 1024 + Q_BYTES + 2 * STAGES * KV_BYTES + BAR_BYTES;
};

using sm90::mbar_arrive;
using sm90::mbar_expect_tx;
using sm90::mbar_init;
using sm90::mbar_wait;
using sm90::pack_bf16;
using sm90::tma_load_4d;

// key tiles of one q tile: [0, end), skipping those wholly outside the
// window that hold no sink key
struct KeySpan {
  int end, i_min, window, sink;
  __device__ bool skip(int kt) const {
    const int c0 = kt * BK;
    return window > 0 && c0 >= sink && c0 + BK - 1 <= i_min - window;
  }
};

template <int D>
__global__ void __launch_bounds__(NT, 1) flash_sm90_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o, int nb, int sq,
    int sk, int hq, int hkv, int n_qt, int causal, int window, int sink, int q_offset,
    float scale_log2) {
  using C = Cfg<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* q_s = base;                                // [NA][BQ][AC]
  unsigned char* kv_s = base + C::Q_BYTES;                  // [STAGES][K|V][NA][BK][AC]
  uint64_t* bars = reinterpret_cast<uint64_t*>(kv_s + 2 * C::STAGES * C::KV_BYTES);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + C::STAGES;

  // heaviest causal tiles first: the rank of the q tile is the slow index
  const int hb = hq * nb;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x) / hb;
  const int h = static_cast<int>(blockIdx.x) % hb % hq;
  const int b = static_cast<int>(blockIdx.x) % hb / hq;
  const int hk = h / (hq / hkv);
  const int r0 = qt * BQ;

  KeySpan span;
  span.i_min = r0 + q_offset;
  span.window = window;
  span.sink = sink;
  span.end = (sk + BK - 1) / BK;
  if (causal) span.end = min(span.end, (min(r0 + BQ, sq) - 1 + q_offset) / BK + 1);

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NCWG * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = tid / 128;
  if (wg == 0) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid == 0) {
      mbar_expect_tx(q_full, C::Q_BYTES);
#pragma unroll
      for (int a = 0; a < C::NA; ++a)
        tma_load_4d(q_s + a * BQ * C::SW, &tq, q_full, a * C::AC, h, r0, b);
      int it = 0;
      for (int kt = 0; kt < span.end; ++kt) {
        if (span.skip(kt)) continue;
        const int st = it % C::STAGES;
        mbar_wait(&empty[st], ((it / C::STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[st], 2 * C::KV_BYTES);
        unsigned char* k_st = kv_s + st * 2 * C::KV_BYTES;
#pragma unroll
        for (int a = 0; a < C::NA; ++a) {
          tma_load_4d(k_st + a * BK * C::SW, &tk, &full[st], a * C::AC, hk, kt * BK, b);
          tma_load_4d(k_st + C::KV_BYTES + a * BK * C::SW, &tv, &full[st], a * C::AC, hk,
                      kt * BK, b);
        }
        ++it;
      }
    }
  } else {
    // ---- consumers: 64 q rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int cw = wg - 1;
    const int t = tid % 128, warp = t / 32, lane = t % 32;
    const int row_lo = r0 + 64 * cw + 16 * warp + lane / 4;  // and row_lo + 8
    const int col_t = 2 * (lane % 4);
    const int wg_min = r0 + 64 * cw + q_offset;  // absolute positions of the wg's rows
    const int wg_max = wg_min + 63;

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

    mbar_wait(q_full, 0);
    const unsigned char* q_wg = q_s + 64 * cw * C::SW;
    int it = 0;
    for (int kt = 0; kt < span.end; ++kt) {
      if (span.skip(kt)) continue;
      const int st = it % C::STAGES;
      mbar_wait(&full[st], (it / C::STAGES) & 1);
      const unsigned char* k_st = kv_s + st * 2 * C::KV_BYTES;
      const unsigned char* v_st = k_st + C::KV_BYTES;

      // S = Q·Kᵀ over D in steps of 16
      float s[BK / 2];
      sm90::fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int a = kk * 16 / C::AC, cb = (kk * 16 % C::AC) * 2;
        const uint64_t dq = sm90::make_desc(q_wg + a * BQ * C::SW + cb, 16, 8 * C::SW, C::SW);
        const uint64_t dk = sm90::make_desc(k_st + a * BK * C::SW + cb, 16, 8 * C::SW, C::SW);
        sm90::mma_ss_n128(s, dq, dk, kk > 0);
      }
      sm90::commit();
      sm90::wait<0>();
      sm90::fence_regs(s);

      const int c0 = kt * BK;
      const bool need_mask = c0 + BK > sk || (causal && c0 + BK - 1 > wg_min) ||
                             (window > 0 && c0 <= wg_max - window);
      if (need_mask) {
#pragma unroll
        for (int i = 0; i < BK / 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = row_lo + (e >> 1) * 8 + q_offset;
            const int col = c0 + 8 * i + col_t + (e & 1);
            bool ok = col < sk;
            if (causal) ok = ok && col <= row;
            if (window > 0) ok = ok && (col > row - window || col < sink);
            if (!ok) s[4 * i + e] = -INFINITY;
          }
      }
      // online softmax, base 2, rows lo (e = 0, 1) and hi (e = 2, 3)
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < BK / 8; ++i) {
        mx[0] = fmaxf(mx[0], fmaxf(s[4 * i], s[4 * i + 1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[4 * i + 2], s[4 * i + 3]));
      }
      float corr[2], mu[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r] * scale_log2);
        mu[r] = m_new == -INFINITY ? 0.f : m_new;  // a row with nothing attended yet
        corr[r] = exp2f(m[r] - mu[r]);
        m[r] = m_new;
        l[r] *= corr[r];
      }
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int i = 0; i < BK / 8; ++i) {
        const float p0 = exp2f(fmaf(s[4 * i], scale_log2, -mu[0]));
        const float p1 = exp2f(fmaf(s[4 * i + 1], scale_log2, -mu[0]));
        const float p2 = exp2f(fmaf(s[4 * i + 2], scale_log2, -mu[1]));
        const float p3 = exp2f(fmaf(s[4 * i + 3], scale_log2, -mu[1]));
        l[0] += p0 + p1;
        l[1] += p2 + p3;
        pa[i / 2][(i & 1) * 2] = pack_bf16(p0, p1);
        pa[i / 2][(i & 1) * 2 + 1] = pack_bf16(p2, p3);
      }
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        acc[4 * i] *= corr[0];
        acc[4 * i + 1] *= corr[0];
        acc[4 * i + 2] *= corr[1];
        acc[4 * i + 3] *= corr[1];
      }

      // O += P·V over the tile's keys in steps of 16
      sm90::fence_regs(acc);
      sm90::fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t dv =
            sm90::make_desc(v_st + kk * 16 * C::SW, BK * C::SW, 8 * C::SW, C::SW);
        sm90::mma_rs<D>(acc, pa[kk], dv);
      }
      sm90::commit();
      sm90::wait<0>();
      sm90::fence_regs(acc);
      mbar_arrive(&empty[st]);  // this thread's reads of the stage are done
      ++it;
    }

    // epilogue: sum l over the quad, divide, write bf16
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      l[r] = 1.f / fmaxf(l[r], 1e-30f);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row_lo + 8 * r;
      if (row < sq) {
        __nv_bfloat16* op = o + (((long)b * sq + row) * hq + h) * D + col_t;
#pragma unroll
        for (int i = 0; i < D / 8; ++i)
          *reinterpret_cast<uint32_t*>(op + 8 * i) =
              pack_bf16(acc[4 * i + 2 * r] * l[r], acc[4 * i + 2 * r + 1] * l[r]);
      }
    }
  }
}

// (B, S, H, D) bf16 as a 4-D map {D, H, S, B}; a box is `rows` rows of one
// head, `ac` columns wide (one swizzle atom); rows past S read as zeros
bool make_map(sm90::EncodeTiled enc, CUtensorMap* map, const void* ptr, int b, int s, int h,
              int d, int ac, int rows, int sw) {
  return sm90::make_map_4d(enc, map, ptr, {d, h, s, b}, {ac, 1, rows, 1}, sw);
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int b, int sq, int sk,
                   int hq, int hkv, int causal, int window, int sink, int q_offset,
                   float scale, cudaStream_t stream) {
  using C = Cfg<D>;
  const sm90::EncodeTiled enc = sm90::encoder();
  if (enc == nullptr) return cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  if (!make_map(enc, &tq, q, b, sq, hq, D, C::AC, BQ, C::SW) ||
      !make_map(enc, &tk, k, b, sk, hkv, D, C::AC, BK, C::SW) ||
      !make_map(enc, &tv, v, b, sk, hkv, D, C::AC, BK, C::SW))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_sm90_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::bytes);
  if (err != cudaSuccess) return err;
  // setmaxnreg moves registers within the block: the consumers' 232 need the
  // block to start with (128·40 + 256·232) / 384 = 168 a thread, or their
  // setmaxnreg.inc would wait forever; refuse to launch rather than hang
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, flash_sm90_kernel<D>);
  if (err != cudaSuccess) return err;
  if (attr.numRegs < kEntryRegs) return cudaErrorInvalidConfiguration;
  const int n_qt = (sq + BQ - 1) / BQ;
  flash_sm90_kernel<D><<<n_qt * hq * b, NT, C::bytes, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), b, sq, sk, hq, hkv, n_qt, causal, window,
      sink, q_offset, scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace
}  // namespace h2eal

extern "C" int h2eal_flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                                          int b, int sq, int sk, int hq, int hkv, int d,
                                          int causal, int window, int sink, int q_offset,
                                          float scale, void* stream) {
  using namespace h2eal;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return launch<32>(q, k, v, o, b, sq, sk, hq, hkv, causal, window, sink, q_offset, scale, st);
    case 64: return launch<64>(q, k, v, o, b, sq, sk, hq, hkv, causal, window, sink, q_offset, scale, st);
    case 128: return launch<128>(q, k, v, o, b, sq, sk, hq, hkv, causal, window, sink, q_offset, scale, st);
    default: return cudaErrorInvalidValue;
  }
}
