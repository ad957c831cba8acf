// Prefill GQA attention in bf16 on Hopper's tensor cores: causal, optional
// sliding window and attention sinks.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (the pl.pallas_call at :97) for bf16 operands; ops.py routes by dtype, and
// f32 operands keep the FMA kernel of flash_attention.cu (single TF32
// products would not hold f32's 1e-4 tolerance, and the serving path is
// bf16). Same
// contract: q (B,Sq,Hq,D), k/v (B,Sk,Hkv,D), D in {32, 64, 80, 128, 256}, Hq a
// multiple of Hkv; key j is attended by query row i (absolute position
// i + q_offset) iff j <= row (causal), j > row - window (window > 0), or
// j < sink (sink > 0, only together with a window). A row with every key
// masked returns 0. Output bf16. Where the caller passes `lse` (a (B, Hq, Sq)
// f32 buffer: the autograd forward, for the backward), each row's
// log-sum-exp of its scaled, masked scores is written there in natural log:
// the kernel works in base 2 with the scale folded in (m and the exponents
// are scale·log2e·s), so L = (m + log2 l)·ln 2, −inf for a row with no
// allowed key; serving passes null, launching an instantiation without
// the write, and the output is the same bit for bit.
//
// What bounds it on the H100: the retrieval (full causal) heads are
// compute-bound: 5.5e11 FLOP per layer at B=2, S=8192, 16 heads, D=128, so
// 0.56 ms at the 989 TFLOP/s bf16 tensor-core peak, where the f32 FMA units
// (67 TFLOP/s) could not go below 8.2 ms. The streaming heads (window 256 +
// 4 sinks) are bound by the bytes of q, k, v and the output.
//
// Design (the shape of FlashAttention-3): a persistent grid of one block of
// three warpgroups an SM, each block taking work items (q tile of BQ = 128
// rows, q head, batch) from a counter in device memory (one per stream, kept
// by ops.py) until none is left, heaviest (last) causal q tile first; full
// attention takes the items of one (batch, kv head) together (few K/V tiles
// in use at a time), a window the items of one q tile across the heads (so
// that a head's sink tile is not read by all its items at once). The last
// block out resets the counter for the next launch. Warpgroup 0 is the
// producer: it gives up registers (setmaxnreg); one thread takes the items,
// loads each one's q tile by TMA as soon as the consumers' products of the
// item before have stopped reading the last one (so a q tile's load and the
// first K/V tiles of an item overlap the last softmax, P·V and epilogue of
// the one before), then its K tiles of BK = 128 keys (64 at D = 256); a
// second thread loads the V tiles; both into one ring of STAGES stages that
// runs on across items (as many as the 227 KB of shared memory hold: 2 at
// D = 256, 3 at D = 128, 5 at D = 80, 6 at D = 64, 8 at D = 32), K and V each with their
// own full and empty mbarriers, so that a K buffer goes back to its producer
// as soon as its S product has completed.
// Warpgroups 1 and 2 are consumers of 64 q rows each, with the registers
// the producer gave up:
//   S = Q·Kᵀ: wgmma m64nBKk16, Q and K read from shared memory K-major
//     through descriptors of the 128-byte swizzle TMA wrote (64-byte at
//     D = 32; 32-byte at D = 80, whose 160-byte rows no wider atom tiles,
//     so each k16 step is one atom of 16 columns), f32 accumulators in
//     registers;
//   online softmax on the accumulator fragment: a thread holds two rows,
//     whose max and sum need two shuffles among the 4 threads of a quad; the
//     masks run only on tiles that cross the causal diagonal, the window
//     edge or the ragged end (TMA zero-fills keys past Sk, and a zero key
//     scores 0, not -inf, so the column mask still excludes them); a warp
//     whose rows' maxima all stayed put skips the rescale of O;
//   O += P·V: the unnormalised P, rounded to bf16 in registers, is wgmma's
//     register A operand (the m64nN accumulator layout is the k16 A
//     fragment layout), V is the shared-memory B operand read transposed
//     (V is keys x D with D contiguous); O is f32 in registers.
// The schedule overlaps each consumer's softmax with its own products: tile
// j's S = Q·K_jᵀ and the previous tile's O += P_{j-1}·V_{j-1} are issued back
// to back, wgmma.wait_group 1 waits for S_j alone, so tile j's softmax (exp2
// written over S in place) runs while P_{j-1}·V_{j-1} is still on the tensor
// cores; then wait_group 0, O is rescaled and the new P packed to bf16. The
// two consumers' products interleave as each issues them. A ping-pong across
// the two (each issuing only in its turn, ordered by named barriers) was
// measured slower than this free interleaving, with K/V loads and without
// them (PERF.md §6), and is not built: a strict alternation queues each S
// behind the other consumer's pair of products, which costs where a softmax
// lasts about as long as that pair (a reading, not a measurement). A consumer
// releases a K stage after its S product and a V stage after its P·V (256
// arrivals on each empty barrier). The epilogue divides by max(l, 1e-30), so
// a row with no attended key gives 0, and writes bf16. Key tiles wholly
// outside causal ∪ (window + sink) are never loaded, so the streaming heads
// cost O(S·(window + sink)).
//
// Numerics and tolerance: products are exact bf16 x bf16 in f32, sums f32.
// The one rounding the plain version on f32-widened inputs does not make is
// P to bf16 before P·V. Each p = exp(s - m_running) lies in [0, 1], and the
// key at the running max has p = 1 exactly; rounding to nearest bf16 moves
// p by at most 2^-8·p, so the output moves by at most 2^-8·Σ p|v| / l =
// 2^-8·(softmax(s)·|V|), on top of the output's own rounding (2^-8·|out|).
// So the kernel is held to |kernel - plain| <= 2^-8·(softmax(s)·|V|) +
// 2^-8·|plain| + 1e-5 (chip_smoke.py::check_flash, tests/test_torch_cuda.py).
// p comes from ex2.approx, within 2^-22 of exp2 relative, far inside that
// rounding; a p below 2^-126 flushes to 0, as it would round in bf16.
#include <cuda.h>

#include "common.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace h2eal {
namespace {

constexpr int BQ = 128;  // q rows per block: 64 per consumer warpgroup
constexpr int NCWG = 2;  // consumer warpgroups
constexpr int NT = 128 * (NCWG + 1);
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kEntryRegs = (128 * kProducerRegs + NCWG * 128 * kConsumerRegs) / NT;

template <int D>
struct Cfg {
  // keys per ring stage: 64 at D = 256, where two stages of 128 keys beside
  // the q tile would not fit and O's 128 f32 a thread leave S room for 32
  static constexpr int BK = D == 256 ? 64 : 128;
  // swizzle span = bytes of an atom row: the widest of 128, 64 and 32 whose
  // atoms tile D exactly (32 at D = 80: five atoms of 16 columns)
  static constexpr int SW = D % 64 == 0 ? 128 : (D % 32 == 0 ? 64 : 32);
  static constexpr int AC = SW / 2;               // bf16 columns of one swizzle atom
  static constexpr int NA = D / AC;               // atoms across D
  static_assert(D % AC == 0 && D % 16 == 0, "the atoms and the k16 steps tile D");
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;     // one K or V tile
  // as many stages as a block's 232,448 bytes of shared memory hold, at most 8
  static constexpr int FIT = (232448 - 1024 - Q_BYTES - 8 * 36 - 16) / (2 * KV_BYTES);
  static constexpr int STAGES = FIT < 8 ? FIT : 8;
  static constexpr int BAR_BYTES = 8 * (4 + 4 * STAGES);
  static constexpr int bytes = 1024 + Q_BYTES + 2 * STAGES * KV_BYTES + BAR_BYTES;
  static_assert(STAGES >= 2, "ring");
};

using sm90::mbar_arrive;
using sm90::mbar_expect_tx;
using sm90::mbar_init;
using sm90::mbar_wait;
using sm90::pack_bf16;
using sm90::tma_load_4d;

// key tiles of BK keys of one q tile (its first row at absolute position
// i_min): [0, end) but [lo, hi], the tiles wholly outside the window that
// hold no sink key (none without a window)
template <int BK>
struct KeySpan {
  int end, lo, hi;
  __device__ KeySpan(int end_, int i_min, int window, int sink) : end(end_) {
    lo = (sink + BK - 1) / BK;
    const int x = i_min - window - BK + 1;  // a tile at or below x·BK lies outside
    hi = window > 0 && x >= 0 ? min(x / BK, end - 1) : -1;
  }
  __device__ int live() const { return end - max(0, hi - lo + 1); }
  // the first tile at or after kt that is loaded
  __device__ int next(int kt) const { return kt >= lo && kt <= hi ? hi + 1 : kt; }
};

// 2^x on the special-function unit alone: exp2f's handling of results
// below 2^-126 is not needed for p in [0, 1] (such a p rounds to 0 in bf16)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// A work item: one (q tile, q head, batch), in the order of the note above
struct Item {
  int qt, h, b;
  __device__ Item(int item, int n_qt, int hq, int hkv, int nb, int window) {
    const int gq = hq / hkv;
    if (window > 0) {
      qt = n_qt - 1 - item / (hq * nb);
      h = item % hq;
      b = item / hq % nb;
    } else {
      qt = n_qt - 1 - item / gq % n_qt;
      h = item / gq / n_qt % hkv * gq + item % gq;
      b = item / gq / n_qt / hkv;
    }
  }
};

// kLse: the instantiation that writes the rows' log-sum-exp (the autograd
// forward); serving launches the one without, whose code is the kernel's
// before the output existed
template <int D, bool kLse>
__global__ void __launch_bounds__(NT, 1) flash_sm90_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
    float* __restrict__ lse, int* __restrict__ sched, int nb, int sq, int sk, int hq, int hkv, int n_qt, int causal,
    int window, int sink, int q_offset, float scale_log2) {
  using C = Cfg<D>;
  constexpr int S = C::STAGES, BK = C::BK;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* q_s = base;                                // [NA][BQ][AC]
  unsigned char* kv_s = base + C::Q_BYTES;                  // [S][K|V][NA][BK][AC]
  uint64_t* bars = reinterpret_cast<uint64_t*>(kv_s + 2 * S * C::KV_BYTES);
  uint64_t* q_full = bars;
  uint64_t* q_empty = bars + 1;
  uint64_t* item_bar = bars + 2;  // [2]: a work item's index is published
  uint64_t* full_k = bars + 4;
  uint64_t* full_v = full_k + S;
  uint64_t* empty_k = full_v + S;
  uint64_t* empty_v = empty_k + S;
  __shared__ int item_s[2];

  const int n_items = n_qt * hq * nb;
  const int gq = hq / hkv;
  // the key tiles of q tile qt
  auto span_of = [&](int qt) {
    int end = (sk + BK - 1) / BK;
    if (causal) end = min(end, (min(qt * BQ + BQ, sq) - 1 + q_offset) / BK + 1);
    return KeySpan<BK>(end, qt * BQ + q_offset, window, sink);
  };

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, NCWG * 128);
    mbar_init(&item_bar[0], 1);
    mbar_init(&item_bar[1], 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty_k[s], NCWG * 128);
      mbar_init(&empty_v[s], NCWG * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = tid / 128;
  if (wg == 0) {
    // ---- producer: thread 0 takes the work items and loads each one's Q and
    // K tiles, thread 32 its V tiles; the K/V ring runs on across items ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid == 0 || tid == 32) {
      const bool is_k = tid == 0;
      const CUtensorMap* map = is_k ? &tk : &tv;
      uint64_t* full = is_k ? full_k : full_v;
      uint64_t* empty = is_k ? empty_k : empty_v;
      int it = 0;
      for (int li = 0;; ++li) {
        int item;
        if (is_k) {
          // the next item, once the consumers' products no longer read Q
          if (li > 0) mbar_wait(q_empty, (li - 1) & 1);
          item = atomicAdd(&sched[0], 1);
          if (item >= n_items) item = -1;
          item_s[li & 1] = item;
          mbar_arrive(&item_bar[li & 1]);
          if (item < 0) {  // the last block out resets the schedule for the next launch
            if (atomicAdd(&sched[1], 1) == gridDim.x - 1) {
              sched[0] = 0;
              sched[1] = 0;
            }
            break;
          }
        } else {
          mbar_wait(&item_bar[li & 1], (li >> 1) & 1);
          item = item_s[li & 1];
          if (item < 0) break;
        }
        const Item w(item, n_qt, hq, hkv, nb, window);
        const KeySpan<BK> span = span_of(w.qt);
        if (is_k) {
          mbar_expect_tx(q_full, C::Q_BYTES);
#pragma unroll
          for (int a = 0; a < C::NA; ++a)
            tma_load_4d(q_s + a * BQ * C::SW, &tq, q_full, a * C::AC, w.h, w.qt * BQ, w.b);
        }
        for (int kt = span.next(0); kt < span.end; kt = span.next(kt + 1)) {
          const int st = it % S;
          mbar_wait(&empty[st], ((it / S) & 1) ^ 1);
          mbar_expect_tx(&full[st], C::KV_BYTES);
          unsigned char* dst = kv_s + st * 2 * C::KV_BYTES + (is_k ? 0 : C::KV_BYTES);
#pragma unroll
          for (int a = 0; a < C::NA; ++a)
            tma_load_4d(dst + a * BK * C::SW, map, &full[st], a * C::AC, w.h / gq, kt * BK,
                        w.b);
          ++it;
        }
      }
    }
  } else {
    // ---- consumers: 64 q rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int cw = wg - 1;
    const int t = tid % 128, warp = t / 32, lane = t % 32;
    const int col_t = 2 * (lane % 4);
    const unsigned char* q_wg = q_s + 64 * cw * C::SW;
    float acc[D / 2];
    float m[2], l[2];
    float s[BK / 2];
    uint32_t pa[BK / 16][4];
    int g0 = 0;  // ring position of this item's first key tile

    for (int li = 0;; ++li) {
      mbar_wait(&item_bar[li & 1], (li >> 1) & 1);
      const int item = item_s[li & 1];
      if (item < 0) break;
      const Item w(item, n_qt, hq, hkv, nb, window);
      const KeySpan<BK> span = span_of(w.qt);
      const int n_live = span.live();  // the key tiles the producer loads
      const int row_lo = w.qt * BQ + 64 * cw + 16 * warp + lane / 4;  // and row_lo + 8
      const int wg_min = w.qt * BQ + 64 * cw + q_offset;  // absolute positions of the wg's rows
      const int wg_max = wg_min + 63;
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
      m[0] = m[1] = -INFINITY;
      l[0] = l[1] = 0.f;
      mbar_wait(q_full, li & 1);

      // S = Q·Kᵀ of the stage over D in steps of 16 (committed as one group)
      auto issue_s = [&](int st) {
        const unsigned char* k_st = kv_s + st * 2 * C::KV_BYTES;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int a = kk * 16 / C::AC, cb = (kk * 16 % C::AC) * 2;
          const uint64_t dq =
              sm90::make_desc(q_wg + a * BQ * C::SW + cb, 16, 8 * C::SW, C::SW);
          const uint64_t dk =
              sm90::make_desc(k_st + a * BK * C::SW + cb, 16, 8 * C::SW, C::SW);
          sm90::mma_ss<BK>(s, dq, dk, kk > 0);
        }
        sm90::commit();
      };
      // O += P·V of the stage over its keys in steps of 16 (one group)
      auto issue_pv = [&](int st) {
        const unsigned char* v_st = kv_s + st * 2 * C::KV_BYTES + C::KV_BYTES;
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          const uint64_t dv =
              sm90::make_desc(v_st + kk * 16 * C::SW, BK * C::SW, 8 * C::SW, C::SW);
          sm90::mma_rs<D>(acc, pa[kk], dv);
        }
        sm90::commit();
      };
      // mask S of key tile kt, then the online softmax: S becomes the
      // unnormalised P (base 2) in place; returns the rescale of O and l
      auto softmax = [&](int kt, float (&corr)[2]) {
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
        // rows lo (e = 0, 1) and hi (e = 2, 3)
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int i = 0; i < BK / 8; ++i) {
          mx[0] = fmaxf(mx[0], fmaxf(s[4 * i], s[4 * i + 1]));
          mx[1] = fmaxf(mx[1], fmaxf(s[4 * i + 2], s[4 * i + 3]));
        }
        float mu[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          const float m_new = fmaxf(m[r], mx[r] * scale_log2);
          mu[r] = m_new == -INFINITY ? 0.f : m_new;  // a row with nothing attended yet
          corr[r] = ex2(m[r] - mu[r]);
          m[r] = m_new;
          l[r] *= corr[r];
        }
#pragma unroll
        for (int i = 0; i < BK / 8; ++i) {
          s[4 * i] = ex2(fmaf(s[4 * i], scale_log2, -mu[0]));
          s[4 * i + 1] = ex2(fmaf(s[4 * i + 1], scale_log2, -mu[0]));
          s[4 * i + 2] = ex2(fmaf(s[4 * i + 2], scale_log2, -mu[1]));
          s[4 * i + 3] = ex2(fmaf(s[4 * i + 3], scale_log2, -mu[1]));
          l[0] += s[4 * i] + s[4 * i + 1];
          l[1] += s[4 * i + 2] + s[4 * i + 3];
        }
      };
      auto pack_p = [&]() {
#pragma unroll
        for (int i = 0; i < BK / 8; ++i) {
          pa[i / 2][(i & 1) * 2] = pack_bf16(s[4 * i], s[4 * i + 1]);
          pa[i / 2][(i & 1) * 2 + 1] = pack_bf16(s[4 * i + 2], s[4 * i + 3]);
        }
      };
      auto rescale = [&](const float (&corr)[2]) {
        // a warp whose rows' maxima all stayed put skips it (corr is exactly 1)
        if (!__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) return;
#pragma unroll
        for (int i = 0; i < D / 8; ++i) {
          acc[4 * i] *= corr[0];
          acc[4 * i + 1] *= corr[0];
          acc[4 * i + 2] *= corr[1];
          acc[4 * i + 3] *= corr[1];
        }
      };
      float corr[2] = {1.f, 1.f};
      if (n_live == 0) mbar_arrive(q_empty);  // Q is not read
      for (int it = 0, kt = span.next(0); it < n_live; ++it, kt = span.next(kt + 1)) {
        const int st = (g0 + it) % S, pst = (g0 + it + S - 1) % S;
        mbar_wait(&full_k[st], ((g0 + it) / S) & 1);
        sm90::fence();
        issue_s(st);
        if (it > 0) {
          mbar_wait(&full_v[pst], ((g0 + it - 1) / S) & 1);
          issue_pv(pst);
        }
        // S_it is done once at most the P·V group is still in flight
        if (it > 0) sm90::wait<1>();
        else sm90::wait<0>();
        sm90::fence_regs(s);
        mbar_arrive(&empty_k[st]);
        if (it + 1 == n_live) mbar_arrive(q_empty);  // the item's last read of Q
        softmax(kt, corr);
        if (it > 0) {
          sm90::wait<0>();
          sm90::fence_regs(acc);
          mbar_arrive(&empty_v[pst]);
          rescale(corr);
        }
        pack_p();
      }
      if (n_live > 0) {  // the last tile's P·V
        const int lst = (g0 + n_live - 1) % S;
        mbar_wait(&full_v[lst], ((g0 + n_live - 1) / S) & 1);
        sm90::fence_regs(acc);
        sm90::fence();
        issue_pv(lst);
        sm90::wait<0>();
        sm90::fence_regs(acc);
        mbar_arrive(&empty_v[lst]);
      }
      g0 += n_live;

      // epilogue: sum l over the quad, L where asked, divide, write bf16
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        const int row = row_lo + 8 * r;
        if (kLse && lane % 4 == 0 && row < sq)
          lse[((long)w.b * hq + w.h) * sq + row] =
              l[r] > 0.f ? (m[r] + log2f(l[r])) * kLn2 : -INFINITY;
        l[r] = 1.f / fmaxf(l[r], 1e-30f);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row_lo + 8 * r;
        if (row < sq) {
          __nv_bfloat16* op = o + (((long)w.b * sq + row) * hq + w.h) * D + col_t;
#pragma unroll
          for (int i = 0; i < D / 8; ++i)
            *reinterpret_cast<uint32_t*>(op + 8 * i) =
                pack_bf16(acc[4 * i + 2 * r] * l[r], acc[4 * i + 2 * r + 1] * l[r]);
        }
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
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int* sched, int b,
                   int sq, int sk, int hq, int hkv, int causal, int window, int sink,
                   int q_offset, float scale, cudaStream_t stream) {
  using C = Cfg<D>;
  const sm90::EncodeTiled enc = sm90::encoder();
  if (enc == nullptr) return cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  if (!make_map(enc, &tq, q, b, sq, hq, D, C::AC, BQ, C::SW) ||
      !make_map(enc, &tk, k, b, sk, hkv, D, C::AC, C::BK, C::SW) ||
      !make_map(enc, &tv, v, b, sk, hkv, D, C::AC, C::BK, C::SW))
    return cudaErrorInvalidValue;
  const auto kern = lse != nullptr ? flash_sm90_kernel<D, true> : flash_sm90_kernel<D, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::bytes);
  if (err != cudaSuccess) return err;
  // setmaxnreg moves registers within the block: the consumers' 232 need the
  // block to start with (128·40 + 256·232) / 384 = 168 a thread, or their
  // setmaxnreg.inc would wait forever; refuse to launch rather than hang
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kern);
  if (err != cudaSuccess) return err;
  if (attr.numRegs < kEntryRegs) return cudaErrorInvalidConfiguration;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  const int n_qt = (sq + BQ - 1) / BQ;
  const int n_items = n_qt * hq * b;
  kern<<<min(n_items, sms), NT, C::bytes, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, sched, b, sq, sk, hq, hkv, n_qt, causal,
      window, sink, q_offset, scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace
}  // namespace h2eal

// sched: 2 int32 on the device, both 0 at a launch (the kernel leaves them so);
// lse: null, or (B, Hq, Sq) f32 for the rows' log-sum-exp
extern "C" int h2eal_flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                                          void* lse, void* sched, int b, int sq, int sk, int hq, int hkv,
                                          int d, int causal, int window, int sink,
                                          int q_offset, float scale, void* stream) {
  using namespace h2eal;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* sc = static_cast<int*>(sched);
  float* ls = static_cast<float*>(lse);
  switch (d) {
    case 32: return launch<32>(q, k, v, o, ls, sc, b, sq, sk, hq, hkv, causal, window, sink, q_offset, scale, st);
    case 64: return launch<64>(q, k, v, o, ls, sc, b, sq, sk, hq, hkv, causal, window, sink, q_offset, scale, st);
    case 80: return launch<80>(q, k, v, o, ls, sc, b, sq, sk, hq, hkv, causal, window, sink, q_offset, scale, st);
    case 128: return launch<128>(q, k, v, o, ls, sc, b, sq, sk, hq, hkv, causal, window, sink, q_offset, scale, st);
    case 256: return launch<256>(q, k, v, o, ls, sc, b, sq, sk, hq, hkv, causal, window, sink, q_offset, scale, st);
    default: return cudaErrorInvalidValue;
  }
}
