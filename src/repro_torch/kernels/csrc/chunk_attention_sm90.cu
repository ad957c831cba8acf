// Chunked-prefill attention in bf16 on Hopper's tensor cores: one chunk of
// queries per slot over a KV buffer.
//
// Replaces, for bf16 operands, the two TPU kernels of
// repro/kernels/chunk_attention.py; ops.py routes by dtype, and f32
// operands keep the FMA kernels of chunk_attention.cu (TF32 tensor cores
// would not hold f32's 1e-4 tolerance, and the serving path is bf16):
//   chunk_attention        (the pl.pallas_call at :107): q (B,Cq,Hq,D) over
//                          k/v (B,Hkv,T,D) with a validity mask per query,
//                          valid (B,Hkv,Cq,T) bool;
//   chunk_attention_paged  (the pl.pallas_call at :213): q over the
//                          pre-append paged cache k/v_pages (B,Hr,C,P,D), a
//                          cached key counting iff its page is written
//                          (page_start >= 0) and its position is below the
//                          slot's start, then over the chunk's own keys
//                          k/v_new (B,Cq,Hr,D) under the causal triangle
//                          (key j for query c iff j <= c).
// Same contracts: f32 logits, online softmax and accumulation, the output
// rounded once to bf16; a row with no valid key returns 0 (the
// max(l, 1e-30) guard), never NaN. D in {32, 64, 80, 128, 256}, group g <= 64.
//
// What bounds them on the H100: operations. At the engine's chunk shapes
// (4 slots at contexts 0/2048/5120/7680, chunk 512, 4 retrieval kv heads
// of group 4, D = 128) chunk_attention_paged does 6.7e10 FLOP, 0.067 ms at
// the 989 TFLOP/s bf16 tensor-core peak; the f32 FMA units (67 TFLOP/s)
// could not go below 1 ms. chunk_attention's streaming heads attend only
// sink + local keys of their 804-key buffer, so its bound is the bytes of
// q, k, v, the mask and the output.
//
// Design (the pattern of flash_attention_sm90.cu). One block of three
// warpgroups per (q tile, kv head, slot). A q tile is BQ = 64 rows
// r = c·g + gi of one kv head: npos = 64 / g whole chunk positions of its g
// query heads (at g = 3, 21 positions fill 63 rows; the last row is zeros
// and never stored). Warpgroup 0 is the producer: it gives up registers
// (setmaxnreg), one thread loads the q tile once by TMA (a 4-D box
// {64 columns, g heads, npos positions, 1} over q viewed as {D, Hq, Cq, B},
// which lands the rows in the c·g + gi order), then it keeps K and V tiles
// of BK = 128 keys (64 at D = 256) in flight through a ring of STAGES
// buffers with full and empty mbarriers. Warpgroups 1 and 2 are consumers of the SAME 64 q
// rows: they take the block's key tiles in turns (even and odd ring
// items), each keeping its own (m, l, O). Flash gives each consumer its own
// 64 rows (128 rows a block); at 64 rows a block a slot that prefills alone
// (chunk 512, group 4, 4 retrieval heads) makes 32 x 4 = 128 blocks for
// 132 SMs instead of 64. Splitting the keys inside the block, rather than
// across blocks, needs no partials in device memory and no second pass:
// after the last tile the two consumers merge (m, l, O) through the ring's
// buffers. Each consumer runs, per tile:
//   S = Q·Kᵀ: wgmma m64nBKk16, Q and K read from shared memory K-major
//     through descriptors of the 128-byte swizzle TMA wrote (64-byte at
//     D = 32, 32-byte at D = 80), f32 accumulators in registers;
//   online softmax on the accumulator fragment (two rows a thread, max and
//     sum over the 4 threads of a quad), with a mask only where the tile
//     needs one;
//   O += P·V: the unnormalised P, rounded to bf16 in registers, is wgmma's
//     register A operand, V the shared-memory B operand read transposed.
// A consumer releases a ring stage (128 arrivals) after the P·V that read
// it has completed.
//
// Which keys a block walks. Before the warpgroups split, the whole block
// marks each BK-key tile of the buffer as skipped, full (every key valid
// for every row: no mask) or masked, in shared memory, so that producer
// and consumers walk the same list of live tiles:
//   chunk_attention: from the validity bytes of the tile's positions (a
//     tile is live if any row has a valid key in it; a streaming head
//     attends sink + local keys, so most tiles are skipped). valid's row
//     stride is T bytes (804 on the main path), no multiple of 16, so TMA
//     cannot read it: for a masked tile the producer's threads read the
//     bytes (4 a lane where T % 4 == 0, four loads in flight a lane) and
//     pack a bit per (position, key) beside the stage, which the consumers
//     test; they do so after the tile's TMA is issued, so the two overlap.
//     These byte reads, not the products, set this kernel's time: a block
//     of a streaming head has only a few live tiles.
//   chunk_attention_paged: from page_start and start, counting the keys of
//     a tile below start on written pages (pages may lie in any order, as
//     coplace_shmap's striped appends leave them; the mask is per key, as
//     every cached key precedes every chunk query). A masked tile's bits
//     (one per key, the same for all rows) are packed by the producer.
//     The cache tiles are BK-key TMA boxes over the pages viewed as
//     {D, C·P, Hr, B}; at start 0 no page is read at all. Then the chunk's
//     own keys up to the q tile's last position, boxes over k_new viewed as
//     {D, Hr, Cq, B}, masked causally where a tile crosses the diagonal.
//
// Numerics and tolerance (as flash_attention_sm90.cu): products are exact
// bf16 x bf16 in f32, sums f32. The one rounding the plain version on
// f32-widened inputs does not make is P to bf16 before P·V. Each
// p = exp(s - m_running) lies in [0, 1]; rounding to nearest bf16 moves it
// by at most 2^-8·p, so a consumer's O moves by at most 2^-8·Σ p|v|, and
// after the merge (each half's O and l scaled by exp(m_half - m) <= 1, then
// divided by l) the output moves by at most 2^-8·Σ p|v| / l =
// 2^-8·(softmax(s)·|V|), on top of the output's own rounding (2^-8·|out|).
// So the kernels are held to |kernel - plain| <= 2^-8·(softmax(s)·|V|) +
// 2^-8·|plain| + 1e-5 (chip_smoke.py::check_chunk, ::check_chunk_paged;
// tests/test_torch_cuda.py; a CPU emulation in
// tests/test_torch_kernel_design.py).
#include <cuda.h>

#include "common.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace h2eal {
namespace {

using sm90::mbar_add_tx;
using sm90::mbar_arrive;
using sm90::mbar_expect_tx;
using sm90::mbar_init;
using sm90::mbar_wait;
using sm90::pack_bf16;
using sm90::tma_load_4d;

constexpr int BQ = 64;   // q rows per block, shared by both consumers
constexpr int NCWG = 2;  // consumer warpgroups
constexpr int NT = 128 * (NCWG + 1);
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kEntryRegs = (128 * kProducerRegs + NCWG * 128 * kConsumerRegs) / NT;
constexpr int kLive = 1, kMasked = 2;     // tile flags

template <int D>
struct Cfg {
  // keys per ring stage: 64 at D = 256, where one stage of 128 keys' K and V
  // (128 KB) leaves no room for a second
  static constexpr int BK = D == 256 ? 64 : 128;
  static constexpr int WPR = BK / 32;             // mask words of one position's keys
  static constexpr int kMaskWords = BQ * WPR;     // a bit per (position, key): 64 positions at most
  // swizzle span = bytes of an atom row: the widest of 128, 64 and 32 whose
  // atoms tile D exactly (32 at D = 80: five atoms of 16 columns)
  static constexpr int SW = D % 64 == 0 ? 128 : (D % 32 == 0 ? 64 : 32);
  static constexpr int AC = SW / 2;               // bf16 columns of one swizzle atom
  static constexpr int NA = D / AC;               // atoms across D
  static_assert(D % AC == 0 && D % 16 == 0, "the atoms and the k16 steps tile D");
  static constexpr int STAGES = D == 256 ? 2 : (D == 128 ? 3 : 4);
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;     // one K or V tile
  static constexpr int BAR_BYTES = 8 * (1 + 2 * STAGES);
  // then one int of flags a key tile
  static constexpr int fixed =
      1024 + Q_BYTES + STAGES * (2 * KV_BYTES + kMaskWords * 4) + BAR_BYTES;
};

struct Args {
  __nv_bfloat16* o;
  const unsigned char* valid;  // chunk_attention: (B, Hkv, Cq, T)
  const int* page_start;       // chunk_attention_paged: (B, Hr, C)
  const int* start;            // chunk_attention_paged: (B,)
  int nb, cq, hkv, g, npos, n_qt;
  int n_keys;  // T, or C·P
  int page;    // P (paged)
  int aligned4;  // valid's rows may be read 4 bytes at a time
  float scale_log2;
};

// the validity bytes of keys col .. col + 3 of a row, zero from key n on:
// one 4-byte load where rows are 4-byte aligned (then n % 4 == 0, so
// col < n means col + 3 < n)
__device__ __forceinline__ uint32_t valid_word(const unsigned char* row, int col, int n,
                                               bool aligned4) {
  if (aligned4) return col < n ? *reinterpret_cast<const uint32_t*>(row + col) : 0u;
  uint32_t x = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (col + e < n) x |= static_cast<uint32_t>(row[col + e]) << (8 * e);
  return x;
}
// bit e: byte e of the word is set
__device__ __forceinline__ uint32_t nibble(uint32_t x) {
  x = __vcmpne4(x, 0u);
  return (x & 1u) | (x >> 7 & 2u) | (x >> 14 & 4u) | (x >> 21 & 8u);
}
constexpr int kBatch = 4;  // validity loads a lane keeps in flight

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(NCWG * 128) : "memory");
}

// One key tile of a consumer's online softmax over its 64 rows: S = Q·Kᵀ,
// masked by ok(hi, i, col) where need_mask (hi: the thread's upper row; col:
// the key within the tile, in its 8-key chunk i), then rescale and O += P·V.
template <int D, typename Ok>
__device__ __forceinline__ void attend(const unsigned char* q_s, const unsigned char* k_st,
                                       const unsigned char* v_st, float (&acc)[D / 2],
                                       float (&m)[2], float (&l)[2], float scale_log2,
                                       int col_t, bool need_mask, Ok ok) {
  using C = Cfg<D>;
  constexpr int BK = C::BK;
  float s[BK / 2];
  sm90::fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int a = kk * 16 / C::AC, cb = (kk * 16 % C::AC) * 2;
    const uint64_t dq = sm90::make_desc(q_s + a * BQ * C::SW + cb, 16, 8 * C::SW, C::SW);
    const uint64_t dk = sm90::make_desc(k_st + a * BK * C::SW + cb, 16, 8 * C::SW, C::SW);
    sm90::mma_ss<BK>(s, dq, dk, kk > 0);
  }
  sm90::commit();
  sm90::wait<0>();
  sm90::fence_regs(s);

  if (need_mask) {
#pragma unroll
    for (int i = 0; i < BK / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (!ok(e >> 1, i, 8 * i + col_t + (e & 1))) s[4 * i + e] = -INFINITY;
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
    const uint64_t dv = sm90::make_desc(v_st + kk * 16 * C::SW, BK * C::SW, 8 * C::SW, C::SW);
    sm90::mma_rs<D>(acc, pa[kk], dv);
  }
  sm90::commit();
  sm90::wait<0>();
  sm90::fence_regs(acc);
}

// grid: n_qt · Hkv · B blocks, the last q tiles (most chunk keys) first
template <int D, bool PAGED>
__global__ void __launch_bounds__(NT, 1) chunk_sm90_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tkn,
    const __grid_constant__ CUtensorMap tvn, const Args args) {
  using C = Cfg<D>;
  constexpr int BK = C::BK, kMaskWords = C::kMaskWords, WPR = C::WPR;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* q_s = base;                                // [NA][BQ][AC]
  unsigned char* kv_s = base + C::Q_BYTES;                  // [STAGES][K|V][NA][BK][AC]
  uint32_t* mask_s = reinterpret_cast<uint32_t*>(kv_s + 2 * C::STAGES * C::KV_BYTES);
  uint64_t* bars = reinterpret_cast<uint64_t*>(mask_s + C::STAGES * kMaskWords);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + C::STAGES;
  int* flags = reinterpret_cast<int*>(bars + 1 + 2 * C::STAGES);  // [n_tiles]

  const int g = args.g, cq = args.cq, hkv = args.hkv;
  const int hb = hkv * args.nb;
  const int qt = args.n_qt - 1 - static_cast<int>(blockIdx.x) / hb;
  const int hk = static_cast<int>(blockIdx.x) % hb % hkv;
  const int b = static_cast<int>(blockIdx.x) % hb / hkv;
  const int c_lo = qt * args.npos;
  const int npos = min(args.npos, cq - c_lo);  // positions of the tile inside the chunk
  const int box_rows = g * args.npos;          // rows the q box fills; the rest are zeros
  const long bh = (long)b * hkv + hk;
  const int tid = threadIdx.x;

  // keys the block may walk: a slot at start 0 reads no page
  int st_b = 0, n_tiles;
  if constexpr (PAGED) {
    st_b = args.start[b];
    n_tiles = st_b > 0 ? (args.n_keys + BK - 1) / BK : 0;
  } else {
    n_tiles = (args.n_keys + BK - 1) / BK;
  }

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 128);   // the producer warpgroup
      mbar_init(&empty[s], 128);  // the consumer warpgroup of the stage's item
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(q_full, D * 2 * box_rows);
#pragma unroll
    for (int a = 0; a < C::NA; ++a)
      tma_load_4d(q_s + a * BQ * C::SW, &tq, q_full, a * C::AC, hk * g, c_lo, b);
  }
  // q rows past the box (64 % g of them) are zeros, read by the tensor
  // cores through the async proxy
  for (int i = tid; i < C::NA * (BQ - box_rows) * C::SW / 16; i += NT) {
    const int per = (BQ - box_rows) * C::SW / 16;
    reinterpret_cast<uint4*>(q_s + (i / per) * BQ * C::SW + box_rows * C::SW)[i % per] =
        make_uint4(0, 0, 0, 0);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");

  // mark the key tiles: skipped, full or masked
  if constexpr (PAGED) {
    const int* ps = args.page_start + bh * (args.n_keys / args.page);
    for (int kt = tid; kt < n_tiles; kt += NT) {
      const int k0 = kt * BK, k1 = min(k0 + BK, args.n_keys);
      int cnt = 0;
      for (int pg = k0 / args.page; pg * args.page < k1; ++pg) {
        const int s0 = ps[pg];
        if (s0 < 0) continue;
        // the page's first nv keys lie below start
        const int nv = min(max(st_b - s0, 0), args.page);
        cnt += max(0, min(pg * args.page + nv, k1) - max(pg * args.page, k0));
      }
      flags[kt] = cnt == 0 ? 0 : (cnt == BK ? kLive : kLive | kMasked);
    }
  } else {
    for (int kt = tid; kt < n_tiles; kt += NT) flags[kt] = 0;
    __syncthreads();
    // a warp reads one position's BK bytes of a tile a load (4 a lane; at
    // BK = 64 the upper half of the warp idles), kBatch loads in flight
    const unsigned char* vl = args.valid + (bh * cq + c_lo) * args.n_keys;
    const int warp = tid / 32, lane = tid % 32, n_items = n_tiles * npos;
    constexpr int NW = NT / 32;
    for (int it0 = warp; it0 < n_items; it0 += kBatch * NW) {
      uint32_t x[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int it = it0 + u * NW;
        x[u] = it < n_items && 4 * lane < BK
                   ? valid_word(vl + (long)(it % npos) * args.n_keys, it / npos * BK + 4 * lane,
                                args.n_keys, args.aligned4)
                   : 0u;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int it = it0 + u * NW;
        const uint32_t nib = nibble(x[u]);
        const bool any = __any_sync(0xffffffffu, nib != 0);
        const bool all = __all_sync(0xffffffffu, nib == 0xFu || 4 * lane >= BK);
        if (lane == 0 && it < n_items && (any || !all))
          atomicOr(&flags[it / npos], (any ? kLive : 0) | (all ? 0 : kMasked));
      }
    }
  }
  __syncthreads();

  const int wg = tid / 128;
  if (wg == 0) {
    // ---- producer: one thread issues TMA, the warpgroup packs masks; all
    // 128 threads arrive on a stage's full barrier ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const int t = tid, warp = t / 32, lane = t % 32;
    int it = 0;
    for (int kt = 0; kt < n_tiles; ++kt) {
      const int f = flags[kt];
      if (!(f & kLive)) continue;
      const int st = it % C::STAGES;
      mbar_wait(&empty[st], ((it / C::STAGES) & 1) ^ 1);
      // the tile's loads first, then its mask while they fly
      unsigned char* k_st = kv_s + st * 2 * C::KV_BYTES;
      if (t == 0) {
        mbar_add_tx(&full[st], 2 * C::KV_BYTES);
#pragma unroll
        for (int a = 0; a < C::NA; ++a) {
          tma_load_4d(k_st + a * BK * C::SW, &tk, &full[st], a * C::AC, kt * BK, hk, b);
          tma_load_4d(k_st + C::KV_BYTES + a * BK * C::SW, &tv, &full[st], a * C::AC, kt * BK,
                      hk, b);
        }
      }
      uint32_t* mk = mask_s + st * kMaskWords;
      if (f & kMasked) {
        if constexpr (PAGED) {
          // word w: keys 32w .. 32w + 31 of the tile, the same for every row
          const int key = kt * BK + t;
          bool ok = false;
          if (t < BK && key < args.n_keys) {
            const int s0 = args.page_start[bh * (args.n_keys / args.page) + key / args.page];
            ok = s0 >= 0 && s0 + key % args.page < st_b;
          }
          const uint32_t w = __ballot_sync(0xffffffffu, ok);
          if (lane == 0 && warp < WPR) mk[warp] = w;
        } else {
          // word WPR·pi + w: keys 32w .. 32w + 31 for position c_lo + pi; a
          // lane reads 4 keys and the 8 lanes of a word gather their nibbles
          const unsigned char* vl = args.valid + (bh * cq + c_lo) * args.n_keys;
          const int rows_pos = (BQ - 1) / g + 1;
          for (int pi0 = warp; pi0 < rows_pos; pi0 += 4 * kBatch) {
            uint32_t x[kBatch];
#pragma unroll
            for (int u = 0; u < kBatch; ++u) {
              const int pi = pi0 + 4 * u;
              x[u] = pi < npos && 4 * lane < BK
                         ? valid_word(vl + (long)pi * args.n_keys, kt * BK + 4 * lane,
                                      args.n_keys, args.aligned4)
                         : 0u;
            }
#pragma unroll
            for (int u = 0; u < kBatch; ++u) {
              const int pi = pi0 + 4 * u;
              uint32_t w = nibble(x[u]) << (4 * (lane & 7));
              w |= __shfl_xor_sync(0xffffffffu, w, 1);
              w |= __shfl_xor_sync(0xffffffffu, w, 2);
              w |= __shfl_xor_sync(0xffffffffu, w, 4);
              if ((lane & 7) == 0 && pi < rows_pos && 4 * lane < BK) mk[WPR * pi + lane / 8] = w;
            }
          }
        }
      }
      mbar_arrive(&full[st]);  // this thread's mask words are written
      ++it;
    }
    if constexpr (PAGED) {
      // the chunk's own keys up to the tile's last position
      const int n_jt = (c_lo + npos - 1) / BK + 1;
      for (int jt = 0; jt < n_jt; ++jt) {
        const int st = it % C::STAGES;
        mbar_wait(&empty[st], ((it / C::STAGES) & 1) ^ 1);
        unsigned char* k_st = kv_s + st * 2 * C::KV_BYTES;
        if (t == 0) {
          mbar_add_tx(&full[st], 2 * C::KV_BYTES);
#pragma unroll
          for (int a = 0; a < C::NA; ++a) {
            tma_load_4d(k_st + a * BK * C::SW, &tkn, &full[st], a * C::AC, hk, jt * BK, b);
            tma_load_4d(k_st + C::KV_BYTES + a * BK * C::SW, &tvn, &full[st], a * C::AC, hk,
                        jt * BK, b);
          }
        }
        mbar_arrive(&full[st]);
        ++it;
      }
    }
  } else {
    // ---- consumers: the same 64 q rows, alternate key tiles ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int cw = wg - 1;
    const int t = tid % 128, warp = t / 32, lane = t % 32;
    const int r_lo = 16 * warp + lane / 4;  // and r_lo + 8
    const int col_t = 2 * (lane % 4);
    const int pi_row[2] = {r_lo / g, (r_lo + 8) / g};  // positions within the tile

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

    mbar_wait(q_full, 0);
    int it = 0;
    for (int kt = 0; kt < n_tiles; ++kt) {
      const int f = flags[kt];
      if (!(f & kLive)) continue;
      if ((it & 1) == cw) {
        const int st = it % C::STAGES;
        mbar_wait(&full[st], (it / C::STAGES) & 1);
        const unsigned char* k_st = kv_s + st * 2 * C::KV_BYTES;
        const uint32_t* mk = mask_s + st * kMaskWords;
        uint32_t w[2][WPR];
        if (f & kMasked) {
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int j = 0; j < WPR; ++j) w[r][j] = mk[(PAGED ? 0 : WPR * pi_row[r]) + j];
        }
        attend<D>(q_s, k_st, k_st + C::KV_BYTES, acc, m, l, args.scale_log2, col_t,
                  (f & kMasked) != 0,
                  [&](int hi, int i, int col) { return (w[hi][i >> 2] >> (col & 31)) & 1u; });
        mbar_arrive(&empty[st]);
      }
      ++it;
    }
    if constexpr (PAGED) {
      const int n_jt = (c_lo + npos - 1) / BK + 1;
      const int pos[2] = {c_lo + pi_row[0], c_lo + pi_row[1]};
      for (int jt = 0; jt < n_jt; ++jt) {
        if ((it & 1) == cw) {
          const int st = it % C::STAGES;
          mbar_wait(&full[st], (it / C::STAGES) & 1);
          const unsigned char* k_st = kv_s + st * 2 * C::KV_BYTES;
          const int j0 = jt * BK;
          // keys past every row's position (and past Cq, which TMA zero-fills)
          attend<D>(q_s, k_st, k_st + C::KV_BYTES, acc, m, l, args.scale_log2, col_t,
                    j0 + BK - 1 > c_lo, [&](int hi, int, int col) { return j0 + col <= pos[hi]; });
          mbar_arrive(&empty[st]);
        }
        ++it;
      }
    }

    // merge the two consumers' (m, l, O) through the ring, free once both
    // have finished their last tile; consumer 0 writes the output
    consumers_sync();
    float* mb = reinterpret_cast<float*>(kv_s);  // [D/2 + 4][128]
    if (cw == 1) {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) mb[i * 128 + t] = acc[i];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mb[(D / 2 + r) * 128 + t] = m[r];
        mb[(D / 2 + 2 + r) * 128 + t] = l[r];
      }
    }
    consumers_sync();
    if (cw == 0) {
      float f0[2], f1[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m1 = mb[(D / 2 + r) * 128 + t], l1 = mb[(D / 2 + 2 + r) * 128 + t];
        const float mt = fmaxf(m[r], m1);
        const float mu = mt == -INFINITY ? 0.f : mt;
        f0[r] = exp2f(m[r] - mu);
        f1[r] = exp2f(m1 - mu);
        l[r] = l[r] * f0[r] + l1 * f1[r];
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) {
        const int r = (i >> 1) & 1;
        acc[i] = acc[i] * f0[r] + mb[i * 128 + t] * f1[r];
      }
      // epilogue: sum l over the quad, divide, write bf16
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        l[r] = 1.f / fmaxf(l[r], 1e-30f);
      }
      const int hq = hkv * g;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int pi = pi_row[r], gi = (r_lo + 8 * r) % g;
        if (pi < npos) {
          __nv_bfloat16* op =
              args.o + (((long)b * cq + c_lo + pi) * hq + hk * g + gi) * D + col_t;
#pragma unroll
          for (int i = 0; i < D / 8; ++i)
            *reinterpret_cast<uint32_t*>(op + 8 * i) =
                pack_bf16(acc[4 * i + 2 * r] * l[r], acc[4 * i + 2 * r + 1] * l[r]);
        }
      }
    }
  }
}

template <int D, bool PAGED>
cudaError_t launch(Args a, const void* q, const void* k, const void* v, const void* kn,
                   const void* vn, int n_heads_kv, cudaStream_t stream) {
  using C = Cfg<D>;
  const sm90::EncodeTiled enc = sm90::encoder();
  if (enc == nullptr) return cudaErrorNotSupported;
  CUtensorMap tq, tk, tv, tkn, tvn;
  // q (B, Cq, Hq, D): a box is npos positions of the kv head's g q heads;
  // k/v (B, H, keys, D): a box is BK keys of one head
  const int hq = a.hkv * a.g;
  if (!sm90::make_map_4d(enc, &tq, q, {D, hq, a.cq, a.nb}, {C::AC, a.g, a.npos, 1}, C::SW) ||
      !sm90::make_map_4d(enc, &tk, k, {D, a.n_keys, n_heads_kv, a.nb}, {C::AC, C::BK, 1, 1},
                         C::SW) ||
      !sm90::make_map_4d(enc, &tv, v, {D, a.n_keys, n_heads_kv, a.nb}, {C::AC, C::BK, 1, 1},
                         C::SW))
    return cudaErrorInvalidValue;
  tkn = tk;
  tvn = tv;
  // k/v_new (B, Cq, Hr, D): a box is BK chunk positions of one head
  if (PAGED && (!sm90::make_map_4d(enc, &tkn, kn, {D, a.hkv, a.cq, a.nb}, {C::AC, 1, C::BK, 1},
                                   C::SW) ||
                !sm90::make_map_4d(enc, &tvn, vn, {D, a.hkv, a.cq, a.nb}, {C::AC, 1, C::BK, 1},
                                   C::SW)))
    return cudaErrorInvalidValue;
  const int bytes = C::fixed + 4 * ((a.n_keys + C::BK - 1) / C::BK);
  cudaError_t err = cudaFuncSetAttribute(
      chunk_sm90_kernel<D, PAGED>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  // setmaxnreg moves registers within the block: the consumers' 232 need the
  // block to start with (128·40 + 256·232) / 384 = 168 a thread, or their
  // setmaxnreg.inc would wait forever; refuse to launch rather than hang
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, chunk_sm90_kernel<D, PAGED>);
  if (err != cudaSuccess) return err;
  if (attr.numRegs < kEntryRegs) return cudaErrorInvalidConfiguration;
  chunk_sm90_kernel<D, PAGED><<<a.n_qt * a.hkv * a.nb, NT, bytes, stream>>>(tq, tk, tv, tkn,
                                                                            tvn, a);
  return cudaGetLastError();
}

template <bool PAGED>
cudaError_t launch_d(int d, const Args& a, const void* q, const void* k, const void* v,
                     const void* kn, const void* vn, int n_heads_kv, cudaStream_t s) {
  switch (d) {
    case 32: return launch<32, PAGED>(a, q, k, v, kn, vn, n_heads_kv, s);
    case 64: return launch<64, PAGED>(a, q, k, v, kn, vn, n_heads_kv, s);
    case 80: return launch<80, PAGED>(a, q, k, v, kn, vn, n_heads_kv, s);
    case 128: return launch<128, PAGED>(a, q, k, v, kn, vn, n_heads_kv, s);
    case 256: return launch<256, PAGED>(a, q, k, v, kn, vn, n_heads_kv, s);
    default: return cudaErrorInvalidValue;
  }
}

Args make_args(void* o, int b, int cq, int hkv, int g, int n_keys, float scale) {
  Args a{};
  a.o = static_cast<__nv_bfloat16*>(o);
  a.nb = b;
  a.cq = cq;
  a.hkv = hkv;
  a.g = g;
  a.npos = BQ / g;
  a.n_qt = (cq + a.npos - 1) / a.npos;
  a.n_keys = n_keys;
  a.scale_log2 = scale * kLog2e;
  return a;
}

}  // namespace
}  // namespace h2eal

extern "C" int h2eal_chunk_attention_bf16(const void* q, const void* k, const void* v,
                                          const void* valid, void* o, int b, int cq, int hkv,
                                          int t_len, int g, int d, float scale, void* stream) {
  using namespace h2eal;
  if (g < 1 || g > BQ || cq < 1 || t_len < 1) return cudaErrorInvalidValue;
  Args a = make_args(o, b, cq, hkv, g, t_len, scale);
  a.valid = static_cast<const unsigned char*>(valid);
  a.aligned4 = t_len % 4 == 0 && reinterpret_cast<uintptr_t>(valid) % 4 == 0;
  return launch_d<false>(d, a, q, k, v, nullptr, nullptr, hkv,
                         static_cast<cudaStream_t>(stream));
}

extern "C" int h2eal_chunk_attention_paged_bf16(const void* q, const void* kp, const void* vp,
                                                const void* page_start, const void* start,
                                                const void* kn, const void* vn, void* o, int b,
                                                int cq, int hr, int n_pages, int page, int g,
                                                int d, float scale, void* stream) {
  using namespace h2eal;
  if (g < 1 || g > BQ || cq < 1 || n_pages < 1 || page < 1) return cudaErrorInvalidValue;
  Args a = make_args(o, b, cq, hr, g, n_pages * page, scale);
  a.page_start = static_cast<const int*>(page_start);
  a.start = static_cast<const int*>(start);
  a.page = page;
  return launch_d<true>(d, a, q, kp, vp, kn, vn, hr, static_cast<cudaStream_t>(stream));
}
