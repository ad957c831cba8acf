// One-query decode attention with a validity mask, over a contiguous KV
// buffer or straight from the paged cache through a page table, as a
// split-KV grid that merges its splits in the same launch; or split over
// page stripes, the co-placed decode.
//
// Replaces two TPU kernels of repro/kernels/paged_attention.py, both
// _stream_call's pl.pallas_call at :89:
//   * paged_attention (fn :121). Contract: q (B,Hq,D), and either k/v
//     (B,Hkv,T,D) (ops.paged_attention: the streaming ring, the
//     full-attention baseline) or k/v pages (B,Hkv,C,P,D) with slots
//     (B,Hkv,N) int32 (ops.paged_attention_pages: the retrieval heads'
//     [sink | top-k | local] pages), where token t of the attended buffer is
//     row t % P of page slots[t / P], clamped into [0, C) as
//     ref.gather_pages clamps it; valid (B,Hkv,T) bool with T = N·P in the
//     paged mode; one storage dtype (f32 or bf16). softmax(q·kᵀ/sqrt(D))·v
//     over the valid tokens in f32, output (B,Hq,D) in q's dtype; a row with
//     no valid token returns 0.
//   * paged_attention_partial (fn :152), which each device of the
//     coplace_shmap mesh runs over the pages it owns, and whose partials
//     combine_partials (:211) merges. Here the mesh's 'model' axis is a
//     stripe axis of S splits: stripe s owns the page slots [s·C/S,
//     (s+1)·C/S). Two modes:
//       coplace (ops.paged_attention_coplace): the unsplit slots (B,Hkv,N)
//         and validity (B,Hkv,N·P); each stripe keeps the page pieces whose
//         slot it owns, and the last block of a (batch, kv head) merges the
//         stripes as combine_partials does: output (B,Hq,D) in q's dtype;
//       partials (ops.paged_attention_partial): per-stripe slots (S,B,Hkv,N),
//         -1 where the stripe attends none, and validity (S,B,Hkv,N·P); each
//         block writes its raw (m, l, o) to m, l (S,B,Hq) and o (S,B,Hq,D)
//         f32, (-1e30, 0, 0) for a stripe with no valid token.
//
// Why the gather is inside: the TPU kernel takes a gathered buffer because
// a scalar-prefetched in-kernel gather buys nothing there. On the H100 the
// gather before it was the costlier half of a decode step: its index
// kernels copied every attended page into a new buffer that this kernel
// then read again. A page of P = 32 keys at D = 128 is 8 KB contiguous in
// the cache, so reading it in place costs one bulk copy and no extra bytes.
//
// What bounds it on the H100: bytes. A call reads its K/V rows once (about
// 18 MB for llama3-8b's retrieval heads at B=2 and 4416 attended tokens,
// 68 MB for the full-attention baseline at T=8256) at 4 FLOP per key
// element, far below the card's 295 FLOP/byte balance point. At decode
// batch sizes there are few (batch, kv head) streams (8 in that case), so
// what has to be hidden is latency: by Little's law, 3.35 TB/s over 132 SMs
// at 1-2 us of latency wants 25-50 KB in flight on every SM.
//
// Design. The key axis is cut into units of RK = 32 consecutive tokens of
// the attended buffer. The grid is (split, kv head, batch), one block an SM
// (ops.py::paged_splits: the most splits with B·Hkv·n <= 132 that keep 128
// keys a split); split s owns units [s·U/n, (s+1)·U/n). Split over stripes,
// the grid is (S, kv head, batch) and a stripe's units are those holding a
// page piece whose slot it owns: the producer first reads the whole slot
// list in ceil(N/32) coalesced loads (8 in flight at once), ballots each
// slot's owner into a bitmap (kept in the ring, which is free until the
// first copy), and writes the indices of the units with an owned piece to
// shared memory; the walk below then takes its units from that list, so a
// stripe never waits on the ~N·(S-1)/S slots it does not own. In every
// lane's token a piece the stripe does not own reads as not valid: at
// P < 32 a unit spans pages of several stripes, and each keeps its own.
// A block is one producer warp and NW = 4 consumer warps (2 for f32 at
// D = 256, whose unit's K and V take 64 KB) around a ring of STAGES = NW·SPW
// stages (128 KB: 8 stages of one unit's K and V at bf16 D = 128, 4 at bf16
// D = 256), each with a full and an empty mbarrier:
//   producer: reads the validity bytes and page slots of 8 units at a time
//     (one coalesced load a lane each; the next 8 units' loads fly while
//     these units issue), and for a unit with a valid token
//     waits for its stage to be free and issues one 1-D
//     cp.async.bulk...mbarrier::complete_tx per page piece of the unit for K
//     and one for V (a unit is one page at P = 32; a contiguous unit is one
//     run of rows). A unit with no valid token is never loaded, nor is a
//     piece (page) with none: a sentinel slot (-1, or past C) is invalid in
//     every attended list (paging.token_validity), so it costs no bytes. It
//     writes the unit's validity and loaded-row masks beside the stage;
//     after the last unit, one end marker for each consumer;
//   consumers: warp w takes live units w, w + NW, ... (its SPW stages are its
//     own), with a private f32 online-softmax state (m, l, acc) for every
//     row of the GQA group and no block-wide barrier on the way. A lane owns
//     8 columns of a key row, read in 16-byte loads (one of 8 bf16, or two
//     of 4 f32, one in each half of the row), so a D-wide row is LPK = D / 8
//     lanes (the whole warp at D = 256; at D = 80 the 16 lanes of D = 128,
//     of which the 6 past column 80 load zeros and store nothing) and a
//     warp load covers KPI = 32 / LPK keys: q·k partials for the unit's 32 keys are reduce-scattered over the
//     row's lanes (LPK - 1 shuffles a query row), which leaves each lane the logit of one
//     key; the softmax step is one warp max a row; p goes through the warp's
//     own shared-memory row to the lanes that own the value columns, which
//     accumulate p·v from 16-byte V loads. Rows not loaded read as 0.
// A group above 8 rows (qwen3-moe's 16) is split over two warps that
// consume the same units, each holding 8 rows' q and accumulators, so that
// a lane's registers stay those of a group of 8: the NW warps then form NW/2
// unit streams, and a stage is free once both warps of its stream release it.
// The warps' states merge once, through shared memory, at the end. With
// n = 1 the block divides and writes the output; in the partials mode it
// writes its raw (m, l, o) and ends; otherwise it writes them to scratch
// ((B, Hkv, n, g[, D]), or over stripes the partials' (n, B, Hkv, g[, D])),
// fences and counts itself in on its (batch, kv head) counter; the block that arrives last merges the n partials in split
// order by combine_partials' rule (global max, rescale, sum, divide by
// max(l, 1e-30)) with its loads in flight together, writes the output and
// resets the counter to 0, so the output does not depend on which block ends
// last. A split (or warp) with no valid key contributes the identity
// (NEG_INF, 0, 0). The counters are zeroed once when the wrapper creates
// them, one set per stream; calls on one stream never overlap, so they are
// 0 at a launch.
//
// Numerics: every product and sum is f32 on the FMA units (bf16 widened
// exactly), p is never rounded, so the result differs from the plain
// version on widened inputs by summation order and the output's own
// rounding alone: 2^-8·|plain| + 1e-5 in bf16, 1e-4 in f32; the partials
// are f32 and differ by summation order alone.
//
// Registers (-Xptxas -v): the serving instantiation (bf16, D = 128, a group
// of 4) takes 167 and no instantiation spills but one: f32 at D = 128 with
// a group of 5 to 8, whose 64 q values and 64 accumulators a lane leave too
// little room, spills 56 bytes.
#include "common.cuh"
#include "tma.cuh"

namespace h2eal {
namespace {

using sm90::mbar_arrive;
using sm90::mbar_expect_tx;
using sm90::mbar_init;
using sm90::mbar_wait;
using sm90::smem_u32;

constexpr int RK = 32;             // tokens per unit
constexpr int PF = 8;              // units whose validity and slots the producer reads at once
constexpr int MAXG = 16;           // largest GQA group (qwen3-moe's)
constexpr int WARP_ROWS = 8;       // the most query rows one consumer warp holds
constexpr int RING_BYTES = 128 * 1024;

// how the key axis is split: contiguous unit ranges, merged (paged_attention);
// page stripes of one slot list, merged (coplace); page stripes of per-stripe
// slot lists, raw partials out (partials)
enum Mode { kRange = 0, kCoplace = 1, kPartials = 2 };

constexpr int clampi(int x, int lo, int hi) { return x < lo ? lo : (x > hi ? hi : x); }

// The 8 columns a lane owns of a D-wide row, widened to f32 (zeros where
// !pred), read in 16-byte pieces: 8 bf16 at 8·dg; for f32, 4 at 4·dg in
// each half of the row, so that a warp's loads stay contiguous. col()
// names them.
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  template <int D>
  static __device__ __forceinline__ void load(const float* row, int dg, float (&x)[8],
                                              bool pred) {
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 a = pred ? *reinterpret_cast<const float4*>(row + 4 * dg) : z;
    const float4 b = pred ? *reinterpret_cast<const float4*>(row + D / 2 + 4 * dg) : z;
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
  }
  template <int D>
  static __device__ __forceinline__ int col(int dg, int e) {
    return (e < 4 ? 0 : D / 2 - 4) + 4 * dg + e;
  }
};
template <>
struct Vec<__nv_bfloat16> {
  template <int D>
  static __device__ __forceinline__ void load(const __nv_bfloat16* row, int dg, float (&x)[8],
                                              bool pred) {
    const uint4 u =
        pred ? *reinterpret_cast<const uint4*>(row + 8 * dg) : make_uint4(0u, 0u, 0u, 0u);
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // a bf16 is the high half of its f32
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  template <int D>
  static __device__ __forceinline__ int col(int dg, int e) {
    return 8 * dg + e;
  }
};

template <typename T, int D, int G>
struct Cfg {
  // a warp holds GH rows of the group; above WARP_ROWS the group is split
  // over RW warps that read the same units (each stage is freed by all RW)
  static constexpr int GH = G < WARP_ROWS ? G : WARP_ROWS;
  static constexpr int RW = G / GH;
  static constexpr int VN = 8;              // columns a lane owns of a row
  // the lane layout's row width: D, or at D = 80 (zamba2-2.7b) D = 128's
  // layout with the lanes past column 80 predicated off (their loads read
  // zeros, their columns are never stored), since a key row of 10 lanes
  // would not tile a warp's shuffles
  static constexpr int DP = D <= 32 ? 32 : (D <= 64 ? 64 : (D <= 128 ? 128 : 256));
  static constexpr int LPK = DP / VN;       // lanes of one key row
  static constexpr int KPI = 32 / LPK;      // keys of one warp load
  static constexpr int ROW = D * (int)sizeof(T);
  static constexpr int UNIT = RK * ROW;     // bytes of one unit's K (or V)
  // consumer warps, each owning at least one stage of the ring: 4, but 2
  // where a unit's K and V take 64 KB (f32 at D = 256)
  static constexpr int NW = 2 * UNIT > RING_BYTES / 4 ? 2 : 4;
  static constexpr int NT = 32 * (NW + 1);  // and one producer warp
  static constexpr int NWS = NW / RW;       // unit streams: warps that split a group share one
  static constexpr int SPW = clampi(RING_BYTES / (NW * 2 * UNIT), 1, 4);  // stages a warp
  static constexpr int STAGES = NW * SPW;
  // query rows of one q·k pass: the partial logits s[RB][LPK] stay in registers
  static constexpr int RB = clampi((GH >= 8 ? 32 : 64) / LPK, 1, GH);
  // shared memory: ring | full, empty | stage info | p rows | warp states
  // (each warp's GH rows)
  static constexpr int BARS = STAGES * 2 * UNIT;
  static constexpr int INFO = BARS + 16 * STAGES;
  static constexpr int PS = INFO + 16 * STAGES;    // f32 [NW][GH][32]
  static constexpr int WM = PS + 4 * NW * GH * 32;  // f32 [NW][GH]
  static constexpr int WL = WM + 4 * NW * GH;       // f32 [NW][GH]
  static constexpr int WA = WL + 4 * NW * GH;       // f32 [NW][GH][D]
  static constexpr int bytes = WA + 4 * NW * GH * D;
  static_assert(D % VN == 0 && D <= DP && LPK >= 4 && LPK <= 32 && STAGES % NW == 0,
                "unit layout: whole lanes of VN columns cover D");
  static_assert(G % GH == 0 && NW % RW == 0, "group split");
};

__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Sum v[i] over the N lanes of a key row (lane index idx = lane % N); lane
// idx is left the sum of v[idx]: N - 1 shuffles, half the values each stage
// (the stages are unrolled by recursion, so v stays in registers)
template <int O, int N>
__device__ __forceinline__ void reduce_stage(float (&v)[N], int idx) {
  if constexpr (O >= 1) {
    const bool up = idx & O;
#pragma unroll
    for (int i = 0; i < O; ++i) {
      const float send = up ? v[i] : v[i + O];
      const float keep = up ? v[i + O] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
    }
    reduce_stage<O / 2, N>(v, idx);
  }
}
template <int N>
__device__ __forceinline__ float reduce_scatter(float (&v)[N], int idx) {
  reduce_stage<N / 2, N>(v, idx);
  return v[0];
}

// STRIPES: split over page stripes (the coplace and partials modes), a
// separate instantiation so that the range mode's producer is not slowed by
// the stripes' compaction and owner checks
template <typename T, int D, int G, bool STRIPES>
__global__ void __launch_bounds__((Cfg<T, D, G>::NT), 1) paged_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ slots, const unsigned char* __restrict__ valid, T* __restrict__ o,
    float* __restrict__ part_o, float* __restrict__ part_m, float* __restrict__ part_l,
    int* __restrict__ counters, int hkv, int g, int t_len, int page, int c, long kv_stride,
    int n_split, int mode, float scale) {
  using C = Cfg<T, D, G>;
  constexpr int VN = C::VN, LPK = C::LPK, KPI = C::KPI, STAGES = C::STAGES;
  constexpr int NW = C::NW, NT = C::NT, GH = C::GH, RW = C::RW, NWS = C::NWS;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::BARS);
  uint64_t* empty = full + STAGES;
  int4* info = reinterpret_cast<int4*>(smem + C::INFO);  // unit (-1: end), valid, loaded
  __shared__ int last;

  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long bh = (long)b * hkv + hk;
  const long nbh = (long)gridDim.z * hkv;
  const int n_units = (t_len + RK - 1) / RK;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], RW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == NW) {
    // ---- producer ----
    // this block's slot list and validity: per stripe in the partials mode
    const bool lists = STRIPES && mode == kPartials;
    const long row = lists ? split * nbh + bh : bh;
    const int n_slots = t_len / page;
    const unsigned char* vl = valid + row * t_len;
    const int* sl = slots != nullptr ? slots + row * n_slots : nullptr;
    const T* kb = k + bh * kv_stride;
    const T* vb = v + bh * kv_stride;
    const int c_own = c / n_split;  // slots a stripe owns (coplace)
    auto owns = [&](int slot) {
      return slot >= 0 && (lists || slot / c_own == split);
    };
    // the units this split walks: list positions [0, u_end) of `units`
    // (stripes), or units [u_beg, u_end)
    int* units = reinterpret_cast<int*>(smem + C::bytes);
    int u_beg = 0, u_end = 0;
    if constexpr (STRIPES) {
      // owner bits of every slot, 32 a word, in the ring (free until the
      // first copy); PF words' loads in flight at once
      unsigned* own_bits = reinterpret_cast<unsigned*>(smem);
      const int words = (n_slots + 31) / 32;
      for (int w0 = 0; w0 < words; w0 += PF) {
        int s8[PF];
#pragma unroll
        for (int i = 0; i < PF; ++i) {
          const int j = (w0 + i) * 32 + lane;
          s8[i] = j < n_slots ? sl[j] : -1;
        }
#pragma unroll
        for (int i = 0; i < PF; ++i) {
          const unsigned bits = __ballot_sync(0xffffffffu, owns(s8[i]));
          if (lane == 0 && w0 + i < words) own_bits[w0 + i] = bits;
        }
      }
      __syncwarp();
      // the units with an owned piece (slots [lo, hi] of its tokens), in order
      for (int u0 = 0; u0 < n_units; u0 += 32) {
        const int u = u0 + lane;
        bool own = false;
        if (u < n_units) {
          const int hi = (min(t_len, (u + 1) * RK) - 1) / page;
          for (int i = u * RK / page; i <= hi; ++i) own |= (own_bits[i >> 5] >> (i & 31)) & 1u;
        }
        const unsigned om = __ballot_sync(0xffffffffu, own);
        if (own) units[u_end + __popc(om & ((1u << lane) - 1u))] = u;
        u_end += __popc(om);
      }
      __syncwarp();
      // the bitmap's reads are done before the ring takes its first copy
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    } else {
      u_beg = (int)((long)split * n_units / n_split);
      u_end = (int)((long)(split + 1) * n_units / n_split);
    }
    // this lane's token of the units at positions i0 .. i0 + PF - 1: the
    // unit, its validity and its slot (not yet checked for the owner: that
    // would wait on the loads here, which are to fly while the units before
    // them issue)
    auto fetch = [&](int i0, unsigned char (&ok)[PF], int (&slot)[PF], int (&unit)[PF]) {
#pragma unroll
      for (int i = 0; i < PF; ++i) {
        const bool listed = i0 + i < u_end;
        unit[i] = STRIPES && listed ? units[i0 + i] : i0 + i;
        const int t = unit[i] * RK + lane;
        const bool in = listed && t < t_len;
        ok[i] = in ? vl[t] : 0;
        slot[i] = in && sl != nullptr ? sl[t / page] : t / page;
      }
    };
    unsigned char ok8[PF];
    int slot8[PF], unit8[PF];
    fetch(u_beg, ok8, slot8, unit8);
    int item = 0;
    for (int i0 = u_beg; i0 < u_end; i0 += PF) {
      unsigned char ok_next[PF];  // the next units' loads fly while these issue
      int slot_next[PF], unit_next[PF];
      fetch(i0 + PF, ok_next, slot_next, unit_next);
#pragma unroll
      for (int i = 0; i < PF; ++i) {
        const unsigned okm =
            __ballot_sync(0xffffffffu, ok8[i] != 0 && (!STRIPES || owns(slot8[i])));
        if (okm == 0) continue;  // no valid token: the unit is never loaded
        const int u = STRIPES ? unit8[i] : i0 + i;
        const int t0 = u * RK;
        // this lane's page piece: [p0, p0 + len) of the unit, within one page;
        // its rows are loaded iff one of them is valid
        const bool in = t0 + lane < t_len;
        const int p0 = max(0, lane - (t0 + lane) % page);
        const int len = min(min(page - (t0 + p0) % page, RK - p0), t_len - t0 - p0);
        const unsigned bits =
            in ? (len >= 32 ? 0xffffffffu : ((1u << len) - 1u)) << p0 : 0u;
        const bool row_ld = (okm & bits) != 0u;
        const unsigned ldm = __ballot_sync(0xffffffffu, row_ld);
        const int st = item % STAGES;
        if (lane == 0) {
          mbar_wait(&empty[st], ((item / STAGES) & 1) ^ 1);
          info[st] = make_int4(u, (int)okm, (int)ldm, 0);
          mbar_expect_tx(&full[st], 2u * __popc(ldm) * C::ROW);
        }
        __syncwarp();
        if (row_ld && lane == p0) {
          const int slot = sl != nullptr ? min(max(slot8[i], 0), c - 1) : slot8[i];
          const long src = ((long)slot * page + (t0 + p0) % page) * D;
          unsigned char* dst = smem + st * 2 * C::UNIT + p0 * C::ROW;
          bulk_load(dst, kb + src, len * C::ROW, &full[st]);
          bulk_load(dst + C::UNIT, vb + src, len * C::ROW, &full[st]);
        }
        ++item;
      }
#pragma unroll
      for (int i = 0; i < PF; ++i) {
        ok8[i] = ok_next[i];
        slot8[i] = slot_next[i];
        unit8[i] = unit_next[i];
      }
    }
    for (int w = 0; w < NWS; ++w, ++item) {  // one end marker a unit stream
      const int st = item % STAGES;
      if (lane == 0) {
        mbar_wait(&empty[st], ((item / STAGES) & 1) ^ 1);
        info[st].x = -1;
        mbar_arrive(&full[st]);
      }
    }
  } else {
    // ---- consumers: unit stream ws = warp / RW owns stages ws, ws + NWS,
    // ...; its RW warps hold the group's rows [h·GH, (h+1)·GH) each ----
    const int ws = warp / RW, r_lo = (warp % RW) * GH;
    const int dg = lane % LPK, ko = lane / LPK;
    const int kj = dg * KPI + ko;  // the key whose logit this lane holds after the reduce
    const bool cols = dg * VN < D;  // the lane's columns lie in the row (all but at D = 80)
    float qr[GH][VN], acc[GH][VN], m[GH], ls[GH];
#pragma unroll
    for (int r = 0; r < GH; ++r) {
      Vec<T>::template load<D>(q + (bh * g + r_lo + r) * D, dg, qr[r], cols && r_lo + r < g);
      m[r] = kNegInf;
      ls[r] = 0.f;
#pragma unroll
      for (int e = 0; e < VN; ++e) acc[r][e] = 0.f;
    }
    float* ps = reinterpret_cast<float*>(smem + C::PS) + warp * GH * 32;
    for (int it = ws;; it += NWS) {
      const int st = it % STAGES;
      mbar_wait(&full[st], (it / STAGES) & 1);
      const int4 inf = info[st];
      if (inf.x < 0) break;
      const unsigned okm = inf.y, ldm = inf.z;
      const T* ks = reinterpret_cast<const T*>(smem + st * 2 * C::UNIT);
      const T* vs = ks + RK * D;

      // logits: lane (dg, ko) forms partials of keys i·KPI + ko over its columns
      float sv[GH];
#pragma unroll
      for (int r0 = 0; r0 < GH; r0 += C::RB) {
        float s[C::RB][LPK];
#pragma unroll
        for (int i = 0; i < LPK; ++i) {
          const int j = i * KPI + ko;
          float kx[VN];
          Vec<T>::template load<D>(ks + j * D, dg, kx, cols && ((ldm >> j) & 1u));
#pragma unroll
          for (int r = 0; r < C::RB; ++r) {
            float a = 0.f;
#pragma unroll
            for (int e = 0; e < VN; ++e) a = fmaf(qr[r0 + r][e], kx[e], a);
            s[r][i] = a;
          }
        }
#pragma unroll
        for (int r = 0; r < C::RB; ++r) sv[r0 + r] = reduce_scatter<LPK>(s[r], dg);
      }
      // online softmax: one key a lane, one warp max a row
      const bool ok = (okm >> kj) & 1u;
#pragma unroll
      for (int r = 0; r < GH; ++r) {
        const float sr = ok ? sv[r] * scale : kNegInf;
        const float m_new = fmaxf(m[r], warp_max(sr));
        const float corr = expf(m[r] - m_new);
        const float p = ok ? expf(sr - m_new) : 0.f;
        ls[r] = fmaf(ls[r], corr, p);
        m[r] = m_new;
        ps[r * 32 + lane] = p;
#pragma unroll
        for (int e = 0; e < VN; ++e) acc[r][e] *= corr;
      }
      __syncwarp();
      // p·v: lane (dg, ko) accumulates its columns over keys i·KPI + ko
#pragma unroll
      for (int i = 0; i < LPK; i += 4) {
        float vx[4][VN];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
          const int j = (i + ii) * KPI + ko;
          Vec<T>::template load<D>(vs + j * D, dg, vx[ii], cols && ((ldm >> j) & 1u));
        }
#pragma unroll
        for (int r = 0; r < GH; ++r) {
          const float4 p4 = *reinterpret_cast<const float4*>(ps + r * 32 + ko * LPK + i);
          const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
          for (int ii = 0; ii < 4; ++ii)
#pragma unroll
            for (int e = 0; e < VN; ++e) acc[r][e] = fmaf(pv[ii], vx[ii][e], acc[r][e]);
        }
      }
      __syncwarp();  // p rows read; the stage is free
      if (lane == 0) mbar_arrive(&empty[st]);
    }

    // the warp's state: l summed over lanes, acc over the KPI key lanes
    float* wm = reinterpret_cast<float*>(smem + C::WM);
    float* wl = reinterpret_cast<float*>(smem + C::WL);
    float* wa = reinterpret_cast<float*>(smem + C::WA);
#pragma unroll
    for (int r = 0; r < GH; ++r) {
      const float l = warp_sum(ls[r]);
#pragma unroll
      for (int x = LPK; x < 32; x *= 2)
#pragma unroll
        for (int e = 0; e < VN; ++e) acc[r][e] += __shfl_xor_sync(0xffffffffu, acc[r][e], x);
      if (lane == 0) {
        wm[warp * GH + r] = m[r];
        wl[warp * GH + r] = l;
      }
      if (ko == 0 && cols) {
#pragma unroll
        for (int e = 0; e < VN; e += 4)
          *reinterpret_cast<float4*>(wa + (warp * GH + r) * D + Vec<T>::template col<D>(dg, e)) =
              make_float4(acc[r][e], acc[r][e + 1], acc[r][e + 2], acc[r][e + 3]);
      }
    }
  }
  __syncthreads();

  // the block's state: the warps' merged in warp order (of a row, the
  // warps that hold it)
  const float* wm = reinterpret_cast<const float*>(smem + C::WM);
  const float* wl = reinterpret_cast<const float*>(smem + C::WL);
  const float* wa = reinterpret_cast<const float*>(smem + C::WA);
  T* ob = o + bh * g * D;
  // the partials' rows: (n, B, Hkv, g) over stripes, the partials mode's
  // layout; (B, Hkv, n, g) over unit ranges
  const long base = STRIPES ? bh * g : bh * n_split * g;  // split 0's rows
  const long s_rows = STRIPES ? nbh * g : g;               // from one split to the next
  const long pbase = base + split * s_rows;
  const bool partials = STRIPES && mode == kPartials;
  const bool divide = n_split == 1 && !partials;
  for (int idx = tid; idx < g * D; idx += NT) {
    const int r = idx / D, d = idx % D;
    const int h = r / GH, rr = r % GH;
    float mg = kNegInf;
#pragma unroll
    for (int w = 0; w < NW; ++w)
      if (w % RW == h) mg = fmaxf(mg, wm[w * GH + rr]);
    float lg = 0.f, og = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      if (w % RW != h) continue;
      const float cw = expf(wm[w * GH + rr] - mg);
      lg = fmaf(wl[w * GH + rr], cw, lg);
      og = fmaf(wa[(w * GH + rr) * D + d], cw, og);
    }
    if (divide) {
      store(&ob[idx], og / fmaxf(lg, 1e-30f));
    } else {
      part_o[pbase * D + idx] = og;
      if (d == 0) {
        part_m[pbase + r] = mg;
        part_l[pbase + r] = lg;
      }
    }
  }
  if (divide || partials) return;
  __threadfence();  // the partial is visible device-wide before the count
  __syncthreads();
  if (tid == 0) {
    const int prev = atomicAdd(&counters[bh], 1);
    last = prev == n_split - 1;
    if (last) counters[bh] = 0;  // ready for the next launch
  }
  __syncthreads();
  if (!last) return;
  __threadfence();  // see every other split's partial

  // merge the n partials in split order, every load in flight at once: each
  // thread's o partials (of the first MAXS splits in registers, the rest
  // later), and m, l into shared memory (the ring is free) for the weights
  constexpr int COLS = (G * D / 4 + NT - 1) / NT;  // float4 columns of o a thread
  constexpr int MAXS = 16 / COLS;
  float* mt = reinterpret_cast<float*>(smem);  // [n][g] m
  float* lt = mt + n_split * g;                // [n][g] l
  float* mx = lt + n_split * g;                // [g] max, [g] 1 / l
  const float4* src = reinterpret_cast<const float4*>(part_o + base * D);
  const long s_stride = s_rows * D / 4;        // float4s from one split's partial to the next
  float4 x[COLS][MAXS];
#pragma unroll
  for (int cc = 0; cc < COLS; ++cc) {
    const int idx = tid + cc * NT;
#pragma unroll
    for (int s = 0; s < MAXS; ++s)
      x[cc][s] = idx < g * D / 4 && s < n_split ? __ldcg(src + s * s_stride + idx)
                                                : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int i = tid; i < n_split * g; i += NT) {
    const long at = STRIPES ? base + (i / g) * s_rows + i % g : base + i;
    mt[i] = __ldcg(&part_m[at]);
    lt[i] = __ldcg(&part_l[at]);
  }
  __syncthreads();
  if (tid < g) {
    float mg = kNegInf;
    for (int s = 0; s < n_split; ++s) mg = fmaxf(mg, mt[s * g + tid]);
    float lg = 0.f;
    for (int s = 0; s < n_split; ++s) lg = fmaf(lt[s * g + tid], expf(mt[s * g + tid] - mg), lg);
    mx[tid] = mg;
    mx[g + tid] = 1.f / fmaxf(lg, 1e-30f);
  }
  __syncthreads();
#pragma unroll
  for (int cc = 0; cc < COLS; ++cc) {
    const int idx = tid + cc * NT;
    if (idx >= g * D / 4) break;
    const int r = idx * 4 / D;
    const float mg = mx[r];
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    auto add = [&](const float4& o4, int s) {
      const float w = expf(mt[s * g + r] - mg);
      a.x = fmaf(o4.x, w, a.x);
      a.y = fmaf(o4.y, w, a.y);
      a.z = fmaf(o4.z, w, a.z);
      a.w = fmaf(o4.w, w, a.w);
    };
#pragma unroll
    for (int s = 0; s < MAXS; ++s)
      if (s < n_split) add(x[cc][s], s);
    for (int s = MAXS; s < n_split; ++s) add(__ldcg(src + s * s_stride + idx), s);
    const float il = mx[g + r];
    T* dst = ob + idx * 4;
    store(dst, a.x * il);
    store(dst + 1, a.y * il);
    store(dst + 2, a.z * il);
    store(dst + 3, a.w * il);
  }
}

}  // namespace

// one launch's operands (see h2eal_paged_attention); outside the anonymous
// namespace, since the parts of the build hand it from one object to another
struct PagedArgs {
  const void *q, *k, *v, *slots, *valid;
  void* o;
  float *po, *pm, *pl;
  int* counters;
  int b, hkv, g, t_len, page, c;
  long kv_stride;
  int n_split, mode;
  float scale;
  cudaStream_t stream;
};

// The instantiations of one dtype and one split kind (over unit ranges, or
// over page stripes), for every head_dim, and the groups up to 8 (parts
// 0-3) or the group of 16 (parts 4-7): each is one part of the build
// (kernels/_build.py PARTS compiles this file once a part, with
// -DH2EAL_PART=0..7, all at once; one nvcc took 120 s for the 64 kernels of
// groups up to 8 on the H100 host, the other sources at most 12 s).
// Compiled without H2EAL_PART, the file holds all eight.
cudaError_t paged_f32_range(const PagedArgs& a, int d);
cudaError_t paged_f32_stripes(const PagedArgs& a, int d);
cudaError_t paged_bf16_range(const PagedArgs& a, int d);
cudaError_t paged_bf16_stripes(const PagedArgs& a, int d);
cudaError_t paged_f32_range_g16(const PagedArgs& a, int d);
cudaError_t paged_f32_stripes_g16(const PagedArgs& a, int d);
cudaError_t paged_bf16_range_g16(const PagedArgs& a, int d);
cudaError_t paged_bf16_stripes_g16(const PagedArgs& a, int d);

namespace {

template <typename T, int D, int G, bool STRIPES>
cudaError_t launch(const PagedArgs& a) {
  using C = Cfg<T, D, G>;
  // the last block's merge keeps 2·n·g + 2·g floats in the ring, and a
  // stripe's compaction one owner bit a slot
  if ((2 * a.n_split + 2) * a.g * 4 > C::STAGES * 2 * C::UNIT) return cudaErrorInvalidValue;
  if (STRIPES && (a.t_len / a.page + 31) / 32 * 4 > C::STAGES * 2 * C::UNIT)
    return cudaErrorInvalidValue;
  // a stripe's unit list follows the fixed layout
  const int bytes = C::bytes + (STRIPES ? 4 * ((a.t_len + RK - 1) / RK) : 0);
  cudaError_t err = cudaFuncSetAttribute(paged_kernel<T, D, G, STRIPES>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.n_split, a.hkv, a.b);
  paged_kernel<T, D, G, STRIPES><<<grid, C::NT, bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const int*>(a.slots), static_cast<const unsigned char*>(a.valid),
      static_cast<T*>(a.o), a.po, a.pm, a.pl, a.counters, a.hkv, a.g, a.t_len, a.page, a.c,
      a.kv_stride, a.n_split, a.mode, a.scale);
  return cudaGetLastError();
}

// G16: the group of 16 (above 8), else the groups up to 8
template <typename T, int D, bool STRIPES, bool G16>
cudaError_t dispatch_g(const PagedArgs& a) {
  if constexpr (G16) {
    return launch<T, D, 16, STRIPES>(a);
  } else {
    if (a.g <= 1) return launch<T, D, 1, STRIPES>(a);
    if (a.g <= 2) return launch<T, D, 2, STRIPES>(a);
    if (a.g <= 4) return launch<T, D, 4, STRIPES>(a);
    return launch<T, D, 8, STRIPES>(a);
  }
}

template <typename T, bool STRIPES, bool G16 = false>
cudaError_t dispatch_d(int d, const PagedArgs& a) {
  switch (d) {
    case 32: return dispatch_g<T, 32, STRIPES, G16>(a);
    case 64: return dispatch_g<T, 64, STRIPES, G16>(a);
    case 80: return dispatch_g<T, 80, STRIPES, G16>(a);
    case 128: return dispatch_g<T, 128, STRIPES, G16>(a);
    case 256: return dispatch_g<T, 256, STRIPES, G16>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

#ifndef H2EAL_PART
#define H2EAL_PART -1
#endif
#if H2EAL_PART < 0 || H2EAL_PART == 0
cudaError_t paged_f32_range(const PagedArgs& a, int d) { return dispatch_d<float, false>(d, a); }
#endif
#if H2EAL_PART < 0 || H2EAL_PART == 1
cudaError_t paged_f32_stripes(const PagedArgs& a, int d) { return dispatch_d<float, true>(d, a); }
#endif
#if H2EAL_PART < 0 || H2EAL_PART == 2
cudaError_t paged_bf16_range(const PagedArgs& a, int d) {
  return dispatch_d<__nv_bfloat16, false>(d, a);
}
#endif
#if H2EAL_PART < 0 || H2EAL_PART == 3
cudaError_t paged_bf16_stripes(const PagedArgs& a, int d) {
  return dispatch_d<__nv_bfloat16, true>(d, a);
}
#endif
#if H2EAL_PART < 0 || H2EAL_PART == 4
cudaError_t paged_f32_range_g16(const PagedArgs& a, int d) {
  return dispatch_d<float, false, true>(d, a);
}
#endif
#if H2EAL_PART < 0 || H2EAL_PART == 5
cudaError_t paged_f32_stripes_g16(const PagedArgs& a, int d) {
  return dispatch_d<float, true, true>(d, a);
}
#endif
#if H2EAL_PART < 0 || H2EAL_PART == 6
cudaError_t paged_bf16_range_g16(const PagedArgs& a, int d) {
  return dispatch_d<__nv_bfloat16, false, true>(d, a);
}
#endif
#if H2EAL_PART < 0 || H2EAL_PART == 7
cudaError_t paged_bf16_stripes_g16(const PagedArgs& a, int d) {
  return dispatch_d<__nv_bfloat16, true, true>(d, a);
}
#endif

}  // namespace h2eal

#if H2EAL_PART < 0 || H2EAL_PART == 0
// slots: (B, Hkv, t_len / page) int32 page table ((S, B, Hkv, t_len / page)
// in the partials mode), or null for a contiguous (B, Hkv, t_len, D) k/v
// (then page = 32; range mode only); valid: (B, Hkv, t_len) bool ((S, B,
// Hkv, t_len) in the partials mode); kv_stride: elements of k/v per (batch,
// kv head). mode: 0 range, 1 coplace, 2 partials (see the note at the top);
// n_split: the splits, or the stripes S (c a multiple of S in the coplace
// mode). part_o (B, Hkv, n_split, g, D), part_m / part_l (B, Hkv, n_split,
// g) in the range mode, (n_split, B, Hkv, g[, D]) over stripes: f32
// scratch of the merge (unused when n_split == 1 outside the partials
// mode), the outputs in the partials mode (o unused then); counters:
// >= B·Hkv int32, all 0. Every pointer is 16-byte aligned.
extern "C" int h2eal_paged_attention(const void* q, const void* k, const void* v,
                                     const void* slots, const void* valid, void* o,
                                     void* part_o, void* part_m, void* part_l, void* counters,
                                     int dtype, int b, int hkv, int g, int d, int t_len,
                                     int page, int c, long long kv_stride, int n_split,
                                     int mode, float scale, void* stream) {
  using namespace h2eal;
  if (g < 1 || g > MAXG || n_split < 1 || page < 1 || c < 1 || mode < kRange ||
      mode > kPartials)
    return cudaErrorInvalidValue;
  if (mode != kRange && (slots == nullptr || (mode == kCoplace && c % n_split != 0)))
    return cudaErrorInvalidValue;
  const PagedArgs a{q, k, v, slots, valid, o,
                    static_cast<float*>(part_o), static_cast<float*>(part_m),
                    static_cast<float*>(part_l), static_cast<int*>(counters),
                    b, hkv, g, t_len, page, c, static_cast<long>(kv_stride), n_split, mode,
                    scale, static_cast<cudaStream_t>(stream)};
  const bool stripes = mode != kRange;
  if (g > 8) {
    if (dtype == kF32) return stripes ? paged_f32_stripes_g16(a, d) : paged_f32_range_g16(a, d);
    if (dtype == kBF16)
      return stripes ? paged_bf16_stripes_g16(a, d) : paged_bf16_range_g16(a, d);
    return cudaErrorInvalidValue;
  }
  if (dtype == kF32) return stripes ? paged_f32_stripes(a, d) : paged_f32_range(a, d);
  if (dtype == kBF16) return stripes ? paged_bf16_stripes(a, d) : paged_bf16_range(a, d);
  return cudaErrorInvalidValue;
}
#endif
