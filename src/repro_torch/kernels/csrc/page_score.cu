// Quest page score, and a retrieval layer's whole select step built on it.
//
// Replaces the TPU kernel repro/kernels/page_score.py::page_score (the
// pl.pallas_call at :46). Two modes of one source:
//
// Scores mode (h2eal_page_score), the TPU kernel's contract: q (B,Hq,D) in
// f32 or bf16, tau_min and tau_max (B,Hkv,C,D) f32 -> scores (B,Hkv,C) f32,
//   score = Σ_{g in group} Σ_d relu(q_gd)·τmax_d + min(q_gd, 0)·τmin_d,
// the upper bound on any key's logit in the page. Nothing is masked: an
// empty page holds τ = ±inf and scores NaN, as the reference's does. One
// block of 8 warps per (tile of 32 pages, kv head, batch); every lane keeps
// its D/32 coordinates of the group's query rows, split into positive and
// negative parts, in registers (room for 8 rows, or 16 above a group of 8:
// qwen3-moe's, 128 floats a lane at D = 128; at D = 80 the lanes of
// D = 128, 20 of them holding columns); a warp scores a page with one load
// of each τ row and a shuffle sum.
//
// Select mode (h2eal_page_select): what core/paging's score_pages ->
// select_pages -> accumulate_importance and the share-window keep compute
// for one decode step (ref.page_select_ref), in one launch:
//   selectable(p) = page_start[p] >= 0 and
//                   n_sink <= page_start[p] / P < max(ctx - local, 0) / P,
//   score(p)      = the scores mode's sum where selectable, else NEG_INF,
//   sel           = the min(K, C) largest scores by (score descending, slot
//                   ascending), exactly torch.sort(stable=True) and
//                   lax.top_k; padded with -1 to K; with minus_one_masked
//                   (the coplace_shmap layout), -1 where score <= -5e29,
//   imp           = imp_prev + (score > -5e29 ? score : 0),
// and where need[b] is false the row's sel_prev and imp_prev are copied
// and no τ is read. ctx is read from the card (a (B,) tensor) or passed as
// an int. The outputs are new tensors: the caller's old selection stays.
//
// What bounds it on the H100. Bytes: τ of the selectable pages (1 KB a
// page at D=128; 4.2 MB at the engine's 16 rows of 258 pages, 1.2 µs at
// 3.35 TB/s), page_start, imp in and out, a few KB more. But there are only
// B·Hkv rows (8-16 on the main paths) for 132 SMs, and a top-k is a chain
// of block-wide steps, so latency bounds it: the τ loads' round trips and
// the selection's barriers. What the design does:
//   * Only the selectable pages are read: a warp loads 32 page starts at
//     once, ballots the selectable ones and scores them four at a time
//     (their τ loads in flight together, 16 bytes a lane).
//   * A thread-block cluster of n blocks per row (n = 8 on the main path)
//     spreads a row's pages over n SMs: block r scores the pages
//     [r·C/n, (r+1)·C/n), writes their importance, and stores their keys
//     into the leader block's shared memory through distributed shared
//     memory; after a cluster barrier the leader alone selects.
//   * Keys: the score's bits made order-preserving as an unsigned 32-bit
//     key (-0.0 taken as +0.0). Masked pages carry NEG_INF's key, so they
//     fill after every selectable page, in slot order, as torch.sort
//     places equal NEG_INF scores. NaN cannot reach a key: empty pages are
//     masked before they are scored. Joined with the complemented slot,
//     (key << 32 | ~slot) is unique, and its K largest are the stable
//     top-k.
//   * Selection without a sort of C, in few barriers (each costs the
//     whole block): a radix select of the K-th largest 32-bit key T in four
//     passes of 8-bit digits (the block's histogram in shared memory, then
//     warp 0 alone picks the digit; the bins double-buffered, so two
//     barriers a pass), leaving n_gt keys above T and K - n_gt to take
//     among those equal to it; then one ordered pass compacts the winners:
//     every key above T, and the first K - n_gt equal to T in slot order
//     (ballot ranks, so equal keys take the lower slots, which is the
//     64-bit key's order); then each winner's place in the output is the
//     count of winners whose 64-bit key is larger: K compares a winner on
//     broadcast reads and no barrier (a bitonic sort of 128 would take 28
//     barriers).
// A row's keys live in the leader's shared memory: C <= 16384 pages (64 KB
// of keys) and K <= 1024 winners, which the wrapper checks.
#include <cooperative_groups.h>

#include "common.cuh"

namespace h2eal {
namespace {

namespace cg = cooperative_groups;

constexpr int NW = 8;
constexpr int THREADS = NW * 32;
constexpr int PAGES_PER_WARP = 4;
constexpr int BC = NW * PAGES_PER_WARP;
constexpr int MAXG = 16;  // qwen3-moe's group; a lane holds GR = 8 or 16 rows
constexpr int MAX_PAGES = 16384;
constexpr int MAX_K = 1024;
constexpr int MAX_CLUSTER = 8;  // the portable cluster size
constexpr float kNegInfHalf = -5e29f;

// A lane's coordinates of a D-wide row: DL = DP / 32 consecutive ones, DP
// the layout's width: D, or at D = 80 (zamba2-2.7b) D = 128's layout with
// the lanes past column 80 predicated off (they hold zeros), since 80 / 32
// coordinates a lane would drop 16 columns
template <int D>
struct Lanes {
  static constexpr int DP = D <= 32 ? 32 : (D <= 64 ? 64 : (D <= 128 ? 128 : 256));
  static constexpr int DL = DP / 32;
  static_assert(D % DL == 0 && D <= DP, "whole lanes of DL coordinates cover D");
  static __device__ __forceinline__ bool on(int lane) { return lane * DL < D; }
};

// the lane's coordinates of the group's g query rows, split into positive
// and negative parts
template <typename T, int D, int GR>
__device__ __forceinline__ void load_q(const T* qb, int g, int lane,
                                       float (&qp)[GR][Lanes<D>::DL],
                                       float (&qn)[GR][Lanes<D>::DL]) {
  constexpr int DL = Lanes<D>::DL;
  const bool on = Lanes<D>::on(lane);
#pragma unroll
  for (int r = 0; r < GR; ++r)
#pragma unroll
    for (int e = 0; e < DL; ++e) {
      const float x = r < g && on ? to_f32(qb[(long)r * D + lane * DL + e]) : 0.f;
      qp[r][e] = fmaxf(x, 0.f);
      qn[r][e] = fminf(x, 0.f);
    }
}

// one lane's share of a page's score; warp_sum of it is the score. Both
// modes use it, so they score a page alike
template <int DL, int GR>
__device__ __forceinline__ float lane_dot(const float (&qp)[GR][DL], const float (&qn)[GR][DL],
                                          const float (&tmin)[DL], const float (&tmax)[DL],
                                          int g) {
  float part = 0.f;
#pragma unroll
  for (int r = 0; r < GR; ++r) {
    if (r >= g) break;
#pragma unroll
    for (int e = 0; e < DL; ++e) {
      part = fmaf(qp[r][e], tmax[e], part);
      part = fmaf(qn[r][e], tmin[e], part);
    }
  }
  return part;
}

template <typename T, int D, int GR>
__global__ void __launch_bounds__(THREADS) score_kernel(
    const T* __restrict__ q, const float* __restrict__ tau_min,
    const float* __restrict__ tau_max, float* __restrict__ out, int hkv, int c, int g) {
  constexpr int DL = Lanes<D>::DL;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const bool on = Lanes<D>::on(lane);
  const long bh = (long)b * hkv + hk;

  float qp[GR][DL], qn[GR][DL];
  load_q<T, D, GR>(q + bh * g * D, g, lane, qp, qn);

#pragma unroll
  for (int i = 0; i < PAGES_PER_WARP; ++i) {
    const int p = blockIdx.x * BC + warp * PAGES_PER_WARP + i;
    if (p >= c) break;
    const float* tn = tau_min + (bh * c + p) * D + lane * DL;
    const float* tx = tau_max + (bh * c + p) * D + lane * DL;
    float tmin[DL], tmax[DL];
#pragma unroll
    for (int e = 0; e < DL; ++e) {
      tmin[e] = on ? tn[e] : 0.f;
      tmax[e] = on ? tx[e] : 0.f;
    }
    const float s = warp_sum(lane_dot<DL, GR>(qp, qn, tmin, tmax, g));
    if (lane == 0) out[bh * c + p] = s;
  }
}

// ---------------------------------------------------------------------------
// Select mode
// ---------------------------------------------------------------------------

struct SelectArgs {
  const void* q;
  const float* tau_min;
  const float* tau_max;
  const int* page_start;
  const int* ctx;  // (B,) or null: ctx_all for every row
  int ctx_all;
  const int* sel_prev;
  const float* imp_prev;
  const unsigned char* need;  // (B,) bool or null: every row
  int* sel;
  float* imp;
  int hkv, c, g, n_sink, local, page, top_k, minus_one_masked;
};

// an τ row's DL coordinates of this lane, in 16-byte loads where they allow;
// zeros where the lane lies past the row (off)
template <int DL>
__device__ __forceinline__ void load_row(const float* p, float (&v)[DL], bool on) {
  if (!on) {
#pragma unroll
    for (int e = 0; e < DL; ++e) v[e] = 0.f;
  } else if constexpr (DL == 8) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p));
    const float4 y = __ldg(reinterpret_cast<const float4*>(p) + 1);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
    v[4] = y.x; v[5] = y.y; v[6] = y.z; v[7] = y.w;
  } else if constexpr (DL == 4) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else if constexpr (DL == 2) {
    const float2 x = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = x.x; v[1] = x.y;
  } else {
    v[0] = __ldg(p);
  }
}

// order-preserving: a > b as floats iff key(a) > key(b) as unsigned;
// -0.0 takes +0.0's key
__device__ __forceinline__ unsigned order_key(float s) {
  const unsigned u = __float_as_uint(s == 0.f ? 0.f : s);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_score(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// the unique 64-bit key: score key, then the complemented slot, so the
// larger of two equal scores is the lower slot
__device__ __forceinline__ unsigned long long slot_key(unsigned key, int slot) {
  return ((unsigned long long)key << 32) | (unsigned)~slot;
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The leader's selection over the row's C keys: sel (K) of the row.
__device__ void select_row(const SelectArgs& a, const unsigned* keys,
                           unsigned long long* win, int* sel) {
  __shared__ unsigned hist[2][256];
  __shared__ unsigned cnt[2 * NW];
  __shared__ unsigned pick[2];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = a.c;
  const unsigned k = min(a.top_k, c);

  // radix select: the k-th largest key thr, and how many keys equal to it
  // the top k take (want); the other k - want lie above it. A pass: the
  // block's histogram of the next 8-bit digit of the keys that match the
  // digits picked so far, then warp 0 picks the digit where the count from
  // the top reaches want. Two barriers a pass: the bins are double-buffered
  hist[0][tid] = 0;
  unsigned prefix = 0, mask = 0, want = k;
  __syncthreads();
  for (int pass = 0; pass < 4; ++pass) {
    const int shift = 24 - 8 * pass;
    unsigned* h = hist[pass & 1];
    hist[(pass + 1) & 1][tid] = 0;
    for (int p = tid; p < c; p += THREADS) {
      const unsigned key = keys[p];
      if ((key & mask) == prefix) atomicAdd(&h[(key >> shift) & 255u], 1u);
    }
    __syncthreads();
    if (warp == 0) {  // lane l: the digits 255 - 8l down to 248 - 8l
      unsigned v[8], sum = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        v[i] = h[255 - 8 * lane - i];
        sum += v[i];
      }
      unsigned run = sum;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned y = __shfl_up_sync(0xffffffffu, run, o);
        if (lane >= o) run += y;
      }
      run -= sum;  // the count of keys in the digits above this lane's
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (run < want && want <= run + v[i]) {
          pick[0] = 255 - 8 * lane - i;
          pick[1] = want - run;
        }
        run += v[i];
      }
    }
    __syncthreads();
    prefix |= pick[0] << shift;
    mask |= 255u << shift;
    want = pick[1];
  }
  const unsigned thr = prefix, n_gt = k - want;

  // compaction in slot order: keys above thr to [0, n_gt), the first want
  // keys equal to thr to [n_gt, k)
  unsigned base_gt = 0, base_eq = 0;
  const unsigned below = (1u << lane) - 1;
  for (int p0 = 0; p0 < c && (base_gt < n_gt || base_eq < want); p0 += THREADS) {
    const int p = p0 + tid;
    const unsigned key = p < c ? keys[p] : 0u;
    const bool gt = p < c && key > thr, eq = p < c && key == thr;
    const unsigned bgt = __ballot_sync(0xffffffffu, gt), beq = __ballot_sync(0xffffffffu, eq);
    if (lane == 0) {
      cnt[warp] = __popc(bgt);
      cnt[NW + warp] = __popc(beq);
    }
    __syncthreads();
    unsigned og = base_gt + __popc(bgt & below), oe = base_eq + __popc(beq & below);
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      if (w < warp) {
        og += cnt[w];
        oe += cnt[NW + w];
      }
      base_gt += cnt[w];
      base_eq += cnt[NW + w];
    }
    if (gt) win[og] = slot_key(key, p);
    if (eq && oe < want) win[n_gt + oe] = slot_key(key, p);
    __syncthreads();
  }

  // the winners in descending 64-bit key order: each one's place is the
  // count of winners above it (the keys are unique), k compares a winner
  // on broadcast reads, no barrier
  for (int i = tid; i < (int)k; i += THREADS) {
    const unsigned long long w = win[i];
    int rank = 0;
    for (int j = 0; j < (int)k; ++j) rank += win[j] > w;
    int v = (int)~(unsigned)w;
    if (a.minus_one_masked && key_score((unsigned)(w >> 32)) <= kNegInfHalf) v = -1;
    sel[rank] = v;
  }
  for (int j = k + tid; j < a.top_k; j += THREADS) sel[j] = -1;
}

// grid (n, Hkv, B), clusters of (n, 1, 1): block r of a cluster scores the
// pages [r·C/n, (r+1)·C/n) of row (b, hk); block 0 selects
template <typename T, int D, int GR>
__global__ void __launch_bounds__(THREADS) select_kernel(const SelectArgs a) {
  constexpr int DL = Lanes<D>::DL;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned* keys = reinterpret_cast<unsigned*>(smem);  // C: scores, then keys
  unsigned long long* win =
      reinterpret_cast<unsigned long long*>(smem + (((size_t)a.c * 4 + 15) & ~(size_t)15));
  const int n = gridDim.x, rank = blockIdx.x;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = a.c;
  const long row = (long)b * a.hkv + hk;
  const int beg = (int)((long)rank * c / n), end = (int)((long)(rank + 1) * c / n);
  const float* imp_prev = a.imp_prev + row * c;
  float* imp = a.imp + row * c;

  if (a.need && !a.need[b]) {  // every block of the cluster takes this branch
    for (int p = beg + tid; p < end; p += THREADS) imp[p] = imp_prev[p];
    if (rank == 0)
      for (int j = tid; j < a.top_k; j += THREADS)
        a.sel[row * a.top_k + j] = a.sel_prev[row * a.top_k + j];
    return;
  }
  cluster_arrive_relaxed();  // waited on before the first remote store

  // warp w scores the selectable pages of its share of [beg, end), found 32
  // page starts at a time, four pages' τ loads in flight together. The
  // loads that wait on nothing go out first, together: this warp's first
  // page starts, this thread's first importance, ctx, q
  const int per = (end - beg + NW - 1) / NW;
  const int wb = beg + warp * per, we = min(end, wb + per);
  const int* ps_row = a.page_start + row * c;
  int ps = wb + lane < we ? ps_row[wb + lane] : -1;
  const float imp_first = beg + tid < end ? imp_prev[beg + tid] : 0.f;
  const int ctx = a.ctx ? a.ctx[b] : a.ctx_all;
  float qp[GR][DL], qn[GR][DL];
  load_q<T, D, GR>(static_cast<const T*>(a.q) + row * a.g * D, a.g, lane, qp, qn);
  const int first_local = max(ctx - a.local, 0) / a.page;
  for (int p0 = wb; p0 < we; p0 += 32) {
    const int p = p0 + lane;
    if (p0 > wb) ps = p < we ? ps_row[p] : -1;
    const bool ok = ps >= 0 && ps / a.page >= a.n_sink && ps / a.page < first_local;
    if (p < we && !ok) keys[p] = __float_as_uint(kNegInf);
    unsigned todo = __ballot_sync(0xffffffffu, ok);
    while (todo) {
      int pg[PAGES_PER_WARP];
      float tmin[PAGES_PER_WARP][DL], tmax[PAGES_PER_WARP][DL];
#pragma unroll
      for (int j = 0; j < PAGES_PER_WARP; ++j) {
        pg[j] = -1;
        if (todo) {
          pg[j] = p0 + __ffs(todo) - 1;
          todo &= todo - 1;
          const long off = (row * c + pg[j]) * D + lane * DL;
          load_row<DL>(a.tau_min + off, tmin[j], Lanes<D>::on(lane));
          load_row<DL>(a.tau_max + off, tmax[j], Lanes<D>::on(lane));
        }
      }
#pragma unroll
      for (int j = 0; j < PAGES_PER_WARP; ++j) {
        if (pg[j] < 0) break;
        const float s = warp_sum(lane_dot<DL, GR>(qp, qn, tmin[j], tmax[j], a.g));
        if (lane == 0) keys[pg[j]] = __float_as_uint(s);
      }
    }
  }
  __syncthreads();

  // the slice's importance, and its keys into the leader's shared memory
  cluster_wait();  // every block of the cluster has started
  unsigned* lead = cg::this_cluster().map_shared_rank(keys, 0);
  for (int p = beg + tid; p < end; p += THREADS) {
    const float s = __uint_as_float(keys[p]);
    imp[p] = (p == beg + tid ? imp_first : imp_prev[p]) + (s > kNegInfHalf ? s : 0.f);
    lead[p] = order_key(s);
  }
  cluster_arrive();
  cluster_wait();  // the row's keys are in the leader's shared memory
  if (rank != 0) return;
  select_row(a, keys, win, a.sel + row * a.top_k);
}

template <typename T, int D, int GR>
cudaError_t launch_score(const void* q, const void* tau_min, const void* tau_max, void* out,
                         int b, int hkv, int c, int g, cudaStream_t stream) {
  const dim3 grid((c + BC - 1) / BC, hkv, b);
  score_kernel<T, D, GR><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const float*>(tau_min),
      static_cast<const float*>(tau_max), static_cast<float*>(out), hkv, c, g);
  return cudaGetLastError();
}

template <typename T, int D, int GR>
cudaError_t launch_select(const SelectArgs& a, int b, int blocks, cudaStream_t stream) {
  const size_t smem = (((size_t)a.c * 4 + 15) & ~(size_t)15) +
                      (size_t)(a.top_k < a.c ? a.top_k : a.c) * 8;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        select_kernel<T, D, GR>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, a.hkv, b);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, select_kernel<T, D, GR>, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// the lane's rows of q: 8 up to a group of 8; 16 above (at D = 128 the
// group's q takes 128 registers a lane, the serving instantiation's)
template <typename T, int GR>
cudaError_t dispatch_score_g(int d, const void* q, const void* tau_min, const void* tau_max,
                             void* out, int b, int hkv, int c, int g, cudaStream_t stream) {
  switch (d) {
    case 32: return launch_score<T, 32, GR>(q, tau_min, tau_max, out, b, hkv, c, g, stream);
    case 64: return launch_score<T, 64, GR>(q, tau_min, tau_max, out, b, hkv, c, g, stream);
    case 80: return launch_score<T, 80, GR>(q, tau_min, tau_max, out, b, hkv, c, g, stream);
    case 128: return launch_score<T, 128, GR>(q, tau_min, tau_max, out, b, hkv, c, g, stream);
    case 256: return launch_score<T, 256, GR>(q, tau_min, tau_max, out, b, hkv, c, g, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_score(int d, const void* q, const void* tau_min, const void* tau_max,
                           void* out, int b, int hkv, int c, int g, cudaStream_t stream) {
  return g <= 8 ? dispatch_score_g<T, 8>(d, q, tau_min, tau_max, out, b, hkv, c, g, stream)
                : dispatch_score_g<T, 16>(d, q, tau_min, tau_max, out, b, hkv, c, g, stream);
}

template <typename T, int GR>
cudaError_t dispatch_select_g(int d, const SelectArgs& a, int b, int blocks,
                              cudaStream_t stream) {
  switch (d) {
    case 32: return launch_select<T, 32, GR>(a, b, blocks, stream);
    case 64: return launch_select<T, 64, GR>(a, b, blocks, stream);
    case 80: return launch_select<T, 80, GR>(a, b, blocks, stream);
    case 128: return launch_select<T, 128, GR>(a, b, blocks, stream);
    case 256: return launch_select<T, 256, GR>(a, b, blocks, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_select(int d, const SelectArgs& a, int b, int blocks,
                            cudaStream_t stream) {
  return a.g <= 8 ? dispatch_select_g<T, 8>(d, a, b, blocks, stream)
                  : dispatch_select_g<T, 16>(d, a, b, blocks, stream);
}

}  // namespace
}  // namespace h2eal

extern "C" int h2eal_page_score(const void* q, const void* tau_min, const void* tau_max,
                                void* out, int q_dtype, int b, int hkv, int c, int g, int d,
                                void* stream) {
  using namespace h2eal;
  if (g < 1 || g > MAXG) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == kF32) return dispatch_score<float>(d, q, tau_min, tau_max, out, b, hkv, c, g, st);
  if (q_dtype == kBF16)
    return dispatch_score<__nv_bfloat16>(d, q, tau_min, tau_max, out, b, hkv, c, g, st);
  return cudaErrorInvalidValue;
}

extern "C" int h2eal_page_select(const void* q, const void* tau_min, const void* tau_max,
                                 const void* page_start, const void* ctx, int ctx_all,
                                 const void* sel_prev, const void* imp_prev, const void* need,
                                 void* sel, void* imp, int q_dtype, int b, int hkv, int c,
                                 int g, int d, int n_sink, int local, int page, int top_k,
                                 int minus_one_masked, int blocks, void* stream) {
  using namespace h2eal;
  if (g < 1 || g > MAXG || c < 1 || c > MAX_PAGES || top_k < 1 || top_k > MAX_K ||
      page < 1 || blocks < 1 || blocks > MAX_CLUSTER)
    return cudaErrorInvalidValue;
  SelectArgs a;
  a.q = q;
  a.tau_min = static_cast<const float*>(tau_min);
  a.tau_max = static_cast<const float*>(tau_max);
  a.page_start = static_cast<const int*>(page_start);
  a.ctx = static_cast<const int*>(ctx);
  a.ctx_all = ctx_all;
  a.sel_prev = static_cast<const int*>(sel_prev);
  a.imp_prev = static_cast<const float*>(imp_prev);
  a.need = static_cast<const unsigned char*>(need);
  a.sel = static_cast<int*>(sel);
  a.imp = static_cast<float*>(imp);
  a.hkv = hkv;
  a.c = c;
  a.g = g;
  a.n_sink = n_sink;
  a.local = local;
  a.page = page;
  a.top_k = top_k;
  a.minus_one_masked = minus_one_masked;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == kF32) return dispatch_select<float>(d, a, b, blocks, st);
  if (q_dtype == kBF16) return dispatch_select<__nv_bfloat16>(d, a, b, blocks, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* h2eal_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
