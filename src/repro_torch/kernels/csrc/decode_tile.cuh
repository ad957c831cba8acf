// The one-query decode stream shared by paged_attention.cu and
// paged_attention_partial.cu: a block of NW warps holds the GQA group's query
// rows in registers; each warp walks its own share of the keys, U at a time
// (one coalesced row load per key, the 32 lanes splitting D), keeping an f32
// online-softmax state (running max m, sum l, accumulator acc) per row; the
// warps' states are then merged through shared memory.
#pragma once

#include "common.cuh"

namespace h2eal {
namespace decode {

constexpr int NW = 8;    // warps per block
constexpr int MAXG = 8;  // largest GQA group the kernels take
constexpr int U = 4;     // keys per warp step

template <int D>
struct WarpStates {
  float m[NW][MAXG];
  float l[NW][MAXG];
  float a[NW][MAXG][D];
};

// query rows r < g of one (batch, kv head) into registers; the state starts
// empty: m = NEG_INF, l = 0, acc = 0
template <typename T, int DL>
__device__ __forceinline__ void init_rows(const T* qb, int g, int lane, float (&qr)[MAXG][DL],
                                          float (&m)[MAXG], float (&l)[MAXG],
                                          float (&acc)[MAXG][DL]) {
#pragma unroll
  for (int r = 0; r < MAXG; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < DL; ++e) {
      qr[r][e] = r < g ? to_f32(qb[(long)r * DL * 32 + lane * DL + e]) : 0.f;
      acc[r][e] = 0.f;
    }
  }
}

// one warp step over U keys (kx, vx: this lane's DL coordinates of each key;
// ok: the key counts, the same on every lane)
template <int DL>
__device__ __forceinline__ void online_step(const float (&qr)[MAXG][DL], const float (&kx)[U][DL],
                                            const float (&vx)[U][DL], const bool (&ok)[U],
                                            float (&m)[MAXG], float (&l)[MAXG],
                                            float (&acc)[MAXG][DL], int g, float scale) {
#pragma unroll
  for (int r = 0; r < MAXG; ++r) {
    if (r >= g) break;
    float s[U];
    float mx = kNegInf;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float part = 0.f;
#pragma unroll
      for (int e = 0; e < DL; ++e) part = fmaf(qr[r][e], kx[u][e], part);
      part = warp_sum(part);
      s[u] = ok[u] ? part * scale : kNegInf;
      mx = fmaxf(mx, s[u]);
    }
    const float m_new = fmaxf(m[r], mx);
    const float corr = expf(m[r] - m_new);
    float ps = 0.f;
#pragma unroll
    for (int e = 0; e < DL; ++e) acc[r][e] *= corr;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const float p = ok[u] ? expf(s[u] - m_new) : 0.f;
      ps += p;
#pragma unroll
      for (int e = 0; e < DL; ++e) acc[r][e] = fmaf(p, vx[u][e], acc[r][e]);
    }
    l[r] = l[r] * corr + ps;
    m[r] = m_new;
  }
}

// write this warp's state into shared memory (the caller syncs after)
template <int D, int DL>
__device__ __forceinline__ void stash(WarpStates<D>& st, int warp, int lane, int g,
                                      const float (&m)[MAXG], const float (&l)[MAXG],
                                      const float (&acc)[MAXG][DL]) {
#pragma unroll
  for (int r = 0; r < MAXG; ++r) {
    if (r >= g) break;
    if (lane == 0) {
      st.m[warp][r] = m[r];
      st.l[warp][r] = l[r];
    }
#pragma unroll
    for (int e = 0; e < DL; ++e) st.a[warp][r][lane * DL + e] = acc[r][e];
  }
}

// the merged state of row r at coordinate d: global max, rescale, sum. A row
// no warp saw a valid key of stays (NEG_INF, 0, 0)
template <int D>
__device__ __forceinline__ void merge(const WarpStates<D>& st, int r, int d, float& mg,
                                      float& lg, float& og) {
  mg = kNegInf;
  for (int w = 0; w < NW; ++w) mg = fmaxf(mg, st.m[w][r]);
  lg = 0.f;
  og = 0.f;
  for (int w = 0; w < NW; ++w) {
    const float c = expf(st.m[w][r] - mg);
    lg = fmaf(st.l[w][r], c, lg);
    og = fmaf(st.a[w][r][d], c, og);
  }
}

}  // namespace decode
}  // namespace h2eal
