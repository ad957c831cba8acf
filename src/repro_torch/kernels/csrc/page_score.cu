// Quest page score from per-page key min/max metadata.
//
// Replaces the TPU kernel repro/kernels/page_score.py::page_score (the
// pl.pallas_call at :46). Same contract: q (B,Hq,D) in f32 or bf16, tau_min
// and tau_max (B,Hkv,C,D) f32 -> scores (B,Hkv,C) f32 with
//   score = Σ_{g in group} Σ_d relu(q_gd)·τmax_d + min(q_gd, 0)·τmin_d,
// the upper bound on any key's logit in the page. Nothing is masked or
// clamped: an empty page holds τ = ±inf, its products give NaN exactly as
// the reference's do, and core/paging.score_pages masks it afterwards.
//
// What bounds it on the H100: memory. The τ metadata is read once (about
// 2.1 MB per call for llama3-8b's retrieval heads at B=2 and 257 pages)
// for 4·group FLOP per element.
//
// Design: one block of 8 warps per (tile of 32 pages, kv head, batch).
// Every lane keeps its D/32 coordinates of the group's query rows, split
// into positive and negative parts, in registers; each warp scores four
// pages, reading each τ row once with one coalesced load per lane, and
// reduces the per-lane sums with warp shuffles.
#include "common.cuh"

namespace h2eal {
namespace {

constexpr int NW = 8;
constexpr int PAGES_PER_WARP = 4;
constexpr int BC = NW * PAGES_PER_WARP;
constexpr int MAXG = 8;

template <typename T, int D>
__global__ void __launch_bounds__(NW * 32) score_kernel(
    const T* __restrict__ q, const float* __restrict__ tau_min,
    const float* __restrict__ tau_max, float* __restrict__ out, int hkv, int c, int g) {
  constexpr int DL = D / 32;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long bh = (long)b * hkv + hk;

  float qp[MAXG][DL], qn[MAXG][DL];
  const T* qb = q + bh * g * D;
#pragma unroll
  for (int r = 0; r < MAXG; ++r)
#pragma unroll
    for (int e = 0; e < DL; ++e) {
      const float x = r < g ? to_f32(qb[(long)r * D + lane * DL + e]) : 0.f;
      qp[r][e] = fmaxf(x, 0.f);
      qn[r][e] = fminf(x, 0.f);
    }

#pragma unroll
  for (int i = 0; i < PAGES_PER_WARP; ++i) {
    const int p = blockIdx.x * BC + warp * PAGES_PER_WARP + i;
    if (p >= c) break;
    const float* tn = tau_min + (bh * c + p) * D + lane * DL;
    const float* tx = tau_max + (bh * c + p) * D + lane * DL;
    float tmin[DL], tmax[DL];
#pragma unroll
    for (int e = 0; e < DL; ++e) {
      tmin[e] = tn[e];
      tmax[e] = tx[e];
    }
    float part = 0.f;
#pragma unroll
    for (int r = 0; r < MAXG; ++r) {
      if (r >= g) break;
#pragma unroll
      for (int e = 0; e < DL; ++e) {
        part = fmaf(qp[r][e], tmax[e], part);
        part = fmaf(qn[r][e], tmin[e], part);
      }
    }
    part = warp_sum(part);
    if (lane == 0) out[bh * c + p] = part;
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* tau_min, const void* tau_max, void* out, int b,
                   int hkv, int c, int g, cudaStream_t stream) {
  const dim3 grid((c + BC - 1) / BC, hkv, b);
  score_kernel<T, D><<<grid, NW * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const float*>(tau_min),
      static_cast<const float*>(tau_max), static_cast<float*>(out), hkv, c, g);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int d, const void* q, const void* tau_min, const void* tau_max,
                       void* out, int b, int hkv, int c, int g, cudaStream_t stream) {
  switch (d) {
    case 32: return launch<T, 32>(q, tau_min, tau_max, out, b, hkv, c, g, stream);
    case 64: return launch<T, 64>(q, tau_min, tau_max, out, b, hkv, c, g, stream);
    case 128: return launch<T, 128>(q, tau_min, tau_max, out, b, hkv, c, g, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace h2eal

extern "C" int h2eal_page_score(const void* q, const void* tau_min, const void* tau_max,
                                void* out, int q_dtype, int b, int hkv, int c, int g, int d,
                                void* stream) {
  using namespace h2eal;
  if (g < 1 || g > MAXG) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == kF32) return dispatch_d<float>(d, q, tau_min, tau_max, out, b, hkv, c, g, st);
  if (q_dtype == kBF16)
    return dispatch_d<__nv_bfloat16>(d, q, tau_min, tau_max, out, b, hkv, c, g, st);
  return cudaErrorInvalidValue;
}

extern "C" const char* h2eal_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
