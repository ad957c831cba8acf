// One-query decode attention over a gathered KV buffer with a validity mask.
//
// Replaces the TPU kernel repro/kernels/paged_attention.py::paged_attention
// (_stream_call's pl.pallas_call at :89). Same contract: q (B,Hq,D), k/v
// (B,Hkv,T,D) in one storage dtype (f32 or bf16), valid (B,Hkv,T) bool;
// softmax(q·kᵀ/sqrt(D))·v over the valid positions, output (B,Hq,D) in q's
// dtype; a row with no valid position returns 0.
//
// What bounds it on the H100: memory. Each call reads its K/V once (about
// 18 MB for the retrieval heads of llama3-8b at B=2 and T=4416) and does 4
// FLOP per key element, far below the card's 295 FLOP/byte balance point.
//
// Design: one block of 8 warps per (kv head, batch); the GQA group's query
// rows stay in registers for the whole stream, so each key and value row
// is read from device memory once for all rows of the group. Each warp
// walks its own interleaved share of T, four keys at a time (one coalesced
// row load per key, the 32 lanes splitting D), keeping its own f32 online
// softmax state (running max, sum and accumulator); the eight partial
// states are merged through shared memory at the end. Only B·Hkv blocks
// run, so at decode batch sizes most SMs idle: a split-KV grid is the next
// step for this kernel.
#include "common.cuh"

namespace h2eal {
namespace {

constexpr int NW = 8;      // warps per block
constexpr int MAXG = 8;    // largest GQA group the kernel takes
constexpr int U = 4;       // keys per warp step

template <typename T, int D>
__global__ void __launch_bounds__(NW * 32) paged_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const unsigned char* __restrict__ valid, T* __restrict__ o, int hkv, int t_len,
    int g, float scale) {
  constexpr int DL = D / 32;  // dims per lane
  __shared__ float m_s[NW][MAXG];
  __shared__ float l_s[NW][MAXG];
  __shared__ float a_s[NW][MAXG][D];

  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long bh = (long)b * hkv + hk;

  float qr[MAXG][DL];
  float m[MAXG], l[MAXG], acc[MAXG][DL];
  const T* qb = q + bh * g * D;
#pragma unroll
  for (int r = 0; r < MAXG; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < DL; ++e) {
      qr[r][e] = r < g ? to_f32(qb[(long)r * D + lane * DL + e]) : 0.f;
      acc[r][e] = 0.f;
    }
  }

  const T* kb = k + bh * t_len * D;
  const T* vb = v + bh * t_len * D;
  const unsigned char* vl = valid + bh * t_len;

  for (int t0 = warp * U; t0 < t_len; t0 += NW * U) {
    float kx[U][DL], vx[U][DL];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + u;
      ok[u] = t < t_len && vl[t] != 0;
#pragma unroll
      for (int e = 0; e < DL; ++e) {
        kx[u][e] = t < t_len ? to_f32(kb[(long)t * D + lane * DL + e]) : 0.f;
        vx[u][e] = t < t_len ? to_f32(vb[(long)t * D + lane * DL + e]) : 0.f;
      }
    }
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

#pragma unroll
  for (int r = 0; r < MAXG; ++r) {
    if (r >= g) break;
    if (lane == 0) {
      m_s[warp][r] = m[r];
      l_s[warp][r] = l[r];
    }
#pragma unroll
    for (int e = 0; e < DL; ++e) a_s[warp][r][lane * DL + e] = acc[r][e];
  }
  __syncthreads();

  // merge the warps' partial states: global max, rescale, sum, divide
  T* ob = o + bh * g * D;
  for (int idx = threadIdx.x; idx < g * D; idx += NW * 32) {
    const int r = idx / D, d = idx % D;
    float mg = kNegInf;
    for (int w = 0; w < NW; ++w) mg = fmaxf(mg, m_s[w][r]);
    float lg = 0.f, og = 0.f;
    for (int w = 0; w < NW; ++w) {
      const float c = expf(m_s[w][r] - mg);
      lg = fmaf(l_s[w][r], c, lg);
      og = fmaf(a_s[w][r][d], c, og);
    }
    store(&ob[(long)r * D + d], og / fmaxf(lg, 1e-30f));
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* valid, void* o,
                   int b, int hkv, int t_len, int g, float scale, cudaStream_t stream) {
  const dim3 grid(hkv, b);
  paged_kernel<T, D><<<grid, NW * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const unsigned char*>(valid), static_cast<T*>(o), hkv, t_len, g, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int d, const void* q, const void* k, const void* v, const void* valid,
                       void* o, int b, int hkv, int t_len, int g, float scale,
                       cudaStream_t stream) {
  switch (d) {
    case 32: return launch<T, 32>(q, k, v, valid, o, b, hkv, t_len, g, scale, stream);
    case 64: return launch<T, 64>(q, k, v, valid, o, b, hkv, t_len, g, scale, stream);
    case 128: return launch<T, 128>(q, k, v, valid, o, b, hkv, t_len, g, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace h2eal

extern "C" int h2eal_paged_attention(const void* q, const void* k, const void* v,
                                     const void* valid, void* o, int dtype, int b, int hkv,
                                     int t_len, int g, int d, float scale, void* stream) {
  using namespace h2eal;
  if (g < 1 || g > MAXG) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return dispatch_d<float>(d, q, k, v, valid, o, b, hkv, t_len, g, scale, st);
  if (dtype == kBF16)
    return dispatch_d<__nv_bfloat16>(d, q, k, v, valid, o, b, hkv, t_len, g, scale, st);
  return cudaErrorInvalidValue;
}
