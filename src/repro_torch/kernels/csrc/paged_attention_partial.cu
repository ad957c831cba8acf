// Partial (unnormalised) decode attention of each page stripe, with the page
// gather fused: the split-KV form of decode on one card.
//
// Replaces the TPU kernel repro/kernels/paged_attention.py::
// paged_attention_partial (_stream_call's pl.pallas_call at :89, kernel fn
// :152), which each device of the coplace_shmap mesh runs over the pages it
// owns. Here the mesh's 'model' axis is a stripe axis S of one tensor:
//   q (B,Hq,D); k/v pages (B,Hkv,C,P,D), f32 or bf16;
//   slots (S,B,Hkv,N) int32, the attended page slots [sink | top-k | local]
//     of each stripe, -1 where the stripe does not own the slot;
//   valid (S,B,Hkv,N*P) bool, the validity of the gathered token buffer;
//   out m, l (S,B,Hq) f32 and o (S,B,Hq,D) f32: running max, sum of
//   exp(logit - m) and the unnormalised numerator. A row with no valid token
//   gives m = -1e30 (never -inf), l = 0, o = 0, the identity of the combine.
// It equals paged_attention_partial_ref applied to each stripe's gathered,
// masked buffer (kernels/ref.py).
//
// What bounds it on the H100: memory. It reads the K/V rows of the valid
// tokens once (about 18 MB for the retrieval heads of llama3-8b at B=4 and
// 4416 attended tokens) and does 4 FLOP per key element.
//
// Design: one block of 8 warps per (kv head, slot, stripe), so the grid has
// S·B·Hkv blocks (128 at S=8, B=4, Hkv=4) where the unsplit decode kernel
// has B·Hkv. Warp 0 first compacts the stripe's owned slots into shared
// memory (a ballot per 32 slots), so the block walks only its ~N/S pages and
// never touches another stripe's; the walk is the GQA-group register tile
// of decode_tile.cuh, reading each key straight from
// its page and loading nothing for an invalid key. The epilogue stores the
// merged raw state instead of dividing.
#include "decode_tile.cuh"

namespace h2eal {
namespace {

using decode::MAXG;
using decode::NW;
using decode::U;

constexpr int MAXN = 2048;  // largest slot list (dynamic shared memory: 4 B a slot)

template <typename T, int D>
__global__ void __launch_bounds__(NW * 32) partial_kernel(
    const T* __restrict__ q, const T* __restrict__ kp, const T* __restrict__ vp,
    const int* __restrict__ slots, const unsigned char* __restrict__ valid,
    float* __restrict__ m_out, float* __restrict__ l_out, float* __restrict__ o_out,
    int b_len, int hkv, int c, int p, int n, int g, float scale) {
  constexpr int DL = D / 32;  // dims per lane
  extern __shared__ int owned[];  // positions in the slot list of the owned slots
  __shared__ int n_owned;
  __shared__ decode::WarpStates<D> st;

  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int s = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long bh = (long)b * hkv + hk;
  const long sbh = ((long)s * b_len + b) * hkv + hk;
  const int* sl = slots + sbh * n;
  const unsigned char* vl = valid + sbh * (long)n * p;

  if (warp == 0) {
    int cnt = 0;
    for (int base = 0; base < n; base += 32) {
      const int i = base + lane;
      const bool own = i < n && sl[i] >= 0;
      const unsigned mask = __ballot_sync(0xffffffffu, own);
      if (own) owned[cnt + __popc(mask & ((1u << lane) - 1u))] = i;
      cnt += __popc(mask);
    }
    if (lane == 0) n_owned = cnt;
  }

  float qr[MAXG][DL];
  float m[MAXG], l[MAXG], acc[MAXG][DL];
  decode::init_rows<T, DL>(q + bh * g * D, g, lane, qr, m, l, acc);
  __syncthreads();

  const T* kb = kp + bh * (long)c * p * D;
  const T* vb = vp + bh * (long)c * p * D;
  const int total = n_owned * p;
  for (int t0 = warp * U; t0 < total; t0 += NW * U) {
    float kx[U][DL], vx[U][DL];
    bool ok[U];
    bool any = false;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + u;
      long row = 0;
      ok[u] = false;
      if (t < total) {
        const int i = owned[t / p], j = t % p;
        ok[u] = vl[(long)i * p + j] != 0;
        row = ((long)sl[i] * p + j) * D;
      }
      any |= ok[u];
#pragma unroll
      for (int e = 0; e < DL; ++e) {
        kx[u][e] = ok[u] ? to_f32(kb[row + lane * DL + e]) : 0.f;
        vx[u][e] = ok[u] ? to_f32(vb[row + lane * DL + e]) : 0.f;
      }
    }
    if (!any) continue;  // the same on every lane of the warp
    decode::online_step<DL>(qr, kx, vx, ok, m, l, acc, g, scale);
  }

  decode::stash<D, DL>(st, warp, lane, g, m, l, acc);
  __syncthreads();

  const long row0 = sbh * g;  // first output row of this block in (S, B, Hq)
  for (int idx = threadIdx.x; idx < g * D; idx += NW * 32) {
    const int r = idx / D, d = idx % D;
    float mg, lg, og;
    decode::merge<D>(st, r, d, mg, lg, og);
    o_out[(row0 + r) * D + d] = og;
    if (d == 0) {
      m_out[row0 + r] = mg;
      l_out[row0 + r] = lg;
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* kp, const void* vp, const void* slots,
                   const void* valid, void* m, void* l, void* o, int s, int b, int hkv, int c,
                   int p, int n, int g, float scale, cudaStream_t stream) {
  const dim3 grid(hkv, b, s);
  partial_kernel<T, D><<<grid, NW * 32, n * sizeof(int), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp),
      static_cast<const int*>(slots), static_cast<const unsigned char*>(valid),
      static_cast<float*>(m), static_cast<float*>(l), static_cast<float*>(o), b, hkv, c, p, n,
      g, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int d, const void* q, const void* kp, const void* vp, const void* slots,
                       const void* valid, void* m, void* l, void* o, int s, int b, int hkv,
                       int c, int p, int n, int g, float scale, cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch<T, 32>(q, kp, vp, slots, valid, m, l, o, s, b, hkv, c, p, n, g, scale,
                           stream);
    case 64:
      return launch<T, 64>(q, kp, vp, slots, valid, m, l, o, s, b, hkv, c, p, n, g, scale,
                           stream);
    case 128:
      return launch<T, 128>(q, kp, vp, slots, valid, m, l, o, s, b, hkv, c, p, n, g, scale,
                            stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace h2eal

extern "C" int h2eal_paged_attention_partial(const void* q, const void* kp, const void* vp,
                                             const void* slots, const void* valid, void* m,
                                             void* l, void* o, int dtype, int s, int b,
                                             int hkv, int c, int p, int n, int g, int d,
                                             float scale, void* stream) {
  using namespace h2eal;
  if (g < 1 || g > MAXG || n < 1 || n > MAXN) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return dispatch_d<float>(d, q, kp, vp, slots, valid, m, l, o, s, b, hkv, c, p, n, g, scale,
                             st);
  if (dtype == kBF16)
    return dispatch_d<__nv_bfloat16>(d, q, kp, vp, slots, valid, m, l, o, s, b, hkv, c, p, n,
                                     g, scale, st);
  return cudaErrorInvalidValue;
}
