// Prefill GQA attention in f32: causal, optional sliding window and
// attention sinks.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (the pl.pallas_call at :97) for f32 operands; ops.py routes bf16 operands
// to the tensor-core kernel of flash_attention_sm90.cu. This is routing by
// dtype, not a fallback: the serving path is bf16, single TF32 products
// would break the f32 tolerance of 1e-4 (3xTF32, three TF32 products for
// one, holds it: the backward's f32 route in flash_attention_bwd.cu; this
// forward keeps the FMA units), and the f32 route serves the reduced
// card-against-CPU checks and the training paths' forward. Same contract:
// q (B,Sq,Hq,D), k/v (B,Sk,Hkv,D) f32, f32 logits and online softmax, f32
// output. Key j is attended by query row i (absolute position i +
// q_offset) iff j <= row (causal), j > row - window (window>0), or j < sink
// (sink>0, only together with a window). A row with every key masked
// returns 0. Where the caller passes `lse` (a
// (B, Hq, Sq) f32 buffer: the autograd forward, for the backward), each
// row's log-sum-exp L = m + log l of its scaled, masked scores is written
// there, natural log, −inf for a row with no allowed key; serving passes
// null and the output is the same bit for bit.
//
// What bounds it on the H100: the retrieval (full causal) half is
// compute-bound (about 5.5e11 FLOP per layer at B=2, S=8192, 16 heads,
// D=128), and in f32 the products run on the FMA units, so its ceiling is
// the 67 TFLOP/s f32 rate and the shared-memory bandwidth that feeds it.
//
// Design: one block of 128 threads per (64-row q tile, q head, batch).
// The q tile is staged once in shared memory (transposed); K/V tiles of 64
// keys are staged per step. The KV head is read as h / group, never
// materialised per q head as the TPU wrapper's jnp.repeat does. Each
// thread owns a 4x8 patch of the 64x64 logit tile and a 4 x D/8 patch of
// the accumulator (4 x 12 at D = 80: three 32-column groups, the third's
// upper half, columns 80-95, never loaded nor stored); the 8 threads of a row reduce max and sum with warp
// shuffles. Key tiles wholly outside causal ∪ (window + sink) are skipped,
// so the streaming heads cost O(S·(window + sink)) and not O(S²). Blocks
// of the heaviest (last) q tiles are launched first to shorten the tail.
// Shared memory is (D·68 + D·65 + 64·D)·4 bytes: 197 KB at D = 256, which
// the launch opts into (dynamic shared memory above 48 KB), one block an SM.
#include "common.cuh"

namespace h2eal {
namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NT = 128;       // 16 row groups x 8 column lanes
constexpr int QS = BQ + 4;    // Qt[d][r] row stride (float4-aligned)
constexpr int KS = BK + 1;    // Kt[d][c] row stride (conflict-free transpose)
constexpr int PS = BQ + 4;    // Pt[c][r] row stride (float4-aligned)

template <int D>
__host__ __device__ constexpr int kp_floats() {  // Kt and Pt share one region
  constexpr int a = D * KS, b = BK * PS;
  return ((a > b ? a : b) + 3) / 4 * 4;
}

template <int D>
__host__ __device__ constexpr int smem_bytes() {
  return (D * QS + kp_floats<D>() + BK * D) * 4;
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, float* __restrict__ lse, int sq, int sk, int hq, int hkv, int causal,
    int window, int sink, int q_offset, float scale) {
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);  // [D][QS]
  float* Kt = Qt + D * QS;                      // [D][KS], reused as Pt [BK][PS]
  float* Pt = Kt;
  float* Vs = Kt + kp_floats<D>();              // [BK][D]

  const int qtile = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int tid = threadIdx.x;
  const int ty = tid >> 3;  // rows ty*4 .. ty*4+3
  const int tx = tid & 7;   // logit columns tx + 8*jj; output columns 32*u + 4*tx + e
  const int r0 = qtile * BQ;
  constexpr int U = (D + 31) / 32;  // 32-column groups of the output
  constexpr int DC = 4 * U;         // output columns per thread
  static_assert(D % 4 == 0, "a thread's 4 columns of a group lie wholly in or past D");

  const long q_rs = (long)hq * D;
  const long k_rs = (long)hkv * D;
  const T* qb = q + ((long)b * sq * hq + h) * D;
  const T* kb = k + ((long)b * sk * hkv + hk) * D;
  const T* vb = v + ((long)b * sk * hkv + hk) * D;

  for (int idx = tid; idx < BQ * D; idx += NT) {
    const int r = idx / D, d = idx % D;
    const int s = r0 + r;
    Qt[d * QS + r] = s < sq ? to_f32(qb[(long)s * q_rs + d]) : 0.f;
  }

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  const int i_min = r0 + q_offset;            // absolute position of the first row
  const int i_max = r0 + BQ - 1 + q_offset;   // ... and of the last
  int kt_end = (sk + BK - 1) / BK;
  if (causal) kt_end = min(kt_end, i_max / BK + 1);

  for (int kt = 0; kt < kt_end; ++kt) {
    const int c0 = kt * BK;
    // no key of this tile is in any row's window, and none is a sink key
    if (window > 0 && c0 >= sink && c0 + BK - 1 <= i_min - window) continue;

    __syncthreads();  // the previous tile's P·V reads are done
    for (int idx = tid; idx < BK * D; idx += NT) {
      const int c = idx / D, d = idx % D;
      const int col = c0 + c;
      float kv = 0.f, vv = 0.f;
      if (col < sk) {
        const long off = (long)col * k_rs + d;
        kv = to_f32(kb[off]);
        vv = to_f32(vb[off]);
      }
      Kt[d * KS + c] = kv;
      Vs[c * D + d] = vv;
    }
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) s[i][jj] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(&Qt[d * QS + ty * 4]);
      const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const float kk = Kt[d * KS + tx + 8 * jj];
#pragma unroll
        for (int i = 0; i < 4; ++i) s[i][jj] = fmaf(qa[i], kk, s[i][jj]);
      }
    }
    __syncthreads();  // every read of Kt is done before Pt overwrites it

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + ty * 4 + i + q_offset;
      bool ok[8];
      float mx = kNegInf;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int col = c0 + tx + 8 * jj;
        bool valid = col < sk;
        if (causal) valid = valid && col <= row;
        if (window > 0) valid = valid && (col > row - window || col < sink);
        ok[jj] = valid;
        s[i][jj] = valid ? s[i][jj] * scale : kNegInf;
        mx = fmaxf(mx, s[i][jj]);
      }
      mx = group8_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const float p = ok[jj] ? expf(s[i][jj] - m_new) : 0.f;
        ps += p;
        Pt[(tx + 8 * jj) * PS + ty * 4 + i] = p;
      }
      ps = group8_sum(ps);
      l[i] = l[i] * corr + ps;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 2
    for (int j = 0; j < BK; ++j) {
      const float4 pv = *reinterpret_cast<const float4*>(&Pt[j * PS + ty * 4]);
      const float pa[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (32 * u + 4 * tx >= D) break;  // at D = 80, the last group's upper half
        const float4 vv = *reinterpret_cast<const float4*>(&Vs[j * D + 32 * u + 4 * tx]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][4 * u + 0] = fmaf(pa[i], vv.x, acc[i][4 * u + 0]);
          acc[i][4 * u + 1] = fmaf(pa[i], vv.y, acc[i][4 * u + 1]);
          acc[i][4 * u + 2] = fmaf(pa[i], vv.z, acc[i][4 * u + 2]);
          acc[i][4 * u + 3] = fmaf(pa[i], vv.w, acc[i][4 * u + 3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int srow = r0 + ty * 4 + i;
    if (srow >= sq) continue;
    const float lsum = fmaxf(l[i], 1e-30f);
    if (lse != nullptr && tx == 0)
      lse[((long)b * hq + h) * sq + srow] = l[i] > 0.f ? m[i] + logf(l[i]) : -INFINITY;
    T* op = o + (((long)b * sq + srow) * hq + h) * D;
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (32 * u + 4 * tx < D) store(&op[32 * u + 4 * tx + e], acc[i][4 * u + e] / lsum);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int b, int sq,
                   int sk, int hq, int hkv, int causal, int window, int sink, int q_offset,
                   float scale, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + BQ - 1) / BQ, hq, b);
  flash_kernel<T, D><<<grid, NT, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, sq, sk, hq, hkv, causal, window, sink, q_offset, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int d, const void* q, const void* k, const void* v, void* o, float* lse, int b,
                       int sq, int sk, int hq, int hkv, int causal, int window, int sink,
                       int q_offset, float scale, cudaStream_t stream) {
  switch (d) {
    case 32: return launch<T, 32>(q, k, v, o, lse, b, sq, sk, hq, hkv, causal, window, sink, q_offset, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, lse, b, sq, sk, hq, hkv, causal, window, sink, q_offset, scale, stream);
    case 80: return launch<T, 80>(q, k, v, o, lse, b, sq, sk, hq, hkv, causal, window, sink, q_offset, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, lse, b, sq, sk, hq, hkv, causal, window, sink, q_offset, scale, stream);
    case 256: return launch<T, 256>(q, k, v, o, lse, b, sq, sk, hq, hkv, causal, window, sink, q_offset, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace h2eal

// lse: null, or (B, Hq, Sq) f32 for the rows' log-sum-exp
extern "C" int h2eal_flash_attention(const void* q, const void* k, const void* v, void* o,
                                     void* lse, int b, int sq, int sk, int hq, int hkv, int d, int causal,
                                     int window, int sink, int q_offset, float scale,
                                     void* stream) {
  using namespace h2eal;
  return dispatch_d<float>(d, q, k, v, o, static_cast<float*>(lse), b, sq, sk, hq, hkv, causal, window, sink, q_offset,
                           scale, static_cast<cudaStream_t>(stream));
}
