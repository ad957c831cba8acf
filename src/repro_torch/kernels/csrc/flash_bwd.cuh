// Arguments and mask helpers shared by flash attention's backward kernels
// (flash_attention_bwd.cu: the f32 route and head_dim 256; and
// flash_attention_bwd_sm90.cu: the bf16 route).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace h2eal {
namespace bwd {

struct BwdArgs {
  const void *q, *k, *v, *o, *dout;
  const float* lse;  // (B, Hq, Sq) f32: the forward's row log-sum-exp, -inf for no key
  void *dq, *dk, *dv;
  float* delta;  // (B, Hq, Sq) f32 scratch: Δ, written by the dq launch
  float* parts_buf;  // key tile 0's partial dk and dv when it is cut (sink_parts)
  int* arrivals;     // (B, Hkv) int32, zero at a launch and left so
  int b, sq, sk, hq, hkv, causal, window, sink, q_offset;
  float scale;
  cudaStream_t stream;
};

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ bool allowed(int row, int col, int sk, int causal, int window,
                                        int sink) {
  bool ok = col < sk;
  if (causal) ok = ok && col <= row;
  if (window > 0) ok = ok && (col > row - window || col < sink);
  return ok;
}

// key tiles [0, end) that the rows i_min..i_max can see
__device__ __forceinline__ int key_tiles_end(int sk, int bk, int i_max, int causal) {
  int end = (sk + bk - 1) / bk;
  if (causal) end = min(end, i_max / bk + 1);
  return end;
}

// The key tiles of bk keys that rows from absolute position i_min on see:
// [0, end) but [lo, hi], the tiles wholly outside the window that hold no
// sink key (none without a window)
struct Span {
  int end, lo, hi;
  __device__ Span(int end_, int bk, int i_min, int window, int sink) : end(end_) {
    lo = (sink + bk - 1) / bk;
    const int x = i_min - window - bk + 1;  // a tile at or below x lies outside
    hi = window > 0 && x >= 0 ? min(x / bk, end - 1) : -1;
  }
  __device__ int live() const { return end - max(0, hi - lo + 1); }
  // the first tile at or after kt that is seen
  __device__ int next(int kt) const { return kt >= lo && kt <= hi ? hi + 1 : kt; }
};

// the q tiles of br rows whose rows can see a key of [c0, c1]: [lo, hi]
struct QSpan {
  int lo, hi;
  __device__ QSpan(int c0, int c1, int sq, int br, int causal, int window, int sink,
                   int q_offset) {
    lo = causal ? max(0, c0 - q_offset) / br : 0;
    hi = (sq + br - 1) / br - 1;
    if (window > 0 && c0 >= sink) {  // no sink key here: rows up to c1 + window - 1
      const int last = c1 + window - 1 - q_offset;
      hi = last < 0 ? -1 : min(hi, last / br);
    }
  }
  __device__ int count() const { return max(0, hi - lo + 1); }
};

// Where a window and sink keys make key tile 0 seen by every q tile, launch 2
// cuts that tile's items into `parts` runs of about a window tile's count,
// one block each (a tile without sink keys sees at most (BKV + window) / BR
// + 2 q tiles of each head): otherwise its one block walks them all while
// the rest of the grid has finished. The runs' partial dk and dv (f32, dk
// scaled) go to parts_buf [part][B][Hkv][dk, dv][BKV][D], and the last block
// to arrive sums them in part order (merge_parts): the same sums in the same
// order whichever block arrives last
constexpr int kMaxParts = 64;
__host__ __device__ inline int sink_parts(int sq, int window, int sink, int br, int bkv) {
  if (window <= 0 || sink <= 0 || sink > bkv) return 1;
  const int p = ((sq + br - 1) / br) / ((bkv + window) / br + 2);
  return p < 1 ? 1 : (p > kMaxParts ? kMaxParts : p);
}
__host__ __device__ inline long parts_floats(int parts, int b, int hkv, int bkv, int d) {
  return parts > 1 ? (long)parts * b * hkv * 2 * bkv * d : 0;
}

// the last block's sum of the parts of key tile 0 of (b, hk), into dk and dv
template <typename T, int D, int BKV>
__device__ void merge_parts(const float* parts_buf, int parts, int nb, int hkv, int b, int hk,
                            int sk, T* dk, T* dv, long koff, long k_rs, int tid, int nthreads) {
  const long pstride = (long)nb * hkv * 2 * BKV * D;
  const float* base = parts_buf + ((long)b * hkv + hk) * 2 * BKV * D;
  const int keys = min(BKV, sk);
  for (int idx = tid; idx < keys * D; idx += nthreads) {
    float xk = 0.f, xv = 0.f;
    for (int p = 0; p < parts; ++p) {
      xk += __ldcg(base + p * pstride + idx);
      xv += __ldcg(base + p * pstride + BKV * D + idx);
    }
    const int key = idx / D, col = idx % D;
    store(dk + koff + key * k_rs + col, xk);
    store(dv + koff + key * k_rs + col, xv);
  }
}

// the forward's L (natural log) as the exponent offset of P = 2^(s·scale·log2e
// − L·log2e); a row with no allowed key (L = −inf) gets +inf, so its P is 0
__device__ __forceinline__ float lse_log2(float lse) {
  return lse == -INFINITY ? INFINITY : lse * kLog2e;
}

// 2^x on the special-function unit (2^-22 relative); 2^-inf = 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

}  // namespace bwd
}  // namespace h2eal
