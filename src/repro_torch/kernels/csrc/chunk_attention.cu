// Chunked-prefill attention in f32: one chunk of queries per slot over a KV
// buffer.
//
// Replaces, for f32 operands, the two TPU kernels of
// repro/kernels/chunk_attention.py; ops.py routes bf16 operands to the
// tensor-core kernels of chunk_attention_sm90.cu. This is routing by dtype,
// not a fallback: the serving path is bf16, TF32 tensor cores would break
// the f32 tolerance of 1e-4, and the f32 route serves the reduced
// card-against-CPU checks.
//   chunk_attention        (the pl.pallas_call at :107): q (B,Cq,Hq,D) over
//                          k/v (B,Hkv,T,D) with a validity mask per query,
//                          valid (B,Hkv,Cq,T) bool;
//   chunk_attention_paged  (the pl.pallas_call at :213): q over the
//                          pre-append paged cache k/v_pages (B,Hr,C,P,D),
//                          a cached key counting iff its page is written
//                          (page_start >= 0) and its position is below the
//                          slot's start, then over the chunk's own keys
//                          k/v_new (B,Cq,Hr,D) under the causal triangle
//                          (key j for query c iff j <= c).
// Same contracts: f32 in and out, f32 logits, online softmax and
// accumulation; a row with no valid key returns 0 (the max(l, 1e-30)
// guard), never NaN.
//
// What bounds them on the H100: operations. At llama3-8b's chunk shapes
// (Cq = 512, group 4, D = 128) every key read serves the 2048 query rows
// of its (slot, kv head), about 4·D·2048 FLOP per 4·D bytes of K and V, far
// above the card's balance point; in f32 the products run on the FMA units
// (67 TFLOP/s).
//
// Design. The TPU kernel keeps the whole (Cq·G, D) query block of one
// (slot, kv head) resident in VMEM and streams K/V past it; on this card
// that would launch only B·Hkv blocks (16 at full width) on 132 SMs.
// Instead the query rows r = c·G + g of a (slot, kv head) are tiled 64 at
// a time over the grid (32·Hkv·B blocks at full width). A block stages its
// q tile once in shared memory (transposed, f32) and walks the keys in
// tiles of 64 (K transposed and V in shared memory); each of its 128
// threads owns a 4x8 patch of the logit tile and a 4 x D/8 patch of the
// f32 accumulator, the 8 threads of a row reducing max and sum with warp
// shuffles.
//   chunk_attention stages the validity bytes of its rows for each key
//   tile (coalesced) and skips a tile in which none is set: a streaming
//   head attends a sink + local window, so most tiles of the
//   [ring | chunk] buffer are empty for a given q tile.
//   chunk_attention_paged computes validity in the kernel from page_start
//   and start. It first finds the last page that holds a valid key, walks
//   only the key tiles up to it and skips a tile with no valid key (at
//   start 0 it reads no page at all), then walks the chunk's own keys up
//   to the tile's last chunk position. Rows past the caller's chunk length
//   compute finite values that the caller ignores, as on the TPU.
// Shared memory is (D·68 + D·65 + 64·D)·4 + 65·64 bytes: 201 KB at D = 256,
// which the launch opts into (dynamic shared memory above 48 KB).
#include "common.cuh"

namespace h2eal {
namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr int NT = 128;       // 16 row groups x 8 column lanes
constexpr int QS = BQ + 4;    // Qt[d][r] row stride (float4-aligned)
constexpr int KS = BK + 1;    // Kt[d][c] row stride (conflict-free transpose)
constexpr int PS = BQ + 4;    // Pt[c][r] row stride (float4-aligned)
constexpr int MAXC = BQ + 1;  // chunk positions one q tile spans, at most

template <int D>
__host__ __device__ constexpr int kp_floats() {  // Kt and Pt share one region
  constexpr int a = D * KS, b = BK * PS;
  return ((a > b ? a : b) + 3) / 4 * 4;
}

template <int D>
__host__ __device__ constexpr int smem_bytes() {
  return (D * QS + kp_floats<D>() + BK * D) * 4 + MAXC * BK;
}

// output columns 32*u + 4*tx + e of a thread, u < U: at D = 80 the third
// group's upper half (columns 80-95) is never loaded nor stored
template <int D>
struct Cols {
  static constexpr int U = (D + 31) / 32;
  static_assert(D % 4 == 0, "a thread's 4 columns of a group lie wholly in or past D");
};

// online-softmax state of one thread: rows ty*4 .. ty*4+3 of the q tile
template <int D>
struct RowState {
  float m[4], l[4], acc[4][4 * Cols<D>::U];
};

template <int D>
__device__ __forceinline__ void init_state(RowState<D>& st) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    st.m[i] = kNegInf;
    st.l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * Cols<D>::U; ++c) st.acc[i][c] = 0.f;
  }
}

// offset of q/o row `row` of (slot b, kv head hk): chunk position row / g,
// q head hk·g + row % g
__device__ __forceinline__ long row_offset(int b, int hk, int row, int cq, int hq, int g,
                                           int d) {
  return (((long)b * cq + row / g) * hq + hk * g + row % g) * d;
}

template <typename T, int D>
__device__ __forceinline__ void load_q(float* Qt, const T* __restrict__ q, int b, int hk,
                                       int r0, int rows, int cq, int hq, int g) {
  for (int idx = threadIdx.x; idx < BQ * D; idx += NT) {
    const int r = idx / D, d = idx % D, row = r0 + r;
    Qt[d * QS + r] = row < rows ? to_f32(q[row_offset(b, hk, row, cq, hq, g, D) + d]) : 0.f;
  }
}

// key/value rows c0 .. c0+BK-1, row c at base + c·stride; zero from row n on
template <typename T, int D>
__device__ __forceinline__ void load_kv(float* Kt, float* Vs, const T* __restrict__ kb,
                                        const T* __restrict__ vb, long stride, int c0,
                                        int n) {
  for (int idx = threadIdx.x; idx < BK * D; idx += NT) {
    const int c = idx / D, d = idx % D, col = c0 + c;
    float kv = 0.f, vv = 0.f;
    if (col < n) {
      const long off = (long)col * stride + d;
      kv = to_f32(kb[off]);
      vv = to_f32(vb[off]);
    }
    Kt[d * KS + c] = kv;
    Vs[c * D + d] = vv;
  }
}

// One key tile of the online softmax: S = Q·Kᵀ·scale, masked by ok(r, c)
// (r the row and c the key within their tiles), then rescale and add P·V.
// P overwrites Kt. Called by all threads, after the tile is staged.
template <int D, typename Ok>
__device__ __forceinline__ void attend_tile(const float* Qt, float* Kt, const float* Vs,
                                            float scale, Ok ok, RowState<D>& st) {
  const int ty = threadIdx.x >> 3;  // rows ty*4 .. ty*4+3
  const int tx = threadIdx.x & 7;   // keys tx + 8*jj; output columns 32*u + 4*tx + e
  float* Pt = Kt;
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
  __syncthreads();  // every read of Kt is done before P overwrites it

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    bool okv[8];
    float mx = kNegInf;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      okv[jj] = ok(r, tx + 8 * jj);
      s[i][jj] = okv[jj] ? s[i][jj] * scale : kNegInf;
      mx = fmaxf(mx, s[i][jj]);
    }
    mx = group8_max(mx);
    const float m_new = fmaxf(st.m[i], mx);
    const float corr = expf(st.m[i] - m_new);
    float ps = 0.f;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const float p = okv[jj] ? expf(s[i][jj] - m_new) : 0.f;
      ps += p;
      Pt[(tx + 8 * jj) * PS + r] = p;
    }
    ps = group8_sum(ps);
    st.l[i] = st.l[i] * corr + ps;
    st.m[i] = m_new;
#pragma unroll
    for (int c = 0; c < 4 * Cols<D>::U; ++c) st.acc[i][c] *= corr;
  }
  __syncthreads();

#pragma unroll 2
  for (int j = 0; j < BK; ++j) {
    const float4 pv = *reinterpret_cast<const float4*>(&Pt[j * PS + ty * 4]);
    const float pa[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
    for (int u = 0; u < Cols<D>::U; ++u) {
      if (32 * u + 4 * tx >= D) break;
      const float4 vv = *reinterpret_cast<const float4*>(&Vs[j * D + 32 * u + 4 * tx]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        st.acc[i][4 * u + 0] = fmaf(pa[i], vv.x, st.acc[i][4 * u + 0]);
        st.acc[i][4 * u + 1] = fmaf(pa[i], vv.y, st.acc[i][4 * u + 1]);
        st.acc[i][4 * u + 2] = fmaf(pa[i], vv.z, st.acc[i][4 * u + 2]);
        st.acc[i][4 * u + 3] = fmaf(pa[i], vv.w, st.acc[i][4 * u + 3]);
      }
    }
  }
}

template <typename T, int D>
__device__ __forceinline__ void store_rows(T* __restrict__ o, const RowState<D>& st, int b,
                                           int hk, int r0, int rows, int cq, int hq, int g) {
  const int ty = threadIdx.x >> 3, tx = threadIdx.x & 7;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty * 4 + i;
    if (row >= rows) continue;
    const float lsum = fmaxf(st.l[i], 1e-30f);
    T* op = o + row_offset(b, hk, row, cq, hq, g, D);
#pragma unroll
    for (int u = 0; u < Cols<D>::U; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (32 * u + 4 * tx < D) store(&op[32 * u + 4 * tx + e], st.acc[i][4 * u + e] / lsum);
  }
}

// grid: (q tiles of Cq·G rows, Hkv, B)
template <typename T, int D>
__global__ void __launch_bounds__(NT) chunk_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const unsigned char* __restrict__ valid, T* __restrict__ o, int cq, int hkv, int t_len,
    int g, float scale) {
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);  // [D][QS]
  float* Kt = Qt + D * QS;                      // [D][KS], reused as Pt [BK][PS]
  float* Vs = Kt + kp_floats<D>();              // [BK][D]
  unsigned char* Vm = reinterpret_cast<unsigned char*>(Vs + BK * D);  // [MAXC][BK]

  const int r0 = blockIdx.x * BQ;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int hq = hkv * g, rows = cq * g;
  const int c_lo = r0 / g;
  const int nc = min((r0 + BQ - 1) / g, cq - 1) - c_lo + 1;  // chunk positions of the tile
  const long bh = (long)b * hkv + hk;
  const T* kb = k + bh * t_len * D;
  const T* vb = v + bh * t_len * D;
  const unsigned char* vl = valid + (bh * cq + c_lo) * t_len;

  load_q<T, D>(Qt, q, b, hk, r0, rows, cq, hq, g);
  RowState<D> st;
  init_state(st);

  for (int c0 = 0; c0 < t_len; c0 += BK) {
    __syncthreads();  // the previous tile's reads are done
    int any = 0;
    for (int idx = threadIdx.x; idx < nc * BK; idx += NT) {
      const int ci = idx / BK, col = c0 + idx % BK;
      const unsigned char x = col < t_len ? vl[(long)ci * t_len + col] : 0;
      Vm[idx] = x;
      any |= x;
    }
    if (!__syncthreads_or(any)) continue;  // no row of the tile attends a key of it
    load_kv<T, D>(Kt, Vs, kb, vb, D, c0, t_len);
    __syncthreads();
    attend_tile<D>(Qt, Kt, Vs, scale, [&](int r, int c) {
      const int row = r0 + r;
      return row < rows && Vm[(row / g - c_lo) * BK + c] != 0;
    }, st);
  }
  store_rows<T, D>(o, st, b, hk, r0, rows, cq, hq, g);
}

// grid: (q tiles of Cq·G rows, Hr, B)
template <typename T, int D>
__global__ void __launch_bounds__(NT) chunk_paged_kernel(
    const T* __restrict__ q, const T* __restrict__ kp, const T* __restrict__ vp,
    const int* __restrict__ page_start, const int* __restrict__ start,
    const T* __restrict__ kn, const T* __restrict__ vn, T* __restrict__ o, int cq, int hr,
    int n_pages, int page, int g, float scale) {
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);
  float* Kt = Qt + D * QS;
  float* Vs = Kt + kp_floats<D>();
  unsigned char* Kv = reinterpret_cast<unsigned char*>(Vs + BK * D);  // [BK] key valid
  __shared__ int last_page;

  const int r0 = blockIdx.x * BQ;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int hq = hr * g, rows = cq * g;
  const long bh = (long)b * hr + hk;
  const int st_b = start[b];
  const int* ps = page_start + bh * n_pages;

  // the last page that holds a key below start (pages may lie in any order)
  if (threadIdx.x == 0) last_page = -1;
  __syncthreads();
  int mine = -1;
  for (int p = threadIdx.x; p < n_pages; p += NT)
    if (ps[p] >= 0 && ps[p] < st_b) mine = p;
  if (mine >= 0) atomicMax(&last_page, mine);
  load_q<T, D>(Qt, q, b, hk, r0, rows, cq, hq, g);
  RowState<D> st;
  init_state(st);
  __syncthreads();

  const int n_keys = (last_page + 1) * page;
  const T* kb = kp + bh * n_pages * page * D;
  const T* vb = vp + bh * n_pages * page * D;
  for (int c0 = 0; c0 < n_keys; c0 += BK) {
    __syncthreads();
    int any = 0;
    for (int c = threadIdx.x; c < BK; c += NT) {
      const int col = c0 + c;
      unsigned char x = 0;
      if (col < n_keys) {
        const int s0 = ps[col / page];
        x = s0 >= 0 && s0 + col % page < st_b;
      }
      Kv[c] = x;
      any |= x;
    }
    if (!__syncthreads_or(any)) continue;  // unwritten pages, or all at >= start
    load_kv<T, D>(Kt, Vs, kb, vb, D, c0, n_keys);
    __syncthreads();
    attend_tile<D>(Qt, Kt, Vs, scale, [&](int, int c) { return Kv[c] != 0; }, st);
  }

  // the chunk's own keys, key j at kn[b, j, hk]: causal, j <= row / g
  const int c_hi = min((r0 + BQ - 1) / g, cq - 1);
  const T* knb = kn + ((long)b * cq * hr + hk) * D;
  const T* vnb = vn + ((long)b * cq * hr + hk) * D;
  for (int j0 = 0; j0 <= c_hi; j0 += BK) {
    __syncthreads();
    load_kv<T, D>(Kt, Vs, knb, vnb, (long)hr * D, j0, cq);
    __syncthreads();
    attend_tile<D>(Qt, Kt, Vs, scale, [&](int r, int c) {
      const int j = j0 + c;
      return j < cq && j <= (r0 + r) / g;
    }, st);
  }
  store_rows<T, D>(o, st, b, hk, r0, rows, cq, hq, g);
}

template <typename T, int D>
cudaError_t launch_chunk(const void* q, const void* k, const void* v, const void* valid,
                         void* o, int b, int cq, int hkv, int t_len, int g, float scale,
                         cudaStream_t stream) {
  constexpr int bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      chunk_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((cq * g + BQ - 1) / BQ, hkv, b);
  chunk_kernel<T, D><<<grid, NT, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const unsigned char*>(valid), static_cast<T*>(o), cq, hkv, t_len, g,
      scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_paged(const void* q, const void* kp, const void* vp, const void* ps,
                         const void* st, const void* kn, const void* vn, void* o, int b,
                         int cq, int hr, int n_pages, int page, int g, float scale,
                         cudaStream_t stream) {
  constexpr int bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      chunk_paged_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((cq * g + BQ - 1) / BQ, hr, b);
  chunk_paged_kernel<T, D><<<grid, NT, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp),
      static_cast<const int*>(ps), static_cast<const int*>(st), static_cast<const T*>(kn),
      static_cast<const T*>(vn), static_cast<T*>(o), cq, hr, n_pages, page, g, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t chunk_d(int d, const void* q, const void* k, const void* v, const void* valid,
                    void* o, int b, int cq, int hkv, int t_len, int g, float scale,
                    cudaStream_t s) {
  switch (d) {
    case 32: return launch_chunk<T, 32>(q, k, v, valid, o, b, cq, hkv, t_len, g, scale, s);
    case 64: return launch_chunk<T, 64>(q, k, v, valid, o, b, cq, hkv, t_len, g, scale, s);
    case 80: return launch_chunk<T, 80>(q, k, v, valid, o, b, cq, hkv, t_len, g, scale, s);
    case 128: return launch_chunk<T, 128>(q, k, v, valid, o, b, cq, hkv, t_len, g, scale, s);
    case 256: return launch_chunk<T, 256>(q, k, v, valid, o, b, cq, hkv, t_len, g, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t paged_d(int d, const void* q, const void* kp, const void* vp, const void* ps,
                    const void* st, const void* kn, const void* vn, void* o, int b, int cq,
                    int hr, int n_pages, int page, int g, float scale, cudaStream_t s) {
  switch (d) {
    case 32:
      return launch_paged<T, 32>(q, kp, vp, ps, st, kn, vn, o, b, cq, hr, n_pages, page, g, scale, s);
    case 64:
      return launch_paged<T, 64>(q, kp, vp, ps, st, kn, vn, o, b, cq, hr, n_pages, page, g, scale, s);
    case 80:
      return launch_paged<T, 80>(q, kp, vp, ps, st, kn, vn, o, b, cq, hr, n_pages, page, g, scale, s);
    case 128:
      return launch_paged<T, 128>(q, kp, vp, ps, st, kn, vn, o, b, cq, hr, n_pages, page, g, scale, s);
    case 256:
      return launch_paged<T, 256>(q, kp, vp, ps, st, kn, vn, o, b, cq, hr, n_pages, page, g, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace h2eal

extern "C" int h2eal_chunk_attention(const void* q, const void* k, const void* v,
                                     const void* valid, void* o, int b, int cq, int hkv,
                                     int t_len, int g, int d, float scale, void* stream) {
  using namespace h2eal;
  if (g < 1) return cudaErrorInvalidValue;
  return chunk_d<float>(d, q, k, v, valid, o, b, cq, hkv, t_len, g, scale,
                        static_cast<cudaStream_t>(stream));
}

extern "C" int h2eal_chunk_attention_paged(const void* q, const void* kp, const void* vp,
                                           const void* page_start, const void* start,
                                           const void* kn, const void* vn, void* o, int b,
                                           int cq, int hr, int n_pages, int page, int g, int d,
                                           float scale, void* stream) {
  using namespace h2eal;
  if (g < 1 || page < 1) return cudaErrorInvalidValue;
  return paged_d<float>(d, q, kp, vp, page_start, start, kn, vn, o, b, cq, hr, n_pages, page,
                        g, scale, static_cast<cudaStream_t>(stream));
}
