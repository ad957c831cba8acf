// One-query decode attention over a gathered KV buffer with a validity mask,
// as a split-KV grid that merges its splits in the same launch.
//
// Replaces the TPU kernel repro/kernels/paged_attention.py::paged_attention
// (_stream_call's pl.pallas_call at :89). Same contract: q (B,Hq,D), k/v
// (B,Hkv,T,D) in one storage dtype (f32 or bf16), valid (B,Hkv,T) bool;
// softmax(q·kᵀ/sqrt(D))·v over the valid positions in f32, output (B,Hq,D)
// in q's dtype; a row with no valid position returns 0.
//
// What bounds it on the H100: memory. Each call reads its K/V once (about
// 18 MB for the retrieval heads of llama3-8b at B=2 and T=4416) and does 4
// FLOP per key element, far below the card's 295 FLOP/byte balance point.
// At decode batch sizes there are only B·Hkv (kv head, slot) streams (8 in
// that case), so one block per stream leaves most of the 132 SMs idle and
// every block waits on the latency of a long serial walk.
//
// Design: the grid is (split, kv head, batch). The wrapper picks n splits
// so that B·Hkv·n fills two blocks per SM while each split keeps >= 128
// keys (ops.py::paged_splits), and each block walks its split's keys in
// tiles of TK, copied to shared memory with 16-byte cp.async, two tiles in
// flight (the next tile's validity bytes are prefetched into registers a
// tile ahead). Per tile, lane j of warp w dots key j against the query rows
// r ≡ w (mod 4) of the GQA group (held in shared memory as f32), so a row
// costs two warp reductions per 32 keys rather than one per key; then each
// thread owns one value column for every row of the group and accumulates
// p·v. The block keeps an f32 online softmax per row. With n > 1, each block
// writes its raw (m, l, o) to scratch, fences, and counts itself in on its
// (batch, kv head) counter; the block that arrives last merges the n
// partials in split order by combine_partials' rule (global max, rescale,
// sum, divide by max(l, 1e-30)), writes the output and resets the counter
// to 0, so the output does not depend on which block ends last. A split
// with no valid key contributes the identity (NEG_INF, 0, 0). With n = 1 the
// block divides and writes directly. The counters are zeroed once when the
// wrapper creates them; calls on one stream never overlap, so they are
// always 0 at a launch.
#include "common.cuh"

namespace h2eal {
namespace {

constexpr int NT = 128;  // threads per block: 4 warps
constexpr int NWP = NT / 32;
constexpr int TK = 32;   // keys per tile: one per lane
constexpr int MAXG = 8;  // largest GQA group

// 16-byte vectors of the storage type, widened to f32
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void load(const float* p, float (&x)[4]) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float (&x)[8]) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
};

// 16 bytes global -> shared, zero-filled when !pred
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

template <typename T, int D>
struct Smem {
  static constexpr int RS = D + 16 / sizeof(T);  // row stride: 16 bytes of padding
  static constexpr int KS = NT / D;                 // key slices of the P·V step
  static constexpr int TILE = TK * RS;            // elements of one K or V tile
  static constexpr int bytes() {
    return 4 * TILE * (int)sizeof(T)               // K and V, two stages
           + (MAXG * D + MAXG * TK + 3 * MAXG) * 4  // q rows, p, corr / m / l
           + KS * MAXG * D * 4;                     // the key slices' accumulators
  }
};

template <typename T, int D>
__global__ void __launch_bounds__(NT) paged_split_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const unsigned char* __restrict__ valid, T* __restrict__ o, float* __restrict__ part_m,
    float* __restrict__ part_l, float* __restrict__ part_o, int* __restrict__ counters,
    int hkv, int t_len, int g, int n_split, int chunk, float scale) {
  using S = Smem<T, D>;
  constexpr int VN = Vec<T>::N;
  constexpr int KS = S::KS;
  constexpr int CPR = D / VN;  // 16-byte chunks per key row
  extern __shared__ float4 smem4[];
  T* kv_s = reinterpret_cast<T*>(smem4);            // [stage][K|V][TK][RS]
  float* q_s = reinterpret_cast<float*>(kv_s + 4 * S::TILE);  // [MAXG][D]
  float* p_s = q_s + MAXG * D;                      // [MAXG][TK]
  float* c_s = p_s + MAXG * TK;                     // corr [MAXG]
  float* m_s = c_s + MAXG;                          // [MAXG]
  float* l_s = m_s + MAXG;                          // [MAXG]
  float* a_s = l_s + MAXG;                          // [KS][MAXG][D]
  __shared__ int last;

  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long bh = (long)b * hkv + hk;
  const int t_beg = split * chunk;
  const int t_end = min(t_len, t_beg + chunk);
  const int n_tiles = t_end > t_beg ? (t_end - t_beg + TK - 1) / TK : 0;
  const T* kb = k + bh * t_len * D;
  const T* vb = v + bh * t_len * D;
  const unsigned char* vl = valid + bh * t_len;

  for (int idx = tid; idx < g * D; idx += NT) q_s[idx] = to_f32(q[bh * g * D + idx]);

  auto load_tile = [&](int tile) {
    T* dst = kv_s + (tile & 1) * 2 * S::TILE;
    const int t0 = t_beg + tile * TK;
    for (int c = tid; c < TK * CPR; c += NT) {
      const int j = c / CPR, e = (c % CPR) * VN;
      const bool in = t0 + j < t_end;
      const long off = in ? (long)(t0 + j) * D + e : 0;
      cp_async16(dst + j * S::RS + e, kb + off, in);
      cp_async16(dst + S::TILE + j * S::RS + e, vb + off, in);
    }
    cp_async_commit();
  };
  auto key_ok = [&](int tile) {
    const int t = t_beg + tile * TK + lane;
    return t < t_end && vl[t] != 0;
  };

  // rows r = warp + NWP * i of the group: online-softmax state (every lane
  // of the warp holds the same values)
  float m[MAXG / NWP], l[MAXG / NWP];
#pragma unroll
  for (int i = 0; i < MAXG / NWP; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }
  const int col = tid % D, ks = tid / D;  // P·V: value column, key slice
  float acc[MAXG];
#pragma unroll
  for (int r = 0; r < MAXG; ++r) acc[r] = 0.f;

  bool ok_next = false;
  if (n_tiles > 0) {
    load_tile(0);
    ok_next = key_ok(0);
  }
  for (int tile = 0; tile < n_tiles; ++tile) {
    const bool ok = ok_next;
    if (tile + 1 < n_tiles) {
      load_tile(tile + 1);
      ok_next = key_ok(tile + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this tile has landed for every thread; q_s is written
    const T* ks_t = kv_s + (tile & 1) * 2 * S::TILE;
    const T* vs_t = ks_t + S::TILE;

    // logits: lane = key, warp = row (mod 4)
#pragma unroll
    for (int i = 0; i < MAXG / NWP; ++i) {
      const int r = warp + NWP * i;
      if (r < g) {
        float s = 0.f;
#pragma unroll 4
        for (int e = 0; e < D; e += VN) {
          float kx[VN];
          Vec<T>::load(ks_t + lane * S::RS + e, kx);
#pragma unroll
          for (int u = 0; u < VN; u += 4) {
            const float4 qv = *reinterpret_cast<const float4*>(q_s + r * D + e + u);
            s = fmaf(qv.x, kx[u], s);
            s = fmaf(qv.y, kx[u + 1], s);
            s = fmaf(qv.z, kx[u + 2], s);
            s = fmaf(qv.w, kx[u + 3], s);
          }
        }
        s = ok ? s * scale : kNegInf;
        const float m_new = fmaxf(m[i], warp_max(s));
        const float corr = expf(m[i] - m_new);
        const float p = ok ? expf(s - m_new) : 0.f;
        l[i] = l[i] * corr + warp_sum(p);
        m[i] = m_new;
        p_s[r * TK + lane] = p;
        if (lane == 0) c_s[r] = corr;
      }
    }
    __syncthreads();

    // p·v: this thread's value column, keys j ≡ ks (mod KS), every row
#pragma unroll
    for (int r = 0; r < MAXG; ++r)
      if (r < g) acc[r] *= c_s[r];
#pragma unroll 4
    for (int j = ks; j < TK; j += KS) {
      const float vv = to_f32(vs_t[j * S::RS + col]);
#pragma unroll
      for (int r = 0; r < MAXG; ++r)
        if (r < g) acc[r] = fmaf(p_s[r * TK + j], vv, acc[r]);
    }
    __syncthreads();  // the buffers of this tile are free for tile + 2
  }

  // the block's state: m, l per row; o = the key slices' sum
#pragma unroll
  for (int i = 0; i < MAXG / NWP; ++i) {
    const int r = warp + NWP * i;
    if (r < g && lane == 0) {
      m_s[r] = m[i];
      l_s[r] = l[i];
    }
  }
  if (tid < KS * D) {
#pragma unroll
    for (int r = 0; r < MAXG; ++r)
      if (r < g) a_s[(ks * MAXG + r) * D + col] = acc[r];
  }
  __syncthreads();

  T* ob = o + bh * g * D;
  if (n_split == 1) {
    for (int idx = tid; idx < g * D; idx += NT) {
      const int r = idx / D, d = idx % D;
      float os = 0.f;
      for (int s = 0; s < KS; ++s) os += a_s[(s * MAXG + r) * D + d];
      store(&ob[idx], os / fmaxf(l_s[r], 1e-30f));
    }
    return;
  }

  const long pbase = (bh * n_split + split) * g;  // this split's rows in scratch
  for (int idx = tid; idx < g * D; idx += NT) {
    const int r = idx / D, d = idx % D;
    float os = 0.f;
    for (int s = 0; s < KS; ++s) os += a_s[(s * MAXG + r) * D + d];
    part_o[pbase * D + idx] = os;
  }
  if (tid < g) {
    part_m[pbase + tid] = m_s[tid];
    part_l[pbase + tid] = l_s[tid];
  }
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

  // merge the n partials in split order: global max, rescale, sum, divide
  const long base = bh * n_split * g;
  for (int idx = tid; idx < g * D; idx += NT) {
    const int r = idx / D, d = idx % D;
    float mg = kNegInf;
    for (int s = 0; s < n_split; ++s) mg = fmaxf(mg, __ldcg(&part_m[base + s * g + r]));
    float lg = 0.f, og = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const long row = base + s * g + r;
      const float c = expf(__ldcg(&part_m[row]) - mg);
      lg = fmaf(__ldcg(&part_l[row]), c, lg);
      og = fmaf(__ldcg(&part_o[row * D + d]), c, og);
    }
    store(&ob[idx], og / fmaxf(lg, 1e-30f));
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* valid, void* o,
                   float* part_m, float* part_l, float* part_o, int* counters, int b, int hkv,
                   int t_len, int g, int n_split, int chunk, float scale,
                   cudaStream_t stream) {
  constexpr int bytes = Smem<T, D>::bytes();
  cudaError_t err = cudaFuncSetAttribute(
      paged_split_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(n_split, hkv, b);
  paged_split_kernel<T, D><<<grid, NT, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const unsigned char*>(valid), static_cast<T*>(o), part_m, part_l, part_o,
      counters, hkv, t_len, g, n_split, chunk, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int d, const void* q, const void* k, const void* v, const void* valid,
                       void* o, float* pm, float* pl, float* po, int* counters, int b,
                       int hkv, int t_len, int g, int n_split, int chunk, float scale,
                       cudaStream_t st) {
  switch (d) {
    case 32: return launch<T, 32>(q, k, v, valid, o, pm, pl, po, counters, b, hkv, t_len, g, n_split, chunk, scale, st);
    case 64: return launch<T, 64>(q, k, v, valid, o, pm, pl, po, counters, b, hkv, t_len, g, n_split, chunk, scale, st);
    case 128: return launch<T, 128>(q, k, v, valid, o, pm, pl, po, counters, b, hkv, t_len, g, n_split, chunk, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace h2eal

// part_m/part_l: (B, Hkv, n_split, g) f32 and part_o (B, Hkv, n_split, g, D)
// f32 scratch (unused when n_split == 1); counters: >= B·Hkv int32, all 0
extern "C" int h2eal_paged_attention(const void* q, const void* k, const void* v,
                                     const void* valid, void* o, void* part_m, void* part_l,
                                     void* part_o, void* counters, int dtype, int b, int hkv,
                                     int t_len, int g, int d, int n_split, int chunk,
                                     float scale, void* stream) {
  using namespace h2eal;
  if (g < 1 || g > MAXG || n_split < 1 || chunk < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  float* po = static_cast<float*>(part_o);
  int* cnt = static_cast<int*>(counters);
  if (dtype == kF32)
    return dispatch_d<float>(d, q, k, v, valid, o, pm, pl, po, cnt, b, hkv, t_len, g, n_split, chunk, scale, st);
  if (dtype == kBF16)
    return dispatch_d<__nv_bfloat16>(d, q, k, v, valid, o, pm, pl, po, cnt, b, hkv, t_len, g, n_split, chunk, scale, st);
  return cudaErrorInvalidValue;
}
