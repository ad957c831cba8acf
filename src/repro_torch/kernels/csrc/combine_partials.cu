// Log-sum-exp combine of stacked flash partials: the cross-stripe epilogue
// of the split-KV decode.
//
// Replaces the TPU kernel repro/kernels/paged_attention.py::combine_partials
// (pl.pallas_call at :211, kernel fn :195), which merges the partials that
// the devices of the coplace_shmap mesh all-gather. Same contract: m, l
// (N,R) f32 and o (N,R,D) f32 for R = B·Hq rows -> out (R,D) f32 =
// sum_i o_i·exp(m_i - max m) / max(sum_i l_i·exp(m_i - max m), 1e-30). A row
// that is empty on every partial (m = -1e30, l = 0, o = 0) gives 0, not NaN.
//
// What bounds it on the H100: memory, (2 + D)·N·R·4 bytes in (262 KB at N=8,
// R=64, D=128) and 4·D·R out, a few FLOP each.
//
// Design: one thread per output element, 256 to a block, looping over the N
// partials in f32 in stripe order; neighbouring threads read neighbouring
// coordinates of o, and the row's m and l are the same address for the
// threads of a row (one cached load).
#include "common.cuh"

namespace h2eal {
namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS) combine_kernel(
    const float* __restrict__ m, const float* __restrict__ l, const float* __restrict__ o,
    float* __restrict__ out, int n, long rows, int d) {
  const long idx = (long)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= rows * d) return;
  const long r = idx / d;
  float mg = kNegInf;
  for (int i = 0; i < n; ++i) mg = fmaxf(mg, m[i * rows + r]);
  float lg = 0.f, og = 0.f;
  for (int i = 0; i < n; ++i) {
    const float c = expf(m[i * rows + r] - mg);
    lg = fmaf(l[i * rows + r], c, lg);
    og = fmaf(o[i * rows * d + idx], c, og);
  }
  out[idx] = og / fmaxf(lg, 1e-30f);
}

}  // namespace
}  // namespace h2eal

extern "C" int h2eal_combine_partials(const void* m, const void* l, const void* o, void* out,
                                      int n, int rows, int d, void* stream) {
  using namespace h2eal;
  if (n < 1 || rows < 1 || d < 1) return cudaErrorInvalidValue;
  const long total = (long)rows * d;
  const unsigned blocks = static_cast<unsigned>((total + THREADS - 1) / THREADS);
  combine_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(m), static_cast<const float*>(l), static_cast<const float*>(o),
      static_cast<float*>(out), n, rows, d);
  return cudaGetLastError();
}
