// Fused FedEPM client update, paper eq. (20), for all clients at once:
//
//   out[i, j] = wtau[j] + soft(mu[i] * (W[i, j] - wtau[j]) - g[i, j], lam)
//                         / (eta + mu[i])
//
// Replaces the TPU kernel src/repro/kernels/prox/prox.py::_prox_kernel
// (entry prox_update_pallas), which the JAX round launches once per client
// under vmap; here one launch covers the stacked (m, N) state.
//
// Bound on the H100: bytes. Each element reads W and g and writes out
// (12 bytes in f32, 6 in bf16); wtau (N) and mu (m) are read once and stay
// in L2. About 8 flops per element is far below the ridge point.
// Design: one thread per element in a grid-stride loop over the columns,
// the client rows strided over gridDim.y (at most 65535 blocks), so any
// number of clients runs, every access is coalesced and mu[i] is one load
// per thread and row. Math is f32 for f32 and bf16 state. Exactness: the
// file is built with --fmad=false, and the single FMA sits where jitted
// XLA puts one, __fmaf_rn(mu, W - wtau, -g); the divide rounds to nearest.
#include "common.cuh"

namespace {

template <typename T>
__global__ void prox_kernel(const T* __restrict__ wi,
                            const T* __restrict__ wtau,
                            const T* __restrict__ g,
                            const float* __restrict__ mu, float lam,
                            float eta, T* __restrict__ out, long long m,
                            long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long row = blockIdx.y; row < m; row += gridDim.y) {
    const float mu_r = mu[row];
    const float denom = __fadd_rn(eta, mu_r);
    const T* wi_r = wi + row * n;
    const T* g_r = g + row * n;
    T* out_r = out + row * n;
    // not unrolled: unrolled, the f32 loop takes 52 registers, half the
    // SM's threads, and 25% longer on wide rows
#pragma unroll 1
    for (long long j = static_cast<long long>(blockIdx.x) * blockDim.x +
                       threadIdx.x;
         j < n; j += stride) {
      const float t = to_f32(wtau[j]);
      const float d = __fsub_rn(to_f32(wi_r[j]), t);
      const float wt = __fmaf_rn(mu_r, d, -to_f32(g_r[j]));
      // soft(wt, lam) = sign(wt) * max(|wt| - lam, 0), as jnp computes it
      float a = __fsub_rn(fabsf(wt), lam);
      a = a < 0.0f ? 0.0f : a;
      const float sg = wt > 0.0f ? 1.0f : (wt < 0.0f ? -1.0f : wt);
      out_r[j] = from_f32<T>(__fadd_rn(t, __fdiv_rn(sg * a, denom)));
    }
  }
}

template <typename T>
int launch(const void* wi, const void* wtau, const void* g, const void* mu,
           float lam, float eta, void* out, long long m, long long n,
           void* stream) {
  constexpr int kThreads = 256;
  long long bx = (n + kThreads - 1) / kThreads;
  if (bx > 4096) bx = 4096;
  if (m > 0 && n > 0) {
    const long long by = m < 65535 ? m : 65535;
    dim3 grid(static_cast<unsigned>(bx), static_cast<unsigned>(by));
    prox_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(wi), static_cast<const T*>(wtau),
        static_cast<const T*>(g), static_cast<const float*>(mu), lam, eta,
        static_cast<T*>(out), m, n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int prox_update_f32(const void* wi, const void* wtau,
                               const void* g, const void* mu, float lam,
                               float eta, void* out, long long m,
                               long long n, void* stream) {
  return launch<float>(wi, wtau, g, mu, lam, eta, out, m, n, stream);
}

extern "C" int prox_update_bf16(const void* wi, const void* wtau,
                                const void* g, const void* mu, float lam,
                                float eta, void* out, long long m,
                                long long n, void* stream) {
  return launch<__nv_bfloat16>(wi, wtau, g, mu, lam, eta, out, m, n, stream);
}
