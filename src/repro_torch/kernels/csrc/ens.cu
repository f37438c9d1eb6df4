// Elastic-Net Solver (ENS), paper eq. (19) / Algorithm 1: per coordinate j,
// the median of the 2m+1 values {Z[0, j] .. Z[m-1, j]} and
// {mean_j + offs[a] : a = 0..m}.
//
// Replaces the TPU kernels src/repro/kernels/ens/ens.py::_ens_kernel and
// _bitonic_sort_axis0 (entry ens_pallas). The TPU sorts a sentinel-padded
// power-of-two column with a bitonic network; only the middle order
// statistic is needed, so this kernel selects it without sorting, needing
// neither the sentinels nor the pad.
//
// Bound on the H100: bytes (m*n reads of Z, n writes). A linear-time
// selection would need O(2m+1) compares per coordinate, far below the
// ridge point. This simple design does O((2m+1)^2) compares per coordinate
// in the worst case (about 66k at m = 128), so at large m it is
// compare-bound, not byte-bound; a faster selection is later work.
// Design: one thread per coordinate, so neighbouring threads read
// neighbouring columns of the row-major (m, n) Z, coalesced. The block
// stages its (m, B) tile of Z as f32 in shared memory (33 KB at m = 128,
// B = 64) with the m+1 offsets. The mean is summed in row order from 0 and
// multiplied by the f32 reciprocal of m, as the plain PyTorch version (and
// XLA:CPU for m <= 32) computes it, so the two agree bit for bit. The
// median is the value whose rank interval [#smaller, #not-larger) holds
// rank m; that is exact with ties.
#include "common.cuh"

namespace {

constexpr int kBlock = 64;

template <typename T>
__global__ void ens_kernel(const T* __restrict__ z,
                           const float* __restrict__ offs,
                           T* __restrict__ out, int m, long long n) {
  extern __shared__ float smem[];
  float* s_offs = smem;         // m + 1
  float* tile = smem + m + 1;   // m rows of kBlock
  const int tid = threadIdx.x;
  const long long j = static_cast<long long>(blockIdx.x) * kBlock + tid;
  const bool live = j < n;
  for (int a = tid; a <= m; a += kBlock) s_offs[a] = offs[a];
  for (int i = 0; i < m; ++i)
    tile[i * kBlock + tid] =
        live ? to_f32(z[static_cast<long long>(i) * n + j]) : 0.0f;
  __syncthreads();
  if (!live) return;

  const float* col = tile + tid;  // col[i * kBlock] = Z[i, j]
  float sum = 0.0f;
  for (int i = 0; i < m; ++i) sum = __fadd_rn(sum, col[i * kBlock]);
  const float mean = __fmul_rn(sum, __fdiv_rn(1.0f, static_cast<float>(m)));

  const int total = 2 * m + 1;
  float med = mean;
  for (int k = 0; k < total; ++k) {
    const float x =
        k < m ? col[k * kBlock] : __fadd_rn(mean, s_offs[k - m]);
    int lt = 0, le = 0;
    for (int l = 0; l < m; ++l) {
      const float y = col[l * kBlock];
      lt += y < x;
      le += y <= x;
    }
    for (int a = 0; a <= m; ++a) {
      const float y = __fadd_rn(mean, s_offs[a]);
      lt += y < x;
      le += y <= x;
    }
    if (lt <= m && le > m) {
      med = x;
      break;
    }
  }
  out[j] = from_f32<T>(med);
}

template <typename T>
int launch(const void* z, const void* offs, void* out, int m, long long n,
           void* stream) {
  if (m > 0 && n > 0) {
    const long long blocks = (n + kBlock - 1) / kBlock;
    const size_t smem =
        (static_cast<size_t>(m) + 1 + static_cast<size_t>(m) * kBlock) *
        sizeof(float);
    ens_kernel<T><<<static_cast<unsigned>(blocks), kBlock, smem,
                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(z), static_cast<const float*>(offs),
        static_cast<T*>(out), m, n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ens_f32(const void* z, const void* offs, void* out, int m,
                       long long n, void* stream) {
  return launch<float>(z, offs, out, m, n, stream);
}

extern "C" int ens_bf16(const void* z, const void* offs, void* out, int m,
                        long long n, void* stream) {
  return launch<__nv_bfloat16>(z, offs, out, m, n, stream);
}
