// Elastic-Net Solver (ENS), paper eq. (19) / Algorithm 1: per coordinate j,
// order statistic m (0-based) of the 2m+1 values {Z[0, j] .. Z[m-1, j]} and
// {c_a = mean_j + offs[a] : a = 0..m}, in f32, stored in Z's dtype.
//
// Replaces the TPU kernels src/repro/kernels/ens/ens.py::_ens_kernel (:54)
// and _bitonic_sort_axis0 (:32) (entry ens_pallas). The TPU sorts all 2m+1
// values, sentinel-padded to a power of two, with a bitonic network on its
// vector unit, and takes the middle row.
//
// Bound on the H100: bytes (m*n reads of Z, n writes); a linear-time
// selection is far below the ridge point. What this design spends above
// that is the sort of the m client values: O(m log^2 m) min/max per
// coordinate (1792 compare-exchanges at m = 128), the same for any data.
// Nothing ends early and nothing falls back to quadratic work.
//
// Design:
// - Only the m client values are sorted: a bitonic network over
//   P = next_pow2(m) with +inf pads above them. The m+1 candidates need no
//   sort: offs (ens_offsets) is monotone in a and rounding is monotone, so
//   the computed c_a are in order too. They descend when lam/eta < 0; the
//   kernel sees that as offs[0] > offs[m] and reads them backwards.
// - Selection: with A the sorted clients and C the ascending candidates,
//   order statistic m of the union is
//       min(C[m], min over i = 0..m-1 of max(A[i], C[m-1-i])),
//   the least value at or above which some split of m+1 values lies. This
//   is the merge-path search taken as a min over all m+1 splits rather
//   than a binary search: O(m), with every index into A known at compile
//   time, so A stays in registers (a binary search would index the
//   register array at run time and move it to local memory). An order
//   statistic's value does not depend on how ties are ordered, so the
//   result is the plain version's torch.sort(...).values[m].
// - The mean is a sequential __fadd_rn sum over rows 0..m-1 from 0, times
//   the f32 reciprocal of m: the plain version's order (and XLA:CPU's at
//   m <= 32), so the two agree bit for bit. It is taken before the sort.
// - Two layouts, one launch per leaf; the wrapper picks by n.
//   ens_kernel_thread, for wide leaves: one thread per coordinate, so
//   neighbouring threads read neighbouring columns (coalesced); the column
//   lives in P registers and the fully unrolled network is two min/max per
//   compare-exchange, with no shared memory.
//   ens_kernel_warp, for narrow leaves (the main path's n = 14): one warp
//   per coordinate. Lane l holds rows l*E .. l*E+E-1, E = max(32, P)/32;
//   network steps within a lane are register swaps, steps across lanes
//   __shfl_xor_sync. Every lane sums the mean from values shuffled to it in
//   row order, and the selection is a min within each lane, then over the
//   warp.
// - The thread and warp layouts take m <= 128 (kMaxClients): the thread
//   layout keeps the column in P registers of a thread's 255.
//   ens_kernel_block, for m > 128: one block of 256 threads per group of C
//   columns. Each column's m values, padded to P with +inf, sit in shared
//   memory (row stride P + 1, so the per-column mean's threads hit distinct
//   banks); one thread per column sums its mean in row order, the block
//   sorts all C columns with one bitonic network (each step one pass over
//   the C*P/2 pairs, then a barrier), writes max(A[i], C[m-1-i]) in place
//   and min-reduces it as a tree. C is chosen by the wrapper (ens.py) so
//   the columns fill about 64 KB, and a narrow leaf gets one block per
//   column, spread over the SMs; a column too large for the 227 KB a
//   block may hold (m > 32768) sorts in a device scratch buffer the wrapper
//   allocates, one slice per block, with the blocks striding over the
//   column groups.
#include "common.cuh"

namespace {

constexpr int kBlock = 128;  // threads per block in both layouts
constexpr int kWarps = kBlock / 32;
constexpr int kMaxClients = 128;
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ constexpr int log2_of(int p) {
  return p <= 1 ? 0 : 1 + log2_of(p / 2);
}

__device__ __forceinline__ float pos_inf() {
  return __int_as_float(0x7f800000);
}

// Stage the m+1 offsets in shared memory (the whole block); true when they
// descend.
__device__ __forceinline__ bool stage_offsets(const float* __restrict__ offs,
                                              float* s_offs, int m) {
  for (int a = threadIdx.x; a <= m; a += blockDim.x) s_offs[a] = offs[a];
  __syncthreads();
  return s_offs[0] > s_offs[m];
}

// Candidate t of the ascending order.
__device__ __forceinline__ float cand(float mean, const float* s_offs, int m,
                                      bool desc, int t) {
  return __fadd_rn(mean, s_offs[desc ? m - t : t]);
}

__device__ __forceinline__ float mean_of(float sum, int m) {
  return __fmul_rn(sum, __fdiv_rn(1.0f, static_cast<float>(m)));
}

template <typename T, int P>
__global__ void __launch_bounds__(kBlock)
    ens_kernel_thread(const T* __restrict__ z, const float* __restrict__ offs,
                      T* __restrict__ out, int m, long long n) {
  constexpr int kLogP = log2_of(P);
  __shared__ float s_offs[P + 1];
  const bool desc = stage_offsets(offs, s_offs, m);
  const long long j =
      static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
  if (j >= n) return;

  float r[P];
#pragma unroll
  for (int i = 0; i < P; ++i)
    r[i] = i < m ? to_f32(z[static_cast<long long>(i) * n + j]) : pos_inf();
  float sum = 0.0f;
#pragma unroll
  for (int i = 0; i < P; ++i)
    if (i < m) sum = __fadd_rn(sum, r[i]);
  const float mean = mean_of(sum, m);

  // bitonic sort, ascending: stage k merges runs of k, step s pairs i, i^s
#pragma unroll
  for (int kk = 1; kk <= kLogP; ++kk) {
#pragma unroll
    for (int ss = kk - 1; ss >= 0; --ss) {
#pragma unroll
      for (int i = 0; i < P; ++i) {
        const int l = i ^ (1 << ss);
        if (l > i) {
          const float lo = fminf(r[i], r[l]), hi = fmaxf(r[i], r[l]);
          const bool asc = (i & (1 << kk)) == 0;
          r[i] = asc ? lo : hi;
          r[l] = asc ? hi : lo;
        }
      }
    }
  }

  float med = cand(mean, s_offs, m, desc, m);
#pragma unroll
  for (int i = 0; i < P; ++i)
    if (i < m)
      med = fminf(med, fmaxf(r[i], cand(mean, s_offs, m, desc, m - 1 - i)));
  out[j] = from_f32<T>(med);
}

template <typename T, int E>
__global__ void __launch_bounds__(kBlock)
    ens_kernel_warp(const T* __restrict__ z, const float* __restrict__ offs,
                    T* __restrict__ out, int m, long long n) {
  constexpr int kLogW = log2_of(32 * E);
  __shared__ float s_offs[32 * E + 1];
  const bool desc = stage_offsets(offs, s_offs, m);
  const int lane = threadIdx.x & 31;
  const long long j =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (j >= n) return;  // the whole warp leaves together

  float r[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int row = lane * E + e;
    r[e] = row < m ? to_f32(z[static_cast<long long>(row) * n + j])
                   : pos_inf();
  }
  float sum = 0.0f;
  for (int src = 0; src * E < m; ++src) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const float v = __shfl_sync(kFull, r[e], src);
      if (src * E + e < m) sum = __fadd_rn(sum, v);
    }
  }
  const float mean = mean_of(sum, m);

  // bitonic sort of the 32*E values at positions lane*E + e, ascending
#pragma unroll
  for (int kk = 1; kk <= kLogW; ++kk) {
#pragma unroll
    for (int ss = kk - 1; ss >= 0; --ss) {
      const int s = 1 << ss;
      if (s < E) {  // both elements of a pair in this lane
#pragma unroll
        for (int e = 0; e < E; ++e) {
          if ((e & s) == 0) {
            const int f = e | s;
            const float lo = fminf(r[e], r[f]), hi = fmaxf(r[e], r[f]);
            const bool asc = ((lane * E + e) & (1 << kk)) == 0;
            r[e] = asc ? lo : hi;
            r[f] = asc ? hi : lo;
          }
        }
      } else {  // the partner is lane ^ (s / E), same e
        const int lane_bit = s / E;
        const bool low = (lane & lane_bit) == 0;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float other = __shfl_xor_sync(kFull, r[e], lane_bit);
          const bool asc = ((lane * E + e) & (1 << kk)) == 0;
          r[e] = low == asc ? fminf(r[e], other) : fmaxf(r[e], other);
        }
      }
    }
  }

  float med = lane == 0 ? cand(mean, s_offs, m, desc, m) : pos_inf();
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int row = lane * E + e;
    if (row < m)
      med = fminf(med, fmaxf(r[e], cand(mean, s_offs, m, desc, m - 1 - row)));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    med = fminf(med, __shfl_xor_sync(kFull, med, off));
  if (lane == 0) out[j] = from_f32<T>(med);
}

// The block layout for m > 128: see the note at the top.
template <typename T>
__global__ void __launch_bounds__(kBlock * 2)
    ens_kernel_block(const T* __restrict__ z, const float* __restrict__ offs,
                     T* __restrict__ out, int m, long long n, int P, int C,
                     float* scratch) {
  extern __shared__ float smem[];
  const int stride = P + 1;
  const int half = P / 2;
  float* s_mean = smem;
  float* cols = scratch != nullptr
                    ? scratch + static_cast<long long>(blockIdx.x) * C * stride
                    : smem + C;
  const bool desc = offs[0] > offs[m];
  const long long groups = (n + C - 1) / C;
  for (long long g = blockIdx.x; g < groups; g += gridDim.x) {
    const long long j0 = g * C;
    const int live = static_cast<int>(n - j0 < C ? n - j0 : C);
    // load: neighbouring threads read neighbouring columns of one row
    for (int e = threadIdx.x; e < P * C; e += blockDim.x) {
      const int i = e / C, c = e - i * C;
      cols[c * stride + i] =
          i < m && c < live
              ? to_f32(z[static_cast<long long>(i) * n + j0 + c])
              : pos_inf();
    }
    __syncthreads();
    for (int c = threadIdx.x; c < live; c += blockDim.x) {
      const float* col = cols + c * stride;
      float sum = 0.0f;
      for (int i = 0; i < m; ++i) sum = __fadd_rn(sum, col[i]);
      s_mean[c] = mean_of(sum, m);
    }
    __syncthreads();
    // bitonic sort, ascending: stage k merges runs of k, step s pairs
    // i, i + s where i has bit s clear
    for (int k = 2; k <= P; k <<= 1) {
      for (int s = k >> 1; s > 0; s >>= 1) {
        for (int e = threadIdx.x; e < half * C; e += blockDim.x) {
          const int c = e / half, p = e - c * half;
          const int i = ((p & ~(s - 1)) << 1) | (p & (s - 1));
          float* col = cols + c * stride;
          const float a = col[i], b = col[i + s];
          const float lo = fminf(a, b), hi = fmaxf(a, b);
          const bool asc = (i & k) == 0;
          col[i] = asc ? lo : hi;
          col[i + s] = asc ? hi : lo;
        }
        __syncthreads();
      }
    }
    // selection: min over i of max(A[i], C[m-1-i]), as a tree of mins
    for (int e = threadIdx.x; e < P * C; e += blockDim.x) {
      const int c = e / P, i = e - c * P;
      float* col = cols + c * stride;
      col[i] = i < m && c < live
                   ? fmaxf(col[i], __fadd_rn(s_mean[c],
                                             offs[desc ? i + 1 : m - 1 - i]))
                   : pos_inf();
    }
    __syncthreads();
    for (int s = half; s > 0; s >>= 1) {
      for (int e = threadIdx.x; e < s * C; e += blockDim.x) {
        const int c = e / s, i = e - c * s;
        float* col = cols + c * stride;
        col[i] = fminf(col[i], col[i + s]);
      }
      __syncthreads();
    }
    for (int c = threadIdx.x; c < live; c += blockDim.x) {
      const float top = __fadd_rn(s_mean[c], offs[desc ? 0 : m]);
      out[j0 + c] = from_f32<T>(fminf(top, cols[c * stride]));
    }
    __syncthreads();  // the next group overwrites the columns and means
  }
}

template <typename T>
int launch_block(const void* zp, const void* offsp, void* outp, int m,
                 long long n, int P, int C, int blocks, void* scratch,
                 void* streamp) {
  if (m < 1 || n < 1 || P < m || C < 1 || blocks < 1)
    return cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(C) +
                       (scratch != nullptr
                            ? 0
                            : static_cast<size_t>(C) * (P + 1)));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ens_kernel_block<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  ens_kernel_block<T><<<blocks, kBlock * 2, smem,
                        static_cast<cudaStream_t>(streamp)>>>(
      static_cast<const T*>(zp), static_cast<const float*>(offsp),
      static_cast<T*>(outp), m, n, P, C, static_cast<float*>(scratch));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int P>
void launch_thread(const T* z, const float* offs, T* out, int m, long long n,
                   cudaStream_t stream) {
  const long long blocks = (n + kBlock - 1) / kBlock;
  ens_kernel_thread<T, P>
      <<<static_cast<unsigned>(blocks), kBlock, 0, stream>>>(z, offs, out, m,
                                                              n);
}

template <typename T, int E>
void launch_warp(const T* z, const float* offs, T* out, int m, long long n,
                 cudaStream_t stream) {
  const long long blocks = (n + kWarps - 1) / kWarps;
  ens_kernel_warp<T, E>
      <<<static_cast<unsigned>(blocks), kBlock, 0, stream>>>(z, offs, out, m,
                                                              n);
}

template <typename T>
int launch(const void* zp, const void* offsp, void* outp, int m, long long n,
           int per_warp, void* streamp) {
  if (m < 1 || m > kMaxClients || n < 1) return cudaErrorInvalidValue;
  const T* z = static_cast<const T*>(zp);
  const float* offs = static_cast<const float*>(offsp);
  T* out = static_cast<T*>(outp);
  cudaStream_t s = static_cast<cudaStream_t>(streamp);
  if (per_warp) {
    if (m <= 32) launch_warp<T, 1>(z, offs, out, m, n, s);
    else if (m <= 64) launch_warp<T, 2>(z, offs, out, m, n, s);
    else launch_warp<T, 4>(z, offs, out, m, n, s);
  } else if (m <= 1) launch_thread<T, 1>(z, offs, out, m, n, s);
  else if (m <= 2) launch_thread<T, 2>(z, offs, out, m, n, s);
  else if (m <= 4) launch_thread<T, 4>(z, offs, out, m, n, s);
  else if (m <= 8) launch_thread<T, 8>(z, offs, out, m, n, s);
  else if (m <= 16) launch_thread<T, 16>(z, offs, out, m, n, s);
  else if (m <= 32) launch_thread<T, 32>(z, offs, out, m, n, s);
  else if (m <= 64) launch_thread<T, 64>(z, offs, out, m, n, s);
  else launch_thread<T, 128>(z, offs, out, m, n, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ens_f32(const void* z, const void* offs, void* out, int m,
                       long long n, int per_warp, void* stream) {
  return launch<float>(z, offs, out, m, n, per_warp, stream);
}

extern "C" int ens_bf16(const void* z, const void* offs, void* out, int m,
                        long long n, int per_warp, void* stream) {
  return launch<__nv_bfloat16>(z, offs, out, m, n, per_warp, stream);
}

extern "C" int ens_block_f32(const void* z, const void* offs, void* out,
                             int m, long long n, int P, int C, int blocks,
                             void* scratch, void* stream) {
  return launch_block<float>(z, offs, out, m, n, P, C, blocks, scratch,
                             stream);
}

extern "C" int ens_block_bf16(const void* z, const void* offs, void* out,
                              int m, long long n, int P, int C, int blocks,
                              void* scratch, void* stream) {
  return launch_block<__nv_bfloat16>(z, offs, out, m, n, P, C, blocks,
                                     scratch, stream);
}

// The card's multiprocessor count and the shared memory a block may opt in
// to, which decide the block layout's shape (the wrapper's block_layout).
extern "C" int ens_device_limits(int device, int* sms, int* smem_optin) {
  cudaError_t e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount,
                                         device);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaDeviceGetAttribute(
      smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device));
}
