// The upload codec's quantizer, four entries over one templated body.
//
//   quantize_cols:          out[i, j] = j < kcols[i] ? Q(x[i, j]) : f[i, j]
//   ef_accumulate:          out[i, j] = h[i, j] + Q(z[i, j] - h[i, j])
//   private_quantize_cols:  y = x[i, j] * clipf[i] + b[i] * lap[i, j], then
//                           the select of quantize_cols on Q(y)
//   quantize:               out[i, j] = Q(x[i, j])
//
// with Q(v) = clip(floor(v / delta + u), -L, L) * delta on the grid of row
// i, delta = scale[i] * f32(1 / L), u = dither * 2^-32 or 1/2 without a
// dither plane, and exact zeros on a row whose delta is not positive.
//
// Replaces the TPU kernels src/repro/kernels/quant/batch.py::
// _quant_cols_kernel, ef.py::_ef_kernel, privacy.py::_private_cols_kernel
// and quant.py::_quant_kernel. The TPU kernels tile the columns into VMEM
// blocks with every row inside; here one launch covers the (R, n) layout
// with blockIdx.y as the row.
//
// Bound on the H100: bytes. Per element quantize_cols reads x, f and the
// dither and writes out (16 bytes in f32), ef_accumulate the same,
// private_quantize_cols adds the Laplace plane (20), quantize drops f (12);
// about 10 flops per element is far below the ridge point. Design: one
// thread per element in a grid-stride loop, the per-row scalars read once
// per thread, f32 math for f32 and bf16 storage, and no read of a dither
// plane in the deterministic variants.
//
// Exactness: the file is built with --fmad=false and without fast math, so
// every operation below rounds on its own; the divide is __fdiv_rn and the
// uint32-to-f32 conversion __uint2float_rn, as XLA computes them. The FMAs
// sit where jitted XLA contracts one and nowhere else: fma(q, delta, h) in
// ef_accumulate (h + 0 on a row with delta <= 0) and fma(x, clipf, b * lap)
// in private_quantize_cols.
#include <stdint.h>

#include "common.cuh"

namespace {

enum Mode { kQuantize = 0, kCols = 1, kEf = 2, kPrivate = 3 };

struct Args {
  const void* x;          // X, or Z for ef_accumulate
  const void* f;          // fallback F, or H for ef_accumulate
  const uint32_t* u32;    // dither plane, or null for u = 1/2
  const float* lap;       // unit-Laplace plane (private only)
  const float* scale;     // (R,)
  const int32_t* kcols;   // (R,) live columns (cols and private)
  const float* clipf;     // (R,) (private only)
  const float* noise_b;   // (R,) (private only)
  void* out;
  long long n;
  float levels;           // L
  float inv_levels;       // f32(1 / L)
};

template <typename T, int MODE>
__global__ void quant_kernel(Args a) {
  const long long row = blockIdx.y;
  const long long base = row * a.n;
  const T* x = static_cast<const T*>(a.x) + base;
  const T* f = static_cast<const T*>(a.f) + base;
  T* out = static_cast<T*>(a.out) + base;
  const float delta = __fmul_rn(a.scale[row], a.inv_levels);
  const bool pos = delta > 0.0f;
  const float safe = pos ? delta : 1.0f;
  const long long live = (MODE == kCols || MODE == kPrivate)
                             ? static_cast<long long>(a.kcols[row])
                             : a.n;
  float cf = 0.0f, b = 0.0f;
  if (MODE == kPrivate) {
    cf = a.clipf[row];
    b = a.noise_b[row];
  }
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long j = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       j < a.n; j += stride) {
    if (j >= live) {  // a dead column passes the fallback through untouched
      out[j] = f[j];
      continue;
    }
    float v;
    float h = 0.0f;
    if (MODE == kEf) {
      h = to_f32(f[j]);
      v = __fsub_rn(to_f32(x[j]), h);
    } else if (MODE == kPrivate) {
      v = __fmaf_rn(to_f32(x[j]), cf, __fmul_rn(b, a.lap[base + j]));
    } else {
      v = to_f32(x[j]);
    }
    const float u = a.u32 == nullptr
                        ? 0.5f
                        : __fmul_rn(__uint2float_rn(a.u32[base + j]),
                                    0x1p-32f);
    float q = floorf(__fadd_rn(__fdiv_rn(v, safe), u));
    // jnp.clip(q, -L, L): a NaN stays NaN
    q = q < -a.levels ? -a.levels : q;
    q = q > a.levels ? a.levels : q;
    float r;
    if (MODE == kEf) {
      r = pos ? __fmaf_rn(q, safe, h) : __fadd_rn(h, 0.0f);
    } else {
      r = pos ? __fmul_rn(q, safe) : 0.0f;
    }
    out[j] = from_f32<T>(r);
  }
}

template <typename T, int MODE>
int launch(const Args& a, long long rows, void* stream) {
  constexpr int kThreads = 256;
  long long bx = (a.n + kThreads - 1) / kThreads;
  if (bx > 4096) bx = 4096;
  if (rows > 0 && a.n > 0) {
    dim3 grid(static_cast<unsigned>(bx), static_cast<unsigned>(rows));
    quant_kernel<T, MODE>
        <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int MODE>
int dispatch(int bf16, const Args& a, long long rows, void* stream) {
  return bf16 ? launch<__nv_bfloat16, MODE>(a, rows, stream)
              : launch<float, MODE>(a, rows, stream);
}

Args make_args(const void* x, const void* f, const void* u32, const void* lap,
               const void* scale, const void* kcols, const void* clipf,
               const void* noise_b, void* out, long long n, int levels) {
  Args a;
  a.x = x;
  a.f = f;
  a.u32 = static_cast<const uint32_t*>(u32);
  a.lap = static_cast<const float*>(lap);
  a.scale = static_cast<const float*>(scale);
  a.kcols = static_cast<const int32_t*>(kcols);
  a.clipf = static_cast<const float*>(clipf);
  a.noise_b = static_cast<const float*>(noise_b);
  a.out = out;
  a.n = n;
  a.levels = static_cast<float>(levels);
  a.inv_levels = static_cast<float>(1.0 / static_cast<double>(levels));
  return a;
}

}  // namespace

// Every entry: row-major (rows, n) operands in the output's dtype (bf16 if
// bf16 != 0, else f32) except the f32 per-row scalars and Laplace plane and
// the int32 kcols; u32 may be null (u = 1/2); returns cudaGetLastError().

extern "C" int quantize_cols(int bf16, const void* x, const void* f,
                             const void* u32, const void* scale,
                             const void* kcols, void* out, int levels,
                             long long rows, long long n, void* stream) {
  return dispatch<kCols>(bf16,
                         make_args(x, f, u32, nullptr, scale, kcols, nullptr,
                                   nullptr, out, n, levels),
                         rows, stream);
}

extern "C" int ef_accumulate(int bf16, const void* z, const void* h,
                             const void* u32, const void* scale, void* out,
                             int levels, long long rows, long long n,
                             void* stream) {
  return dispatch<kEf>(bf16,
                       make_args(z, h, u32, nullptr, scale, nullptr, nullptr,
                                 nullptr, out, n, levels),
                       rows, stream);
}

extern "C" int private_quantize_cols(int bf16, const void* x, const void* f,
                                     const void* clipf, const void* noise_b,
                                     const void* scale, const void* kcols,
                                     const void* u32, const void* lap,
                                     void* out, int levels, long long rows,
                                     long long n, void* stream) {
  return dispatch<kPrivate>(bf16,
                            make_args(x, f, u32, lap, scale, kcols, clipf,
                                      noise_b, out, n, levels),
                            rows, stream);
}

extern "C" int quantize(int bf16, const void* x, const void* u32,
                        const void* scale, void* out, int levels,
                        long long rows, long long n, void* stream) {
  return dispatch<kQuantize>(bf16,
                             make_args(x, x, u32, nullptr, scale, nullptr,
                                       nullptr, nullptr, out, n, levels),
                             rows, stream);
}
