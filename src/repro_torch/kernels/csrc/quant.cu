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
// blocks with every row inside. Here the three column-bounded entries take
// the codec's packed row layout (kernels/rows.py): every row of a dtype
// group back to back, no padding, with per-row tables of flat starts and
// first blocks. Each block of ROW_SPAN values finds its row once, by a
// binary search over the first-block table, and walks its slice of that
// row, so a short row launches few blocks. ``quantize`` keeps the uniform
// (R, n) layout and loops the rows over gridDim.y with a stride, so no
// entry caps the row count.
//
// Bound on the H100: bytes. Per element quantize_cols reads x, f and the
// dither and writes out (16 bytes in f32), ef_accumulate the same,
// private_quantize_cols adds the Laplace plane (20), quantize drops f (12);
// about 10 flops per element is far below the ridge point. Design: a
// block's threads walk its slice of one row at a stride of the block
// (coalesced), the per-row scalars read once per thread, the row tables
// once per block, f32 math for f32 and bf16 storage, and no read of a dither
// plane in the deterministic variants. The dither and Laplace planes share
// the values' layout (packed or (R, n)), so value, dither and noise of an
// element sit at one flat index.
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
  const long long* row_start;  // (R + 1,) flat row offsets (packed)
  const long long* row_block;  // (R + 1,) first block of each row (packed)
  long long rows;
  long long n;            // row width of the (R, n) layout (quantize)
  long long span;         // values of one row a block walks (packed)
  float levels;           // L
  float inv_levels;       // f32(1 / L)
};

// Row ``row``'s columns j = first, first + step, ... below ``end``; its
// values start at flat index ``base``, its width is ``width``.
template <typename T, int MODE>
__device__ __forceinline__ void quant_row(const Args& a, long long row,
                                          long long base, long long width,
                                          long long first, long long end,
                                          long long step) {
  const T* x = static_cast<const T*>(a.x) + base;
  const T* f = static_cast<const T*>(a.f) + base;
  T* out = static_cast<T*>(a.out) + base;
  const float delta = __fmul_rn(a.scale[row], a.inv_levels);
  const bool pos = delta > 0.0f;
  const float safe = pos ? delta : 1.0f;
  const long long live = (MODE == kCols || MODE == kPrivate)
                             ? static_cast<long long>(a.kcols[row])
                             : width;
  float cf = 0.0f, b = 0.0f;
  if (MODE == kPrivate) {
    cf = a.clipf[row];
    b = a.noise_b[row];
  }
  // not unrolled: unrolled, the f32 loops take 34-43 registers and run
  // 10-20% longer
#pragma unroll 1
  for (long long j = first; j < end; j += step) {
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

// The packed layout: block b owns ROW_SPAN values of the row r with
// row_block[r] <= b < row_block[r + 1], found once by thread 0.
template <typename T, int MODE>
__global__ void quant_kernel_packed(Args a) {
  __shared__ long long s_row;
  const long long b = blockIdx.x;
  if (threadIdx.x == 0) {
    long long lo = 0, hi = a.rows - 1;  // the last r with row_block[r] <= b
    while (lo < hi) {
      const long long mid = (lo + hi + 1) >> 1;
      if (a.row_block[mid] <= b) lo = mid; else hi = mid - 1;
    }
    s_row = lo;
  }
  __syncthreads();
  const long long row = s_row;
  const long long base = a.row_start[row];
  const long long width = a.row_start[row + 1] - base;
  const long long j0 = (b - a.row_block[row]) * a.span;
  const long long end = j0 + a.span < width ? j0 + a.span : width;
  quant_row<T, MODE>(a, row, base, width, j0 + threadIdx.x, end,
                     blockDim.x);
}

// The uniform (R, n) layout: a grid-stride loop over the columns, the
// rows strided over gridDim.y.
template <typename T, int MODE>
__global__ void quant_kernel_rows(Args a) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long row = blockIdx.y; row < a.rows; row += gridDim.y) {
    quant_row<T, MODE>(a, row, row * a.n, a.n,
                       static_cast<long long>(blockIdx.x) * blockDim.x +
                           threadIdx.x,
                       a.n, stride);
  }
}

constexpr int kThreads = 256;

template <typename T, int MODE>
int launch_packed(const Args& a, long long n_blocks, void* stream) {
  if (a.rows > 0 && n_blocks > 0) {
    quant_kernel_packed<T, MODE>
        <<<static_cast<unsigned>(n_blocks), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int MODE>
int launch_rows(const Args& a, void* stream) {
  long long bx = (a.n + kThreads - 1) / kThreads;
  if (bx > 4096) bx = 4096;
  const long long by = a.rows < 65535 ? a.rows : 65535;
  if (a.rows > 0 && a.n > 0) {
    dim3 grid(static_cast<unsigned>(bx), static_cast<unsigned>(by));
    quant_kernel_rows<T, MODE>
        <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int MODE>
int dispatch_packed(int bf16, const Args& a, long long n_blocks,
                    void* stream) {
  return bf16 ? launch_packed<__nv_bfloat16, MODE>(a, n_blocks, stream)
              : launch_packed<float, MODE>(a, n_blocks, stream);
}

Args make_args(const void* x, const void* f, const void* u32, const void* lap,
               const void* scale, const void* kcols, const void* clipf,
               const void* noise_b, void* out, int levels) {
  Args a = {};
  a.x = x;
  a.f = f;
  a.u32 = static_cast<const uint32_t*>(u32);
  a.lap = static_cast<const float*>(lap);
  a.scale = static_cast<const float*>(scale);
  a.kcols = static_cast<const int32_t*>(kcols);
  a.clipf = static_cast<const float*>(clipf);
  a.noise_b = static_cast<const float*>(noise_b);
  a.out = out;
  a.levels = static_cast<float>(levels);
  a.inv_levels = static_cast<float>(1.0 / static_cast<double>(levels));
  return a;
}

Args packed(Args a, const void* row_start, const void* row_block,
            long long rows, long long span) {
  a.row_start = static_cast<const long long*>(row_start);
  a.row_block = static_cast<const long long*>(row_block);
  a.rows = rows;
  a.span = span;
  return a;
}

}  // namespace

// The column-bounded entries take flat packed operands in the output's
// dtype (bf16 if bf16 != 0, else f32), except the f32 per-row scalars and
// Laplace plane and the int32 kcols, with the layout's row_start and
// row_block tables (int64, rows + 1 each) and its block count at ``span``
// values a block. ``quantize`` takes row-major (rows, n) operands. u32 may
// be null (u = 1/2). Every entry returns cudaGetLastError().

extern "C" int quantize_cols(int bf16, const void* x, const void* f,
                             const void* u32, const void* scale,
                             const void* kcols, void* out, int levels,
                             const void* row_start, const void* row_block,
                             long long rows, long long n_blocks,
                             long long span, void* stream) {
  return dispatch_packed<kCols>(
      bf16,
      packed(make_args(x, f, u32, nullptr, scale, kcols, nullptr, nullptr,
                       out, levels),
             row_start, row_block, rows, span),
      n_blocks, stream);
}

extern "C" int ef_accumulate(int bf16, const void* z, const void* h,
                             const void* u32, const void* scale, void* out,
                             int levels, const void* row_start,
                             const void* row_block, long long rows,
                             long long n_blocks, long long span,
                             void* stream) {
  return dispatch_packed<kEf>(
      bf16,
      packed(make_args(z, h, u32, nullptr, scale, nullptr, nullptr, nullptr,
                       out, levels),
             row_start, row_block, rows, span),
      n_blocks, stream);
}

extern "C" int private_quantize_cols(int bf16, const void* x, const void* f,
                                     const void* clipf, const void* noise_b,
                                     const void* scale, const void* kcols,
                                     const void* u32, const void* lap,
                                     void* out, int levels,
                                     const void* row_start,
                                     const void* row_block, long long rows,
                                     long long n_blocks, long long span,
                                     void* stream) {
  return dispatch_packed<kPrivate>(
      bf16,
      packed(make_args(x, f, u32, lap, scale, kcols, clipf, noise_b, out,
                       levels),
             row_start, row_block, rows, span),
      n_blocks, stream);
}

extern "C" int quantize(int bf16, const void* x, const void* u32,
                        const void* scale, void* out, int levels,
                        long long rows, long long n, void* stream) {
  Args a = make_args(x, x, u32, nullptr, scale, nullptr, nullptr, nullptr,
                     out, levels);
  a.rows = rows;
  a.n = n;
  return bf16 ? launch_rows<__nv_bfloat16, kQuantize>(a, stream)
              : launch_rows<float, kQuantize>(a, stream);
}
