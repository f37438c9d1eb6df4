// The threefry2x32 hash of JAX's default PRNG, batched over keys and
// counters, for the port's JAX-compatible random stream (random.py).
//
// For key k (k1, k2) of n_keys and counter j of n, the 64-bit counter
// c = offset + j enters as the pair (hi, lo) = (c >> 32, c & 0xffffffff),
// the layout of jax._src.prng.iota_2x32_shape, and the hash gives (y1, y2):
//   mode 0 (keys):    out[k, j, :] = (y1, y2) as int64, the new keys of
//                     split (offset 0) and fold_in (offset = data, n = 1);
//   mode 1 (bits):    out[k, j] = y1 ^ y2 as int64, jax.random.bits (32);
//   mode 2 (uniform): out[k, j] = the f32 of jax.random.uniform on
//                     [lo, hi): the top 23 bits as a mantissa in [1, 2),
//                     minus 1, then max(lo, fma(f, hi - lo, lo)), the one
//                     FMA that XLA:CPU's jitted uniform computes.
//
// Not a TPU kernel: JAX lowers the hash to XLA elementwise code. Written
// as torch ops it would take about 140 launches per call; here it is one.
// Bound on the H100: 20 rounds of (add, rotate, xor) and six key
// injections of two adds (the key-only sums made once per key) are 72
// integer operations per output, 40 of them rotates and xors that only the
// SM's 64 INT32 lanes take, against 16 (keys), 8 (bits) or 4 (uniform)
// bytes written; at small n the launch itself.
// Built with --fmad=false: the only FMA is the explicit one above.
//
// The rows entry draws the codec's dither over its packed row layout
// (kernels/rows.py) under one key: value j of row r is bits at counter
// base[r] + j, with base[r] = r * (the widest row), which is the value
// jax.random.bits(key, (R, widest)) holds at (r, j) under partitionable
// threefry; so the packed plane is JAX's padded one at its live entries,
// written as 32 bits (4 bytes an output, no int64 plane). Each block of
// ``span`` values finds its row once, by a binary search over the rows'
// first blocks, as the quantizer's packed entries do.
//
// The block entry hashes rows of ``width`` counters each, row p's first
// at offset + p * stride, so value (p, j) of key k is the hash of
// offset + p * stride + j, written at out[k, p * width + j] in any of the
// three modes. The hash (threefry_cuda: split, fold_in, bits, uniform) is
// one row of n counters. The init's block draw is a rank's block of a
// leaf cut on one dim: under partitionable threefry a leaf (A..., N, I...)
// cut on N to [c0, c0 + w) is prod(A) such rows, of width w prod(I),
// stride N prod(I), offset c0 prod(I): the bits of the whole draw at the
// block's values, none other hashed. Grid-stride loops walk the keys
// over z, the rows over y and a row's counters over x, so writes are
// coalesced, a key is read once per row, and no index is divided (two
// 64-bit divisions a value made the hash 45% slower on the H100).
#include <cstdint>

#include "common.cuh"

namespace {

__device__ __forceinline__ uint32_t rotl(uint32_t x, int d) {
  return __funnelshift_l(x, x, d);
}

__device__ __forceinline__ void round4(uint32_t& x0, uint32_t& x1, int r0,
                                       int r1, int r2, int r3) {
  x0 += x1; x1 = rotl(x1, r0); x1 ^= x0;
  x0 += x1; x1 = rotl(x1, r1); x1 ^= x0;
  x0 += x1; x1 = rotl(x1, r2); x1 ^= x0;
  x0 += x1; x1 = rotl(x1, r3); x1 ^= x0;
}

// jax._src.prng._threefry2x32_lowering, unrolled
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0; x1 += k1;
  round4(x0, x1, 13, 15, 26, 6);
  x0 += k1; x1 += k2 + 1u;
  round4(x0, x1, 17, 29, 16, 24);
  x0 += k2; x1 += k0 + 2u;
  round4(x0, x1, 13, 15, 26, 6);
  x0 += k0; x1 += k1 + 3u;
  round4(x0, x1, 17, 29, 16, 24);
  x0 += k1; x1 += k2 + 4u;
  round4(x0, x1, 13, 15, 26, 6);
  x0 += k2; x1 += k0 + 5u;
}

// value ``at`` of the output in ``mode``: the pair, y1 ^ y2, or the
// uniform on [lo, lo + range)
__device__ __forceinline__ void store(void* __restrict__ out, long long at,
                                      int mode, uint32_t x0, uint32_t x1,
                                      float lo, float range) {
  if (mode == 0) {
    int64_t* o = static_cast<int64_t*>(out) + 2 * at;
    o[0] = static_cast<int64_t>(x0);
    o[1] = static_cast<int64_t>(x1);
  } else if (mode == 1) {
    static_cast<int64_t*>(out)[at] = static_cast<int64_t>(x0 ^ x1);
  } else {
    const uint32_t b = ((x0 ^ x1) >> 9) | 0x3F800000u;
    const float f = __fsub_rn(__uint_as_float(b), 1.0f);
    static_cast<float*>(out)[at] = fmaxf(lo, __fmaf_rn(f, range, lo));
  }
}

// 256 threads a block, at most 32 registers a thread: the hash's rounds
// are one chain of dependent operations, so it needs every warp an SM can
// hold to hide their latency (at 33 registers, 6 blocks an SM instead of
// 8, the hash took 20% longer on the H100)
constexpr int kBlockThreads = 256;

__global__ void __launch_bounds__(kBlockThreads, 8)
threefry_block_kernel(const int64_t* __restrict__ keys, long long n_keys,
                      long long rows, long long width,
                      unsigned long long row_stride,
                      unsigned long long offset, int mode, float lo,
                      float hi, void* __restrict__ out) {
  const long long j0 =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j0 >= width) return;
  const float range = __fsub_rn(hi, lo);
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  // this thread's first counter and output in its first row, and the
  // moves to its next row: no multiply inside the loops
  const unsigned long long first =
      offset + static_cast<unsigned long long>(blockIdx.y) * row_stride +
      static_cast<unsigned long long>(j0);
  const unsigned long long next_row =
      static_cast<unsigned long long>(gridDim.y) * row_stride;
  const long long first_at = static_cast<long long>(blockIdx.y) * width + j0;
  const long long next_at = static_cast<long long>(gridDim.y) * width;
  const long long key_at = rows * width;
  for (long long k = blockIdx.z; k < n_keys; k += gridDim.z) {
    const uint32_t k0 = static_cast<uint32_t>(keys[2 * k]);
    const uint32_t k1 = static_cast<uint32_t>(keys[2 * k + 1]);
    unsigned long long row = first;
    long long at = k * key_at + first_at;
    for (long long p = blockIdx.y; p < rows; p += gridDim.y) {
      for (long long j = 0; j < width - j0; j += step) {
        const unsigned long long c = row + static_cast<unsigned long long>(j);
        uint32_t x0 = static_cast<uint32_t>(c >> 32);
        uint32_t x1 = static_cast<uint32_t>(c);
        threefry2x32(k0, k1, x0, x1);
        store(out, at + j, mode, x0, x1, lo, range);
      }
      row += next_row;
      at += next_at;
    }
  }
}

__global__ void threefry_rows_kernel(const int64_t* __restrict__ key,
                                     long long rows,
                                     const long long* __restrict__ row_start,
                                     const long long* __restrict__ row_block,
                                     const long long* __restrict__ row_base,
                                     long long span,
                                     uint32_t* __restrict__ out) {
  __shared__ long long s_row;
  const long long b = blockIdx.x;
  if (threadIdx.x == 0) {
    long long lo = 0, hi = rows - 1;  // the last r with row_block[r] <= b
    while (lo < hi) {
      const long long mid = (lo + hi + 1) >> 1;
      if (row_block[mid] <= b) lo = mid; else hi = mid - 1;
    }
    s_row = lo;
  }
  __syncthreads();
  const long long row = s_row;
  const long long start = row_start[row];
  const long long width = row_start[row + 1] - start;
  const unsigned long long base = static_cast<unsigned long long>(
      row_base[row]);
  const uint32_t k0 = static_cast<uint32_t>(key[0]);
  const uint32_t k1 = static_cast<uint32_t>(key[1]);
  const long long j0 = (b - row_block[row]) * span;
  const long long end = j0 + span < width ? j0 + span : width;
  for (long long j = j0 + threadIdx.x; j < end; j += blockDim.x) {
    const unsigned long long c = base + static_cast<unsigned long long>(j);
    uint32_t x0 = static_cast<uint32_t>(c >> 32);
    uint32_t x1 = static_cast<uint32_t>(c);
    threefry2x32(k0, k1, x0, x1);
    out[start + j] = x0 ^ x1;
  }
}

}  // namespace

extern "C" int threefry_rows_launch(const void* key, long long rows,
                                    const void* row_start,
                                    const void* row_block,
                                    const void* row_base, long long n_blocks,
                                    long long span, void* out,
                                    void* stream) {
  constexpr int kThreads = 256;
  if (rows > 0 && n_blocks > 0) {
    threefry_rows_kernel<<<static_cast<unsigned>(n_blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int64_t*>(key), rows,
        static_cast<const long long*>(row_start),
        static_cast<const long long*>(row_block),
        static_cast<const long long*>(row_base), span,
        static_cast<uint32_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int threefry_block_launch(const void* keys, long long n_keys,
                                     long long rows, long long width,
                                     unsigned long long row_stride,
                                     unsigned long long offset, int mode,
                                     float lo, float hi, void* out,
                                     void* stream) {
  constexpr int kThreads = kBlockThreads;
  if (n_keys > 0 && rows > 0 && width > 0) {
    // about 8192 blocks in all where the work allows (8 waves of the
    // SMs' resident blocks), so a thread takes several counters and the
    // rows loop, not a block's launch, pays for its setup
    long long bx = (width + kThreads - 1) / kThreads;
    if (bx > 1024) bx = 1024;
    const long long bz = n_keys < 65535 ? n_keys : 65535;
    long long by = 8192 / (bx * bz);
    if (by > rows) by = rows;
    if (by > 65535) by = 65535;
    if (by < 1) by = 1;
    dim3 grid(static_cast<unsigned>(bx), static_cast<unsigned>(by),
              static_cast<unsigned>(bz));
    threefry_block_kernel<<<grid, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int64_t*>(keys), n_keys, rows, width, row_stride,
        offset, mode, lo, hi, out);
  }
  return static_cast<int>(cudaGetLastError());
}
