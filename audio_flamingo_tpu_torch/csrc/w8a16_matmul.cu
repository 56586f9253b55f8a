// w8a16 matmul (K4) for Hopper (sm_90a), plain C interface bound with ctypes.
//
// Replaces the Pallas TPU kernel audio_flamingo_tpu/ops/pallas/quant_matmul.py
// `w8a16_matmul` (:44, body `_kernel` :25): y = (x [m, K] @ int8 w [K, N]) * scale [N],
// x f32 or bf16, the product accumulated in f32 over all of K, then scaled per column in
// f32 and rounded once to the output dtype (x's dtype, or f32 for the LM head). Every
// code is widened exactly (the byte is placed in the mantissa of 2^23 and the bias
// subtracted: two instructions, no int-to-float conversion), and a bf16 x is widened to
// f32 in shared memory, so each product is exact in f32 and only the order of the sums
// differs from JAX's. The codes come in one of two layouts:
//   layout 0: [K, N] row-major, JAX's layout (a layer of an [L, K, N] stack is the same
//             call at a pointer offset, so no slice is copied);
//   layout 1: [N, K] row-major, read as its transpose: the tied int8 embedding [V, d]
//             used as the head (`w_q.t()`), never copied to [K, N].
//
// Design, layout 0: a weight-streaming split-K GEMV. 128 threads per block, each owning
// 4 adjacent columns (one aligned 32-bit load per K row), so a block covers 512 columns
// and a warp reads 128 contiguous bytes of one row. The block's rows of x are staged in
// shared memory as f32, 256 K rows at a time, and read as broadcasts. Up to MT = 8 rows
// of x share each weight load (MT = 1, 2, 4 or 8 by m); a larger m is tiled over
// blockIdx.x, which is the fastest-varying grid index, so the row tiles of one column
// block run side by side and re-read its weights from L2 rather than from HBM. K is
// split over blockIdx.y in whole 32-row units until the grid has ~8 blocks per SM (the
// wrapper's TARGET_BLOCKS): the k/v products ([3584, 512]) have one column block and
// would otherwise run on one SM, o and down (N = 3584) on seven. Each split writes f32
// partial sums to a workspace and a second kernel adds the splits in a fixed order and
// applies the scale (no float atomics, so replays are bit-identical); with one split the
// first kernel scales and writes the output itself.
//
// Design, layout 1: one warp per 4 columns, 8 warps per block. Each lane reads 16
// contiguous codes of a column's K row (one 16-byte load per column), so a warp reads
// 512 contiguous bytes of each of its 4 rows per step; x is staged 512 K entries at a
// time in shared memory, transposed so that lane l's 16 entries sit at banks l, l + 32,
// ... (conflict-free reads), and each entry is read once for all 4 columns. The lanes'
// partial sums are added by a shuffle butterfly in a fixed order. There is no K split:
// this layout serves the tied head, whose 152,064 columns give thousands of blocks.
//
// Bound on the H100: bytes. The codes are read once (the f32 scales, x and y are small
// at decode): the int8 head [3584, 152064] is 545 MB = 0.163 ms at 3.35 TB/s; one 7B
// decode step's 197 products read ~7.08 GB = 2.11 ms. The FMAs run on the CUDA cores
// (MT per code); what the simple design leaves: deeper load pipelining (cp.async or TMA
// rings) and tensor-core tiles for larger m, where the library route takes over.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;            // layout 0
constexpr int kCols = 4;                 // columns per thread (one 32-bit load)
constexpr int kBN = kThreads * kCols;    // columns per block (BLOCK_N in the wrapper)
constexpr int kChunk = 256;              // K rows of x staged per step
constexpr int kSplitUnit = 32;           // K rows per split are a multiple of this
constexpr int kNkWarps = 8;              // layout 1
constexpr int kNkWarpCols = 4;           // columns per warp
constexpr int kNkChunk = 512;            // K entries per step: 32 lanes x 16 codes
constexpr int kReduceThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Byte j of `biased` (the four codes XOR 0x80, i.e. code + 128 as an unsigned byte) as
// the exact float code: 2^23 + (code + 128) has the byte as its low mantissa bits.
template <int J>
__device__ __forceinline__ float widen(uint32_t biased) {
  return __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7650 | J)) - 8388736.f;
}

// grid (ceil(m / MT), splits, ceil(n / kBN)); static shared memory MT * kChunk floats.
template <typename TX, typename TO, int MT>
__global__ void __launch_bounds__(kThreads)
w8_kn_kernel(const TX* __restrict__ x, const int8_t* __restrict__ w,
             const float* __restrict__ scale, TO* __restrict__ out,
             float* __restrict__ partials, int m, int k, int n, int rows_per_split) {
  __shared__ float xs[MT][kChunk];
  const int row0 = blockIdx.x * MT;
  const int k_begin = blockIdx.y * rows_per_split;
  const int k_end = min(k, k_begin + rows_per_split);
  const int col0 = (blockIdx.z * kThreads + threadIdx.x) * kCols;
  const bool active = col0 < n;   // n % kCols == 0: a thread's columns are all in or out

  float acc[MT][kCols];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;

  for (int kc = k_begin; kc < k_end; kc += kChunk) {
    const int len = min(kChunk, k_end - kc);
    __syncthreads();   // every thread is done with the previous chunk
    for (int i = threadIdx.x; i < MT * kChunk; i += kThreads) {
      const int r = i / kChunk, t = i - r * kChunk;
      const int row = row0 + r;
      xs[r][t] = (row < m && t < len) ? to_f32(x[(size_t)row * k + kc + t]) : 0.f;
    }
    __syncthreads();
    if (!active) continue;
    const int8_t* wp = w + (size_t)kc * n + col0;
#pragma unroll 8
    for (int t = 0; t < len; ++t) {
      const uint32_t q =
          __ldg(reinterpret_cast<const unsigned int*>(wp + (size_t)t * n)) ^ 0x80808080u;
      const float c0 = widen<0>(q), c1 = widen<1>(q), c2 = widen<2>(q), c3 = widen<3>(q);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const float xv = xs[i][t];
        acc[i][0] = fmaf(xv, c0, acc[i][0]);
        acc[i][1] = fmaf(xv, c1, acc[i][1]);
        acc[i][2] = fmaf(xv, c2, acc[i][2]);
        acc[i][3] = fmaf(xv, c3, acc[i][3]);
      }
    }
  }

  if (!active) return;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int row = row0 + i;
    if (row >= m) break;
    if (partials != nullptr) {
      float4 v = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      *reinterpret_cast<float4*>(partials + ((size_t)blockIdx.y * m + row) * n + col0) = v;
    } else {
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        out[(size_t)row * n + col0 + c] = from_f32<TO>(acc[i][c] * __ldg(scale + col0 + c));
    }
  }
}

// out[i] = (sum over splits s, in order, of partials[s][i]) * scale[col], rounded to TO.
template <typename TO>
__global__ void __launch_bounds__(kReduceThreads)
w8_reduce_kernel(const float* __restrict__ partials, const float* __restrict__ scale,
                 TO* __restrict__ out, int splits, int n, int64_t count) {
  const int64_t i = (int64_t)blockIdx.x * kReduceThreads + threadIdx.x;
  if (i >= count) return;
  float s = 0.f;
  for (int p = 0; p < splits; ++p) s += partials[(size_t)p * count + i];
  out[i] = from_f32<TO>(s * __ldg(scale + i % n));
}

// grid (ceil(m / MT), ceil(n / (kNkWarps * kNkWarpCols))); w is [n, k] row-major.
template <typename TX, typename TO, int MT>
__global__ void __launch_bounds__(kNkWarps * 32)
w8_nk_kernel(const TX* __restrict__ x, const int8_t* __restrict__ w,
             const float* __restrict__ scale, TO* __restrict__ out, int m, int k, int n) {
  // xs[r][j * 32 + l] = x[row0 + r][kc + 16 l + j]: lane l reads its 16 entries conflict-free
  __shared__ float xs[MT][kNkChunk];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * MT;
  const int colw = (blockIdx.y * kNkWarps + warp) * kNkWarpCols;

  float acc[MT][kNkWarpCols];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int c = 0; c < kNkWarpCols; ++c) acc[i][c] = 0.f;

  for (int kc = 0; kc < k; kc += kNkChunk) {
    const int len = min(kNkChunk, k - kc);
    __syncthreads();
    for (int i = threadIdx.x; i < MT * kNkChunk; i += kNkWarps * 32) {
      const int r = i / kNkChunk, rem = i - r * kNkChunk;
      const int j = rem >> 5, l = rem & 31;   // consecutive threads: consecutive banks
      const int t = l * 16 + j;
      const int row = row0 + r;
      xs[r][rem] = (row < m && t < len) ? to_f32(x[(size_t)row * k + kc + t]) : 0.f;
    }
    __syncthreads();
    if (lane * 16 >= len) continue;   // k % 16 == 0: a lane's 16 entries are all in or out
    // the 4 columns' 16 codes each, biased (a missing column's zero bytes widen to 0)
    uint32_t words[kNkWarpCols][4];
#pragma unroll
    for (int c = 0; c < kNkWarpCols; ++c) {
      const int col = colw + c;
      uint4 q = make_uint4(0x80808080u, 0x80808080u, 0x80808080u, 0x80808080u);
      if (col < n) {
        q = __ldg(reinterpret_cast<const uint4*>(w + (size_t)col * k + kc + lane * 16));
        q.x ^= 0x80808080u; q.y ^= 0x80808080u; q.z ^= 0x80808080u; q.w ^= 0x80808080u;
      }
      words[c][0] = q.x; words[c][1] = q.y; words[c][2] = q.z; words[c][3] = q.w;
    }
    // each x entry read from shared memory once, against all 4 columns
#pragma unroll
    for (int wd = 0; wd < 4; ++wd)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        float v[kNkWarpCols];
#pragma unroll
        for (int c = 0; c < kNkWarpCols; ++c)
          v[c] = b == 0 ? widen<0>(words[c][wd]) : b == 1 ? widen<1>(words[c][wd])
               : b == 2 ? widen<2>(words[c][wd]) : widen<3>(words[c][wd]);
        const int j = wd * 4 + b;
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const float xv = xs[i][j * 32 + lane];
#pragma unroll
          for (int c = 0; c < kNkWarpCols; ++c) acc[i][c] = fmaf(xv, v[c], acc[i][c]);
        }
      }
  }

#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int c = 0; c < kNkWarpCols; ++c) {
      float v = acc[i][c];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      acc[i][c] = v;   // the butterfly leaves the same sum in every lane
    }
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int row = row0 + i;
    if (row >= m) break;
#pragma unroll
    for (int c = 0; c < kNkWarpCols; ++c) {
      const int col = colw + c;
      if (col < n && lane == ((i * kNkWarpCols + c) & 31))
        out[(size_t)row * n + col] = from_f32<TO>(acc[i][c] * __ldg(scale + col));
    }
  }
}

template <typename TX, typename TO, int MT>
cudaError_t launch_kn(const void* x, const void* w, const void* scale, void* out,
                      float* partials, int m, int k, int n, int rows_per_split, int splits,
                      cudaStream_t stream) {
  const dim3 grid((m + MT - 1) / MT, splits, (n + kBN - 1) / kBN);
  w8_kn_kernel<TX, TO, MT><<<grid, kThreads, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<TO*>(out),
      splits > 1 ? partials : nullptr, m, k, n, rows_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const int64_t count = (int64_t)m * n;
  w8_reduce_kernel<TO><<<(unsigned)((count + kReduceThreads - 1) / kReduceThreads),
                         kReduceThreads, 0, stream>>>(partials, static_cast<const float*>(scale),
                                                      static_cast<TO*>(out), splits, n, count);
  return cudaGetLastError();
}

template <typename TX, typename TO, int MT>
cudaError_t launch_nk(const void* x, const void* w, const void* scale, void* out, int m,
                      int k, int n, cudaStream_t stream) {
  const int cols_per_block = kNkWarps * kNkWarpCols;
  const dim3 grid((m + MT - 1) / MT, (n + cols_per_block - 1) / cols_per_block);
  w8_nk_kernel<TX, TO, MT><<<grid, kNkWarps * 32, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<TO*>(out), m, k, n);
  return cudaGetLastError();
}

template <typename TX, typename TO, int MT>
cudaError_t launch(const void* x, const void* w, const void* scale, void* out,
                   float* partials, int layout, int m, int k, int n, int rows_per_split,
                   int splits, cudaStream_t stream) {
  return layout == 0 ? launch_kn<TX, TO, MT>(x, w, scale, out, partials, m, k, n,
                                             rows_per_split, splits, stream)
                     : launch_nk<TX, TO, MT>(x, w, scale, out, m, k, n, stream);
}

template <typename TX, typename TO>
cudaError_t run(const void* x, const void* w, const void* scale, void* out, float* partials,
                int layout, int m, int k, int n, int rows_per_split, int splits,
                cudaStream_t stream) {
  if (m <= 1)
    return launch<TX, TO, 1>(x, w, scale, out, partials, layout, m, k, n, rows_per_split,
                             splits, stream);
  if (m <= 2)
    return launch<TX, TO, 2>(x, w, scale, out, partials, layout, m, k, n, rows_per_split,
                             splits, stream);
  if (m <= 4)
    return launch<TX, TO, 4>(x, w, scale, out, partials, layout, m, k, n, rows_per_split,
                             splits, stream);
  return launch<TX, TO, 8>(x, w, scale, out, partials, layout, m, k, n, rows_per_split,
                           splits, stream);
}

}  // namespace

// x [m, k] contiguous (x_dtype 0 = f32, 1 = bf16); w int8, layout 0: [k, n] row-major
// (n % 4 == 0, 4-byte aligned), layout 1: [n, k] row-major (k % 16 == 0, 16-byte
// aligned); scale [n] f32; out [m, n] (out_dtype 0 = f32, 1 = bf16). Layout 0 splits K
// into `splits` runs of `rows_per_split` rows (a multiple of 32; splits = ceil(k /
// rows_per_split)), with partials [splits, m, n] f32 when splits > 1; layout 1 takes
// splits = 1. Returns a cudaError_t value (0 on success).
extern "C" int af_w8a16_matmul(const void* x, const void* w, const void* scale, void* out,
                               void* partials, int x_dtype, int out_dtype, int layout, int m,
                               int k, int n, int rows_per_split, int splits, void* stream) {
  const uintptr_t wp = reinterpret_cast<uintptr_t>(w);
  const bool shape_ok =
      layout == 0 ? (n % kCols == 0 && wp % 4 == 0 && rows_per_split > 0 &&
                     rows_per_split % kSplitUnit == 0 &&
                     splits == (k + rows_per_split - 1) / rows_per_split &&
                     (splits == 1 || partials != nullptr) && n / kBN < 65535)
      : layout == 1 ? (k % 16 == 0 && wp % 16 == 0 && splits == 1 &&
                       n / (kNkWarps * kNkWarpCols) < 65535)
                    : false;
  if (m <= 0 || k <= 0 || n <= 0 || !shape_ok || (x_dtype != 0 && x_dtype != 1) ||
      (out_dtype != 0 && out_dtype != 1) || splits > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partials);
  cudaError_t err;
  if (x_dtype == 0 && out_dtype == 0)
    err = run<float, float>(x, w, scale, out, part, layout, m, k, n, rows_per_split, splits, st);
  else if (x_dtype == 0)
    err = run<float, __nv_bfloat16>(x, w, scale, out, part, layout, m, k, n, rows_per_split,
                                    splits, st);
  else if (out_dtype == 0)
    err = run<__nv_bfloat16, float>(x, w, scale, out, part, layout, m, k, n, rows_per_split,
                                    splits, st);
  else
    err = run<__nv_bfloat16, __nv_bfloat16>(x, w, scale, out, part, layout, m, k, n,
                                            rows_per_split, splits, st);
  return (int)err;
}
