// w4a16 matmul (K5) for Hopper (sm_90a), plain C interface bound with ctypes.
//
// Replaces the Pallas TPU kernels audio_flamingo_tpu/ops/pallas/quant4_matmul.py
// `w4a16_matmul` (:164) and `w4a16_matmul_stacked` (:98): y = x [m, K] @ w4 [K, N] in
// the input dtype (f32 or bf16), with the weights packed in the "halves" layout (packed
// row r holds row r in its low nibble and row r + K/2 in its high nibble, both signed
// 4-bit) and f32 group scales gscale [K/G, N], the low half's K/(2G) groups first. Per
// group the low half of x meets the low codes and the high half the high codes; each
// partial sum is formed in f32 and multiplied by its group scale before it joins the
// accumulator, so the only rounding in bf16 is the output's. The stacked form is the
// same call on one layer: the caller passes that layer's weight and scale pointers (an
// offset into the stacked buffers), so no slice is copied and no layer id is read here.
//
// Design: a weight-streaming GEMV. 128 threads per block, each owning 4 adjacent columns
// (one aligned 32-bit load of packed codes per packed row), so a block covers 512
// columns and a warp reads 128 contiguous bytes per row. The block's x rows of one group
// (low and high half, converted to f32) are staged in shared memory and read as
// broadcasts. Up to MT = 8 rows of x are held per block (MT = 1, 2, 4 or 8 by m); larger
// m is tiled over grid.z, each tile re-reading the weights. The N = 3584 products (o,
// down) have only 7 column blocks, so K is split over grid.y in whole groups until the
// grid has ~8 blocks per SM (the wrapper's TARGET_BLOCKS) to keep enough loads in
// flight; each split writes its f32 partial sums to a workspace and a
// second kernel adds the splits in a fixed order (no float atomics, so the result does
// not change from run to run) and rounds to the output dtype. With one split the first
// kernel writes the output itself.
//
// Bound on the H100: bytes. The packed codes and the f32 scales are read once, x and y
// are small at decode: the fused qkv of one 7B layer [1792, 4608] is 8.77 MB = 2.6 us at
// 3.35 TB/s; the int4 head [1792, 152064] 289.5 MB = 86.4 us. Nibbles are unpacked with
// shifts and converted with I2F on the CUDA cores, two f32 FMAs per packed byte and row
// of x; what the simple design leaves: 16-byte loads with several rows in flight per
// thread, a conversion trick in place of I2F, and tensor-core tiles for m >= 16.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kCols = 4;                 // columns per thread
constexpr int kBN = kThreads * kCols;    // columns per block (BLOCK_N in the wrapper)
constexpr int kMaxGroup = 512;           // MAX_GROUP in the wrapper
constexpr int kReduceThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// grid (ceil(n / kBN), splits, ceil(m / MT)); dynamic shared memory MT * 2 * group floats.
template <typename T, int MT>
__global__ void __launch_bounds__(kThreads)
w4_gemv_kernel(const T* __restrict__ x, const int8_t* __restrict__ w_p,
               const float* __restrict__ gscale, T* __restrict__ out,
               float* __restrict__ partials, int m, int kp, int n, int group,
               int groups_per_split) {
  extern __shared__ float xs[];   // [MT][2][group]: x's low- and high-half entries of a group
  const int ng = kp / group;      // groups per half
  const int k = 2 * kp;
  const int col0 = (blockIdx.x * kThreads + threadIdx.x) * kCols;
  const int row0 = blockIdx.z * MT;
  const int g_begin = blockIdx.y * groups_per_split;
  const int g_end = min(ng, g_begin + groups_per_split);
  const bool vec = (n % kCols) == 0;   // then every 4-column load is 4-byte aligned
  const int span = 2 * group;

  float acc[MT][kCols];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;

  for (int gi = g_begin; gi < g_end; ++gi) {
    __syncthreads();   // every thread is done with the previous group's x
    for (int i = threadIdx.x; i < MT * span; i += kThreads) {
      const int r = i / span, rem = i - r * span;
      const int half = rem / group, t = rem - half * group;
      const int row = row0 + r;
      xs[i] = row < m ? to_f32(x[(size_t)row * k + (size_t)half * kp + (size_t)gi * group + t])
                      : 0.f;
    }
    __syncthreads();
    if (col0 >= n) continue;

    float plo[MT][kCols], phi[MT][kCols];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int c = 0; c < kCols; ++c) plo[i][c] = phi[i][c] = 0.f;

    const int8_t* wrow = w_p + (size_t)gi * group * n + col0;
#pragma unroll 8
    for (int t = 0; t < group; ++t) {
      float lo[kCols], hi[kCols];
      if (vec) {
        const uint32_t w = __ldg(reinterpret_cast<const unsigned int*>(wrow + (size_t)t * n));
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          lo[c] = (float)((int)(w << (28 - 8 * c)) >> 28);
          hi[c] = (float)((int)(w << (24 - 8 * c)) >> 28);
        }
      } else {
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const int b = col0 + c < n ? (int)__ldg(wrow + (size_t)t * n + c) : 0;
          lo[c] = (float)((b << 28) >> 28);
          hi[c] = (float)((b << 24) >> 28);
        }
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const float xl = xs[i * span + t];
        const float xh = xs[i * span + group + t];
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          plo[i][c] = fmaf(xl, lo[c], plo[i][c]);
          phi[i][c] = fmaf(xh, hi[c], phi[i][c]);
        }
      }
    }
    float slo[kCols], shi[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const bool in = col0 + c < n;
      slo[c] = in ? __ldg(gscale + (size_t)gi * n + col0 + c) : 0.f;
      shi[c] = in ? __ldg(gscale + (size_t)(ng + gi) * n + col0 + c) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] += plo[i][c] * slo[c] + phi[i][c] * shi[c];
  }

  if (col0 >= n) return;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int row = row0 + i;
    if (row >= m) break;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = col0 + c;
      if (col >= n) break;
      if (partials != nullptr)
        partials[((size_t)blockIdx.y * m + row) * n + col] = acc[i][c];
      else
        out[(size_t)row * n + col] = from_f32<T>(acc[i][c]);
    }
  }
}

// out[i] = sum over splits s, in order, of partials[s][i], rounded to T.
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
w4_reduce_kernel(const float* __restrict__ partials, T* __restrict__ out, int splits,
                 int64_t count) {
  const int64_t i = (int64_t)blockIdx.x * kReduceThreads + threadIdx.x;
  if (i >= count) return;
  float s = 0.f;
  for (int p = 0; p < splits; ++p) s += partials[(size_t)p * count + i];
  out[i] = from_f32<T>(s);
}

template <typename T, int MT>
cudaError_t launch_gemv(const void* x, const void* w_p, const void* gscale, void* out,
                        float* partials, int m, int kp, int n, int group, int splits,
                        cudaStream_t stream) {
  const int ng = kp / group;
  const int per = (ng + splits - 1) / splits;
  const dim3 grid((n + kBN - 1) / kBN, splits, (m + MT - 1) / MT);
  const size_t smem = (size_t)MT * 2 * group * sizeof(float);
  w4_gemv_kernel<T, MT><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(w_p),
      static_cast<const float*>(gscale), static_cast<T*>(out), partials, m, kp, n, group,
      per);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run(const void* x, const void* w_p, const void* gscale, void* out,
                float* partials, int m, int kp, int n, int group, int splits,
                cudaStream_t stream) {
  // one split with an output: the gemv writes it; otherwise partial sums (+ reduce)
  float* dst = (splits == 1 && out != nullptr) ? nullptr : partials;
  cudaError_t err;
  if (m <= 1)
    err = launch_gemv<T, 1>(x, w_p, gscale, out, dst, m, kp, n, group, splits, stream);
  else if (m <= 2)
    err = launch_gemv<T, 2>(x, w_p, gscale, out, dst, m, kp, n, group, splits, stream);
  else if (m <= 4)
    err = launch_gemv<T, 4>(x, w_p, gscale, out, dst, m, kp, n, group, splits, stream);
  else
    err = launch_gemv<T, 8>(x, w_p, gscale, out, dst, m, kp, n, group, splits, stream);
  if (err != cudaSuccess || dst == nullptr || out == nullptr) return err;
  const int64_t count = (int64_t)m * n;
  w4_reduce_kernel<T><<<(unsigned)((count + kReduceThreads - 1) / kReduceThreads),
                        kReduceThreads, 0, stream>>>(partials, static_cast<T*>(out), splits,
                                                     count);
  return cudaGetLastError();
}

}  // namespace

// x [m, 2 kp] (dtype 0 = f32, 1 = bf16), w_p [kp, n] int8, gscale [2 kp / group, n] f32,
// all contiguous. With out != null: out [m, n] in the dtype of x (partials, [splits, m, n]
// f32, is needed when splits > 1). With out == null: only the partial sums of the splits
// into partials (the suffix kernels of csrc/w4_suffix.cu reduce them themselves).
extern "C" int af_w4a16_matmul(const void* x, const void* w_p, const void* gscale, void* out,
                               void* partials, int dtype, int m, int kp, int n, int group,
                               int splits, void* stream) {
  if (m <= 0 || kp <= 0 || n <= 0 || group <= 0 || group > kMaxGroup || kp % group != 0 ||
      splits <= 0 || splits > kp / group || (dtype != 0 && dtype != 1) ||
      (partials == nullptr && (out == nullptr || splits > 1)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partials);
  cudaError_t err =
      dtype == 0 ? run<float>(x, w_p, gscale, out, part, m, kp, n, group, splits, st)
                 : run<__nv_bfloat16>(x, w_p, gscale, out, part, m, kp, n, group, splits, st);
  return (int)err;
}
