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
// Bound on the H100: bytes at decode. The packed codes and the f32 scales are read once:
// the fused qkv of one 7B layer [1792, 4608] is 8.77 MB = 2.6 us at 3.35 TB/s, the int4
// head [1792, 152064] 289.5 MB = 86.4 us. What the PR 7 kernel measured (a CUDA graph
// replayed, H100 80GB HBM3 at 700 W): 0.037 ms at the o and qkv shapes whatever their
// size, so latency and not bytes held it: one 4-byte load per packed row per thread, two
// barriers per group, an I2F per code.
//
// Design: a weight-streaming product over tiles of 128 columns. A block (4 warps) walks
// the packed rows of its K range through a cp.async ring in shared memory (4 stages of
// 32 packed rows x 128 columns, 16-byte copies, one barrier a stage), each
// stage carrying the matching entries of the block's rows of x beside the codes, so a
// block keeps 12-30 KB of loads in flight and nothing is staged behind a per-group
// barrier. K is split over grid.y in whole groups (the wrapper's rule fills the card with
// about four blocks per SM); each split writes f32 partial sums and a second kernel adds
// the splits in a fixed order (no float atomics, so two launches agree bit for bit) and
// rounds to the output dtype. With one split and an output the first kernel writes it.
// N must be a multiple of 16 and G of 32 (the wrapper refuses other shapes). The ring's
// geometry and what one stage does on either route live in csrc/w4_mma.cuh, which the
// fused w4 suffixes (K6, csrc/w4_suffix.cu) include as well.
//
// bf16 x: tensor cores (w4_mma_kernel). The product is taken as y^T = W^T x^T with
//   mma.sync m16n8k16 (bf16 in, f32 accumulate): W^T is the A operand (16 output columns
//   per tile), x^T the B operand (8 rows of x per tile; m <= 8 pads to 8). The MMA sums
//   over its 16 k-slots in any order, so the slots are mapped to packed rows such that
//   ldmatrix.trans of a [16 packed rows x 16 columns] byte tile hands each thread the
//   bytes of its fragment: a 32-bit register holds columns (2g, 2g + 1) of packed rows
//   (2t, 2t + 1), so output row g of the tile is column 2g and row g + 8 is column
//   2g + 1. One register gives two bf16 pairs of low codes and two of high codes: a
//   nibble n goes into the mantissa of 128.0 as n ^ 8 with one lop3, and one bf16x2
//   subtraction of 136.0 leaves the code, exactly (no I2F). The low and high codes feed
//   two MMAs into two fresh f32 accumulators per group, each multiplied by its column's
//   group scale as it joins the output accumulator. 8, 16 or 32 rows of x per block (m >
//   32 tiles over grid.z: the weights are read once per 32 rows).
// f32 x: CUDA cores (w4_fma_kernel; TF32 would break the f32 tolerance). One thread per
//   column; a code becomes f32 through the mantissa of 2^23 (lop3, then one FSUB of
//   2^23 + 8); x is read as float4 broadcasts; 1, 2, 4, 8 or 32 rows of x per block, the
//   group's partial sums in registers, in row order.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "w4_mma.cuh"   // ring geometry, code conversions, one stage of either route


namespace {

constexpr int kReduceThreads = 256;

// The block's K range and ring position, shared by both routes.
struct Walk {
  int ng, g_begin, per_group, nchunks, p_begin;
  __device__ Walk(int kp, int group, int groups_per_split) {
    ng = kp / group;
    g_begin = blockIdx.y * groups_per_split;
    const int g_end = min(ng, g_begin + groups_per_split);
    per_group = group / kRows;
    nchunks = max(0, g_end - g_begin) * per_group;
    p_begin = g_begin * group;
  }
};

// This thread's 16-byte copies of every ring stage, addressed once: kW chunks of packed
// rows (rows t/8 + 16 j, bytes (t % 8) * 16 of the block's 128 columns), then up to kX
// chunks of the block's rows of x (kRows low entries, then kRows high ones); stage c adds
// c kRows rows (codes) or entries (x). Columns past n and rows past m are zero-filled.
template <typename T, int BM>
struct Copies {
  static constexpr int kW = kRows * 8 / kThreads;
  static constexpr int kXc = 2 * kRows * (int)sizeof(T) / 16;   // chunks per x row
  static constexpr int kX = (BM * kXc + kThreads - 1) / kThreads;
  const int8_t* w_src[kW];
  const T* x_src[kX];
  int w_dst[kW], x_dst[kX];
  bool w_in, x_use[kX], x_in[kX];
  size_t w_step;

  __device__ Copies(const int8_t* w_p, const T* x, int p_begin, int col_base, int row0, int m,
                    int kp, int n) {
    const int t = threadIdx.x, ch = t & 7;
    w_in = col_base + ch * 16 < n;
    w_step = (size_t)kRows * n;
#pragma unroll
    for (int j = 0; j < kW; ++j) {
      const int r = (t >> 3) + j * (kThreads / 8);
      w_src[j] = w_in ? w_p + (size_t)(p_begin + r) * n + col_base + ch * 16 : w_p;
      w_dst[j] = r * kWStride + ch * 16;
    }
#pragma unroll
    for (int j = 0; j < kX; ++j) {
      const int i = t + j * kThreads, r = i / kXc, c = i % kXc;
      const int half = c / (kXc / 2), e0 = (c % (kXc / 2)) * (16 / (int)sizeof(T));
      x_use[j] = i < BM * kXc;
      x_in[j] = x_use[j] && row0 + r < m;
      x_src[j] = x_in[j] ? x + (size_t)(row0 + r) * 2 * kp + (size_t)half * kp + p_begin + e0 : x;
      x_dst[j] = kStageW + r * kXStride<T> + c * 16;
    }
  }

  __device__ __forceinline__ void issue(uint8_t* st, int c) const {
    const size_t wo = w_in ? c * w_step : 0;
#pragma unroll
    for (int j = 0; j < kW; ++j) cp_async16(st + w_dst[j], w_src[j] + wo, w_in);
    const int xo = c * kRows;
#pragma unroll
    for (int j = 0; j < kX; ++j)
      if (x_use[j]) cp_async16(st + x_dst[j], x_src[j] + (x_in[j] ? xo : 0), x_in[j]);
  }
};

// ---------------------------------------------------------------- bf16: tensor cores

// grid (ceil(n / 128), splits, ceil(m / (8 NT))); dynamic shared memory
// kStages * kStage<bf16, 8 NT> bytes.
template <int NT>
__global__ void __launch_bounds__(kThreads)
w4_mma_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w_p,
              const float* __restrict__ gscale, __nv_bfloat16* __restrict__ out,
              float* __restrict__ partials, int m, int kp, int n, int group,
              int groups_per_split) {
  using T = __nv_bfloat16;
  constexpr int BM = 8 * NT;
  constexpr int kStg = kStage<T, BM>;
  extern __shared__ __align__(16) uint8_t smem[];
  const int t = threadIdx.x & 3;
  const int col_base = blockIdx.x * kBN, row0 = blockIdx.z * BM;
  const Walk wk(kp, group, groups_per_split);
  const Copies<T, BM> cp(w_p, x, wk.p_begin, col_base, row0, m, kp, n);
  auto load = [&](int c) { cp.issue(smem + (c % kStages) * kStg, c); };

  float acc[2][NT][4], glo[2][NT][4], ghi[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = glo[mt][j][e] = ghi[mt][j][e] = 0.f;

  int col_m[2];
  mma_columns<NT>(col_m, col_base);
  float2 s_lo[2], s_hi[2];

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < wk.nchunks) load(s);
    cp_async_commit();
  }
  for (int c = 0; c < wk.nchunks; ++c) {
    if (c % wk.per_group == 0)   // the group's scales, needed at its end
      mma_scales(s_lo, s_hi, gscale, wk.g_begin + c / wk.per_group, wk.ng, n, n, col_m);
    cp_async_wait<kStages - 2>();
    __syncthreads();   // stage c has landed for every thread; stage c - 1 is consumed
    if (c + kStages - 1 < wk.nchunks) load(c + kStages - 1);
    cp_async_commit();
    const uint8_t* st = smem + (c % kStages) * kStg;
    mma_stage<NT>(glo, ghi, st, st + kStageW);
    if ((c + 1) % wk.per_group == 0) mma_fold<NT>(acc, glo, ghi, s_lo, s_hi);
  }

  // c0, c2 = columns (col, col + 1) of x row 8 j + 2 t; c1, c3 the same of row 8 j + 2 t + 1
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int col = col_m[mt];
    if (col >= n) continue;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + j * 8 + 2 * t + h;
        if (row >= m) continue;
        const float v0 = acc[mt][j][h], v1 = acc[mt][j][2 + h];
        if (partials != nullptr)
          *reinterpret_cast<float2*>(partials + ((size_t)blockIdx.y * m + row) * n + col) =
              make_float2(v0, v1);
        else
          *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * n + col) =
              __floats2bfloat162_rn(v0, v1);
      }
  }
}

// ---------------------------------------------------------------- f32: CUDA cores

// grid (ceil(n / 128), splits, ceil(m / BM)); dynamic shared memory
// kStages * kStage<float, BM> bytes.
template <int BM>
__global__ void __launch_bounds__(kThreads)
w4_fma_kernel(const float* __restrict__ x, const int8_t* __restrict__ w_p,
              const float* __restrict__ gscale, float* __restrict__ out,
              float* __restrict__ partials, int m, int kp, int n, int group,
              int groups_per_split) {
  constexpr int kStg = kStage<float, BM>;
  extern __shared__ __align__(16) uint8_t smem[];
  const int col_base = blockIdx.x * kBN, row0 = blockIdx.z * BM;
  const int col = col_base + threadIdx.x;
  const Walk wk(kp, group, groups_per_split);
  const Copies<float, BM> cp(w_p, x, wk.p_begin, col_base, row0, m, kp, n);
  auto load = [&](int c) { cp.issue(smem + (c % kStages) * kStg, c); };
  float acc[BM], plo[BM], phi[BM];
#pragma unroll
  for (int i = 0; i < BM; ++i) acc[i] = plo[i] = phi[i] = 0.f;
  float s_lo = 0.f, s_hi = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < wk.nchunks) load(s);
    cp_async_commit();
  }
  for (int c = 0; c < wk.nchunks; ++c) {
    if (c % wk.per_group == 0 && col < n) {
      const int gi = wk.g_begin + c / wk.per_group;
      s_lo = __ldg(gscale + (size_t)gi * n + col);
      s_hi = __ldg(gscale + (size_t)(wk.ng + gi) * n + col);
    }
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (c + kStages - 1 < wk.nchunks) load(c + kStages - 1);
    cp_async_commit();
    const uint8_t* st = smem + (c % kStages) * kStg;
    fma_stage<BM>(plo, phi, st + threadIdx.x, reinterpret_cast<const float*>(st + kStageW));
    if ((c + 1) % wk.per_group == 0) fma_fold<BM>(acc, plo, phi, s_lo, s_hi);
  }
  if (col >= n) return;
#pragma unroll
  for (int i = 0; i < BM; ++i) {
    const int row = row0 + i;
    if (row >= m) break;
    if (partials != nullptr)
      partials[((size_t)blockIdx.y * m + row) * n + col] = acc[i];
    else
      out[(size_t)row * n + col] = acc[i];
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

template <typename T, typename K>
cudaError_t launch(K kernel, int bm, size_t stage, const T* x, const int8_t* w_p,
                   const float* gscale, T* out, float* partials, int m, int kp, int n,
                   int group, int splits, cudaStream_t stream) {
  const int per = (kp / group + splits - 1) / splits;
  const dim3 grid((n + kBN - 1) / kBN, splits, (m + bm - 1) / bm);
  const size_t smem = (size_t)kStages * stage;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(x, w_p, gscale, out, partials, m, kp, n, group, per);
  return cudaGetLastError();
}

bool aligned(const void* p, uintptr_t a) { return reinterpret_cast<uintptr_t>(p) % a == 0; }

template <typename T>
cudaError_t run(const void* xv, const void* wv, const void* sv, void* ov, float* partials,
                int m, int kp, int n, int group, int splits, cudaStream_t stream) {
  if (n % 16 != 0 || group % kRows != 0) return cudaErrorInvalidValue;   // supported()
  if (!aligned(xv, 16) || !aligned(wv, 16) || !aligned(sv, 8)) return cudaErrorMisalignedAddress;
  const T* x = static_cast<const T*>(xv);
  const int8_t* w_p = static_cast<const int8_t*>(wv);
  const float* gscale = static_cast<const float*>(sv);
  T* out = static_cast<T*>(ov);
  // one split with an output: the product kernel writes it; otherwise partial sums (+ reduce)
  float* dst = (splits == 1 && out != nullptr) ? nullptr : partials;
  cudaError_t err;
#define AF_W4(K, BM) \
  launch<T>(K, BM, kStage<T, BM>, x, w_p, gscale, out, dst, m, kp, n, group, splits, stream)
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {   // rows_per_block in the wrapper
    err = m <= 8 ? AF_W4(w4_mma_kernel<1>, 8) : m <= 16 ? AF_W4(w4_mma_kernel<2>, 16)
                                              : AF_W4(w4_mma_kernel<4>, 32);
  } else {
    err = m <= 1   ? AF_W4(w4_fma_kernel<1>, 1)
          : m <= 2 ? AF_W4(w4_fma_kernel<2>, 2)
          : m <= 4 ? AF_W4(w4_fma_kernel<4>, 4)
          : m <= 8 ? AF_W4(w4_fma_kernel<8>, 8)
                   : AF_W4(w4_fma_kernel<32>, 32);
  }
#undef AF_W4
  if (err != cudaSuccess || dst == nullptr || out == nullptr) return err;
  const int64_t count = (int64_t)m * n;
  w4_reduce_kernel<T><<<(unsigned)((count + kReduceThreads - 1) / kReduceThreads),
                        kReduceThreads, 0, stream>>>(partials, out, splits, count);
  return cudaGetLastError();
}

}  // namespace

// x [m, 2 kp] (dtype 0 = f32, 1 = bf16), w_p [kp, n] int8, gscale [2 kp / group, n] f32,
// all contiguous. With out != null: out [m, n] in the dtype of x (partials, [splits, m, n]
// f32, is needed when splits > 1). With out == null: only the partial sums of the splits
// into partials (the suffix kernels of csrc/w4_suffix.cu reduce them themselves). n must
// be a multiple of 16 and group of 32 (cudaErrorInvalidValue otherwise), x and w_p
// 16-byte aligned and gscale 8-byte aligned (cudaErrorMisalignedAddress otherwise).
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
