// Fused w4 decode-layer suffixes (K6) for Hopper (sm_90a), plain C interface (ctypes).
//
// Replaces the Pallas TPU kernels audio_flamingo_tpu/ops/pallas/quant4_block.py
// `w4_suffix_a` (:225) and `w4_suffix_b` (:288), which split a decode layer's matmuls
// around its attention:
//   A: act, h = silu(gate) * up, h  where  h = attn @ W_o + h_res (f32),
//      hn = rms(h) * ln2 (f32, rounded to the dtype as the next input), gate|up = hn @ W_gu
//   B: h2, qkv = h2, hn2 @ W_qkv(next layer)  where  h2 = act @ W_down + h (f32),
//      hn2 = rms(h2) * ln1(next layer)
// with rms(h) = h * rsqrt(mean(h^2) + eps) in f32 and the weight applied in f32 after it
// (the kernel's own norm, not the model's rms_norm, which rounds before the weight).
// Outputs are rounded to the input dtype (f32 or bf16); the caller adds the qkv bias.
//
// Design: the RMSNorm between the two products needs the whole row of the first
// product. On the TPU one sequential grid carried it in VMEM; on Hopper blocks do not
// see each other, so each suffix is a few launches on one stream inside one C call:
//   A: split-K w4 GEMV (csrc/w4a16_matmul.cu) of attn @ W_o into f32 partial sums;
//      a row kernel that adds the splits in order plus the residual, keeps h in f32 in
//      shared memory, writes h and the normed hn; the GEMV of hn @ W_gu into partial
//      sums; an elementwise kernel that adds those splits and writes silu(gate) * up.
//   B: the GEMV of act @ W_down; the same row kernel with the next layer's ln1; the
//      GEMV of hn2 @ W_qkv with its fixed-order split reduce into qkv.
// Four launches per suffix (B: three when the qkv product needs no K split). h stays in
// f32 from the product to the norm, as the Pallas kernel's h_scr; no float atomics.
//
// Bound on the H100: bytes, the weights streamed once. 7B, m <= 8: A reads W_o
// [1792, 3584] 6.82 MB and W_gu [1792, 37888] 72.14 MB (codes + f32 scales) = 23.6 us at
// 3.35 TB/s; B reads W_down [9472, 3584] 36.07 MB and W_qkv [1792, 4608] 8.77 MB = 13.4 us.
// What the simple design leaves: the launches between the phases (one persistent launch
// with a grid-wide barrier would remove three), and the GEMV's own limits (see there).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

extern "C" int af_w4a16_matmul(const void* x, const void* w_p, const void* gscale, void* out,
                               void* partials, int dtype, int m, int kp, int n, int group,
                               int splits, void* stream);

namespace {

constexpr int kRowThreads = 512;
constexpr int kActThreads = 256;
constexpr int kMaxRowFloats = 12000;   // the row kernel keeps h in (under) 48 KB of shared memory

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// One block per row r: h = (sum over splits, in order, of partials[s][r]) + residual[r]
// in f32; h_out = h and hn_out = (h * rsqrt(mean(h^2) + eps)) * norm_w, rounded to T.
template <typename T>
__global__ void __launch_bounds__(kRowThreads)
residual_rms_kernel(const float* __restrict__ partials, int splits,
                    const T* __restrict__ residual, const float* __restrict__ norm_w,
                    T* __restrict__ h_out, T* __restrict__ hn_out, int m, int d, float eps) {
  extern __shared__ float hs[];                 // [d] this row's h in f32
  __shared__ float warp_sums[kRowThreads / 32];
  const int r = blockIdx.x;
  float ss = 0.f;
  for (int j = threadIdx.x; j < d; j += kRowThreads) {
    float acc = 0.f;
    for (int s = 0; s < splits; ++s) acc += partials[((size_t)s * m + r) * d + j];
    const float h = acc + to_f32(residual[(size_t)r * d + j]);
    hs[j] = h;
    ss = fmaf(h, h, ss);
    h_out[(size_t)r * d + j] = from_f32<T>(h);
  }
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = ss;
  __syncthreads();
  if (threadIdx.x < 32) {
    float t = threadIdx.x < kRowThreads / 32 ? warp_sums[threadIdx.x] : 0.f;
    for (int off = 16; off > 0; off >>= 1) t += __shfl_xor_sync(0xffffffffu, t, off);
    if (threadIdx.x == 0) warp_sums[0] = t;
  }
  __syncthreads();
  const float inv = rsqrtf(warp_sums[0] / (float)d + eps);
  for (int j = threadIdx.x; j < d; j += kRowThreads)   // each thread reads its own hs[j]
    hn_out[(size_t)r * d + j] = from_f32<T>((hs[j] * inv) * norm_w[j]);
}

// act[r][j] = silu(gate) * up with gate, up = the split sums of partials[.][r][j] and
// partials[.][r][f + j]; grid (ceil(f / kActThreads), m).
template <typename T>
__global__ void __launch_bounds__(kActThreads)
silu_mul_kernel(const float* __restrict__ partials, int splits, T* __restrict__ act, int m,
                int f) {
  const int j = blockIdx.x * kActThreads + threadIdx.x;
  const int r = blockIdx.y;
  if (j >= f) return;
  const size_t n = 2 * (size_t)f;
  float g = 0.f, u = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float* row = partials + ((size_t)s * m + r) * n;
    g += row[j];
    u += row[f + j];
  }
  act[(size_t)r * f + j] = from_f32<T>(g / (1.f + expf(-g)) * u);
}

template <typename T>
cudaError_t residual_rms(const float* partials, int splits, const void* residual,
                         const void* norm_w, void* h_out, void* hn, int m, int d, float eps,
                         cudaStream_t st) {
  residual_rms_kernel<T><<<m, kRowThreads, (size_t)d * sizeof(float), st>>>(
      partials, splits, static_cast<const T*>(residual), static_cast<const float*>(norm_w),
      static_cast<T*>(h_out), static_cast<T*>(hn), m, d, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t silu_mul(const float* partials, int splits, void* act, int m, int f,
                     cudaStream_t st) {
  silu_mul_kernel<T><<<dim3((f + kActThreads - 1) / kActThreads, m), kActThreads, 0, st>>>(
      partials, splits, static_cast<T*>(act), m, f);
  return cudaGetLastError();
}

bool bad_dims(int dtype, int m, int d) {
  return (dtype != 0 && dtype != 1) || m <= 0 || m > 65535 || d <= 0 || d > kMaxRowFloats;
}

}  // namespace

// Suffix A. attn [m, k_o], h_res [m, d] in the dtype (0 = f32, 1 = bf16); ln2_w [d] f32;
// one layer's W_o / s_o (k_o/2 x d packed, f32 scales) and W_gu / s_gu (d/2 x 2f);
// outputs act [m, f], h_out [m, d]; scratch hn [m, d] in the dtype and partials, f32, of
// max(splits_o * m * d, splits_g * m * 2f).
extern "C" int af_w4_suffix_a(const void* attn, const void* h_res, const void* ln2_w,
                              const void* w_o, const void* s_o, const void* w_gu,
                              const void* s_gu, void* act, void* h_out, void* hn,
                              void* partials, int dtype, int m, int k_o, int d, int f,
                              int group_o, int group_g, int splits_o, int splits_g, float eps,
                              void* stream) {
  if (bad_dims(dtype, m, d) || f <= 0 || partials == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partials);
  int err = af_w4a16_matmul(attn, w_o, s_o, nullptr, part, dtype, m, k_o / 2, d, group_o,
                            splits_o, stream);
  if (err != 0) return err;
  err = (int)(dtype == 0
                  ? residual_rms<float>(part, splits_o, h_res, ln2_w, h_out, hn, m, d, eps, st)
                  : residual_rms<__nv_bfloat16>(part, splits_o, h_res, ln2_w, h_out, hn, m, d,
                                                eps, st));
  if (err != 0) return err;
  err = af_w4a16_matmul(hn, w_gu, s_gu, nullptr, part, dtype, m, d / 2, 2 * f, group_g,
                        splits_g, stream);
  if (err != 0) return err;
  return (int)(dtype == 0 ? silu_mul<float>(part, splits_g, act, m, f, st)
                          : silu_mul<__nv_bfloat16>(part, splits_g, act, m, f, st));
}

// Suffix B. act [m, f], h [m, d] in the dtype; ln1_next [d] f32; layer i's W_down / s_down
// (f/2 x d) and the next layer's W_qkv / s_qkv (d/2 x n_qkv); outputs h_out [m, d] and
// qkv [m, n_qkv]; scratch hn [m, d] and partials, f32, of
// max(splits_d * m * d, splits_q * m * n_qkv).
extern "C" int af_w4_suffix_b(const void* act, const void* h, const void* ln1_next,
                              const void* w_down, const void* s_down, const void* w_qkv,
                              const void* s_qkv, void* h_out, void* qkv, void* hn,
                              void* partials, int dtype, int m, int f, int d, int n_qkv,
                              int group_d, int group_q, int splits_d, int splits_q, float eps,
                              void* stream) {
  if (bad_dims(dtype, m, d) || f <= 0 || partials == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partials);
  int err = af_w4a16_matmul(act, w_down, s_down, nullptr, part, dtype, m, f / 2, d, group_d,
                            splits_d, stream);
  if (err != 0) return err;
  err = (int)(dtype == 0
                  ? residual_rms<float>(part, splits_d, h, ln1_next, h_out, hn, m, d, eps, st)
                  : residual_rms<__nv_bfloat16>(part, splits_d, h, ln1_next, h_out, hn, m, d,
                                                eps, st));
  if (err != 0) return err;
  return af_w4a16_matmul(hn, w_qkv, s_qkv, qkv, part, dtype, m, d / 2, n_qkv, group_q,
                         splits_q, stream);
}
