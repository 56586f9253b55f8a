// Fused Whisper log-mel for Hopper (sm_90a), plain C interface bound with ctypes.
//
// Replaces the Pallas TPU kernel audio_flamingo_tpu/ops/pallas/stft_mel.py
// (`fused_log_mel`: `_logmel_kernel` and `_clamp_kernel`). The function, per 30 s window
// of L samples: reflect-pad by n_fft/2, frame f = padded[hop f : hop f + n_fft], power
// spectrum (x C)^2 + (x S)^2 against the Hann-windowed real-DFT bases C, S [n_fft,
// n_bins], mel product against W [n_bins, n_mels], log10(max(., 1e-10)); then per window
// max(x, max - 8) and (x + 4) / 4.
//
// Kernel 1 (`log_mel_power_kernel`): one block per (64-frame tile, window). The block
// copies the stretch of signal its frames cover (63 hops + n_fft samples) into shared
// memory once, resolving the reflect indices at both window edges as it loads, so frame
// rows are pointer arithmetic into that stretch and no frame tensor exists in HBM. The
// DFT product streams the cos and sin bases through shared memory in 16-row K-chunks;
// 256 threads as 8 x 32, thread (ty, tx) owns frames ty + 8 i (i < 8) and bins
// tx + 32 j (j < 7), both re and im: 112 f32 accumulators, so power forms in registers.
// The power tile [64 x 224] is written to shared memory over the dead signal and basis
// buffers, and the mel product streams W in 16-row chunks (frames ty + 8 i, mels
// tx + 32 j, j < 4). Both products are exact f32 FMAs on CUDA cores, as the Pallas kernel
// runs them at Precision.HIGHEST; no TF32 and no bf16 (the parity target is f32).
//
// Kernel 2 (`log_mel_clamp_kernel`): one block per window reduces its max and rewrites
// the window in place as (max(x, max - 8) + 4) / 4.
//
// Bound on the H100: f32 CUDA-core FLOPs. Per 30 s window 3000 x 400 x 402 x 2 (DFT) +
// 3000 x 201 x 128 x 2 (mel) = 1.12 GFLOP, 16.7 us at 67 TFLOP/s; the bytes (1.9 MB in,
// 1.5 MB out) take ~1 us at 3.35 TB/s. This simple kernel pads 201 bins to 224 and keeps
// one 256-thread block per SM; the next step would be a wider register tile and
// double-buffered chunks.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTF = 64;            // frames per block
constexpr int kFI = kTF / 8;       // frames per thread (8)
constexpr int kNB = 224;           // DFT bins per block (>= n_bins), 7 per thread
constexpr int kBJ = kNB / 32;
constexpr int kNM = 128;           // mel bins per block (>= n_mels), 4 per thread
constexpr int kMJ = kNM / 32;
constexpr int kKC = 16;            // basis / mel-weight rows per shared-memory chunk

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Shared floats: the signal stretch plus one cos|sin chunk, later reused for the power
// tile plus one mel-weight chunk.
__host__ __device__ inline int seg_floats(int hop, int n_fft) {
  return (kTF - 1) * hop + round_up(n_fft, kKC);
}
inline size_t smem_bytes(int hop, int n_fft) {
  const int dft = seg_floats(hop, n_fft) + kKC * 2 * kNB;
  const int mel = kTF * kNB + kKC * kNM;
  return sizeof(float) * (size_t)(dft > mel ? dft : mel);
}

__global__ void __launch_bounds__(kThreads)
log_mel_power_kernel(const float* __restrict__ wins, const float* __restrict__ dft_cos,
                     const float* __restrict__ dft_sin, const float* __restrict__ mel_w,
                     float* __restrict__ out, int L, int frames, int hop, int n_fft,
                     int n_bins, int n_mels) {
  extern __shared__ __align__(16) float smem[];
  const int seg_len = seg_floats(hop, n_fft);
  float* seg = smem;                 // [seg_len] signal stretch
  float* sb = smem + seg_len;        // [kKC][2][kNB] cos | sin chunk
  float* pw = smem;                  // [kTF][kNB] power, after the DFT
  float* mw = smem + kTF * kNB;      // [kKC][kNM] mel-weight chunk

  const int tid = threadIdx.x;
  const int tx = tid & 31;
  const int ty = tid >> 5;
  const int f0 = blockIdx.x * kTF;
  const int64_t n = blockIdx.y;
  const float* x = wins + n * (int64_t)L;
  const int half = n_fft / 2;

  // padded index p = hop f0 + s; sample index i = p - half, reflected at both edges
  // (torch/numpy "reflect": the edge sample is not repeated). Samples of frames past
  // the last are never stored; they read 0 where they fall outside the reflect range.
  for (int s = tid; s < seg_len; s += kThreads) {
    long long i = (long long)hop * f0 + s - half;
    if (i < 0) i = -i;
    if (i >= L) i = 2LL * (L - 1) - i;
    seg[s] = (i >= 0 && i < L) ? x[i] : 0.f;
  }

  float re[kFI][kBJ], im[kFI][kBJ];
#pragma unroll
  for (int a = 0; a < kFI; ++a)
#pragma unroll
    for (int j = 0; j < kBJ; ++j) re[a][j] = im[a][j] = 0.f;

  const float* srow = seg + hop * ty;  // frame ty's first sample
  for (int k0 = 0; k0 < n_fft; k0 += kKC) {
    __syncthreads();  // the previous chunk is no longer read (and seg is loaded)
    for (int idx = tid; idx < kKC * kNB; idx += kThreads) {
      const int r = idx / kNB, c = idx % kNB;
      const bool ok = k0 + r < n_fft && c < n_bins;
      const int64_t g = (int64_t)(k0 + r) * n_bins + c;
      sb[r * 2 * kNB + c] = ok ? dft_cos[g] : 0.f;
      sb[r * 2 * kNB + kNB + c] = ok ? dft_sin[g] : 0.f;
    }
    __syncthreads();
#pragma unroll 2
    for (int r = 0; r < kKC; ++r) {
      float xa[kFI];
#pragma unroll
      for (int a = 0; a < kFI; ++a) xa[a] = srow[8 * hop * a + k0 + r];
#pragma unroll
      for (int j = 0; j < kBJ; ++j) {
        const float c = sb[r * 2 * kNB + tx + 32 * j];
        const float s = sb[r * 2 * kNB + kNB + tx + 32 * j];
#pragma unroll
        for (int a = 0; a < kFI; ++a) {
          re[a][j] = fmaf(xa[a], c, re[a][j]);
          im[a][j] = fmaf(xa[a], s, im[a][j]);
        }
      }
    }
  }
  __syncthreads();  // seg and sb are dead: the power tile goes over them
#pragma unroll
  for (int a = 0; a < kFI; ++a)
#pragma unroll
    for (int j = 0; j < kBJ; ++j)
      pw[(ty + 8 * a) * kNB + tx + 32 * j] = re[a][j] * re[a][j] + im[a][j] * im[a][j];

  float acc[kFI][kMJ];
#pragma unroll
  for (int a = 0; a < kFI; ++a)
#pragma unroll
    for (int j = 0; j < kMJ; ++j) acc[a][j] = 0.f;

  for (int k0 = 0; k0 < n_bins; k0 += kKC) {
    __syncthreads();  // power tile written / previous chunk no longer read
    for (int idx = tid; idx < kKC * kNM; idx += kThreads) {
      const int r = idx / kNM, c = idx % kNM;
      const bool ok = k0 + r < n_bins && c < n_mels;
      mw[idx] = ok ? mel_w[(int64_t)(k0 + r) * n_mels + c] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < kKC; ++r) {
      float pa[kFI];
#pragma unroll
      for (int a = 0; a < kFI; ++a) pa[a] = pw[(ty + 8 * a) * kNB + k0 + r];
#pragma unroll
      for (int j = 0; j < kMJ; ++j) {
        const float w = mw[r * kNM + tx + 32 * j];
#pragma unroll
        for (int a = 0; a < kFI; ++a) acc[a][j] = fmaf(pa[a], w, acc[a][j]);
      }
    }
  }

#pragma unroll
  for (int a = 0; a < kFI; ++a) {
    const int f = f0 + ty + 8 * a;
    if (f >= frames) continue;
    float* orow = out + (n * frames + f) * (int64_t)n_mels;
#pragma unroll
    for (int j = 0; j < kMJ; ++j) {
      const int m = tx + 32 * j;
      if (m < n_mels) orow[m] = log10f(fmaxf(acc[a][j], 1e-10f));
    }
  }
}

constexpr int kClampThreads = 1024;

__global__ void __launch_bounds__(kClampThreads)
log_mel_clamp_kernel(float* __restrict__ x, int64_t per_window) {
  __shared__ float warp_max[kClampThreads / 32];
  float* w = x + blockIdx.x * per_window;
  float mx = -INFINITY;
  for (int64_t i = threadIdx.x; i < per_window; i += kClampThreads) mx = fmaxf(mx, w[i]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = mx;
  __syncthreads();
  if (threadIdx.x < 32) {
    mx = warp_max[threadIdx.x];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    if (threadIdx.x == 0) warp_max[0] = mx;
  }
  __syncthreads();
  const float lo = warp_max[0] - 8.0f;
  for (int64_t i = threadIdx.x; i < per_window; i += kClampThreads)
    w[i] = (fmaxf(w[i], lo) + 4.0f) / 4.0f;
}

}  // namespace

// wins [N, L] f32; dft_cos, dft_sin [n_fft, n_bins]; mel_w [n_bins, n_mels]; out
// [N, frames, n_mels] f32 receives log10(max(mel power, 1e-10)). All contiguous.
// Returns a cudaError_t (0 on success); cudaErrorInvalidValue for sizes the kernel
// does not take.
extern "C" int af_log_mel_power(const void* wins, const void* dft_cos, const void* dft_sin,
                                const void* mel_w, void* out, int N, int L, int frames,
                                int hop, int n_fft, int n_bins, int n_mels, void* stream) {
  if (N <= 0 || frames <= 0 || hop <= 0 || n_fft <= 1 || n_fft / 2 >= L || n_bins <= 0 ||
      n_bins > kNB || n_mels <= 0 || n_mels > kNM || N > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(hop, n_fft);
  cudaError_t err = cudaFuncSetAttribute(log_mel_power_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((frames + kTF - 1) / kTF, N);
  log_mel_power_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(wins), static_cast<const float*>(dft_cos),
      static_cast<const float*>(dft_sin), static_cast<const float*>(mel_w),
      static_cast<float*>(out), L, frames, hop, n_fft, n_bins, n_mels);
  return (int)cudaGetLastError();
}

// x [N, per_window] f32, rewritten in place with the per-window clamp and scaling.
extern "C" int af_log_mel_clamp(void* x, int N, int64_t per_window, void* stream) {
  if (N <= 0 || per_window <= 0) return (int)cudaErrorInvalidValue;
  log_mel_clamp_kernel<<<N, kClampThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(x), per_window);
  return (int)cudaGetLastError();
}
