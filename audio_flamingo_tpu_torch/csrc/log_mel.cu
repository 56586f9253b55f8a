// Fused Whisper log-mel for Hopper (sm_90a), plain C interface bound with ctypes.
//
// Replaces the Pallas TPU kernel audio_flamingo_tpu/ops/pallas/stft_mel.py
// (`fused_log_mel`: `_logmel_kernel` and `_clamp_kernel`). The function, per 30 s window
// of L samples: reflect-pad by n_fft/2, frame f = padded[hop f : hop f + n_fft], power
// spectrum (x C)^2 + (x S)^2 against the Hann-windowed real-DFT bases C, S [n_fft,
// n_bins], mel product against W [n_bins, n_mels], log10(max(., 1e-10)); then per window
// max(x, max - 8) and (x + 4) / 4.
//
// Bound on the H100: operations. Per 30 s window 3000 x 400 x 402 x 2 (DFT) + 3000 x 201
// x 128 x 2 (mel) = 1.12 GFLOP, whose bytes (1.9 MB in, 1.5 MB out) take ~1 us at 3.35
// TB/s. The Pallas kernel runs both products at Precision.HIGHEST (f32 in several passes
// on the TPU's matrix unit); on the CUDA cores in f32 that is 16.7 us a window at 67
// TFLOP/s. Hopper's counterpart of HIGHEST is 3xTF32 on the tensor cores: each f32 is
// split into a TF32 high part and a TF32 remainder, and a b = ah bh + ah bl + al bh with
// f32 accumulation (the dropped al bl is ~2^-22 of |a||b|, the order of f32 sums): three
// times the work at 495 TFLOP/s, 6.8 us a window.
//
// Kernel 1 (`log_mel_power_kernel`): one block of 4 warps per (64-frame tile, window), two
// blocks an SM (108 KB of shared memory, <= 255 registers).
//   - The block copies the stretch of signal its frames cover (63 hops + n_fft samples)
//     into shared memory once, resolving the reflect indices at both window edges as it
//     loads, in a skewed layout (4 floats of padding after every hop of samples): frame
//     row f starts at (hop + 4) f, so the 8 frame rows of an ldmatrix phase hit 8 bank
//     groups and no frame tensor exists in HBM. The A fragments (16 frames x 8 samples)
//     come by ldmatrix and are split into TF32 high and low parts in registers.
//   - The bases are split once, on the host side, into TF32 high and low arrays laid out
//     as the kernel reads them (ops/kernels/log_mel.prepare_bases; the frontend keeps
//     them): per 8-sample k-step, [hi | lo][k 0-3 | k 4-7][208 rows][4], a row per cos or
//     sin bin (bins padded to the MMA's n-step: 201 -> 208). They stream through a 3-stage
//     cp.async ring of 13 KB stages, one k-step a stage, two stages ahead of the MMAs.
//   - The 208 bins go in two passes of 104 (13 n-tiles); warp (fg, bg) takes frames 32 fg
//     .. 32 fg + 31 (two m-tiles) and n-tiles 6 bg .. 6 bg + 6 of the pass, of cos and of
//     sin (n-tile 6 is computed by both warps and stored by the first): 112 f32
//     accumulators, so re and im of a bin sit in one thread and the power forms in
//     registers (re re + im im, no FMA, as the plain version rounds it). Pass 1's power
//     goes to its own [64][108] tile, pass 2's over the dead signal.
//   - The mel product takes the power tile the same way (3xTF32: the power spans many
//     decades), A by ldmatrix from the tile, W's hi and lo through the same ring (26
//     k-steps of 8 KB, the first two fetched during the DFT's last stages); warp (fg, mg)
//     takes 32 frames x 64 mels. log10 in the epilogue; the block's largest valid value
//     goes to a [N, tiles] array of tile maxima.
// Kernel 2 (`log_mel_clamp_kernel`): one block per (tile, window) reduces that window's
// tile maxima and rewrites its tile in place as (max(x, max - 8) + 4) / 4.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_mma.cuh"   // ldmatrix_x4, cp_async16, cp_async_commit/wait

namespace {

constexpr int kThreads = 128;      // 4 warps
constexpr int kTF = 64;            // frames per block (TILE_FRAMES)
constexpr int kBins = 208;         // DFT bins, padded to the MMA's n-step (MAX_BINS)
constexpr int kPassBins = kBins / 2;   // bins per pass: 13 n-tiles
constexpr int kWarpTiles = 7;      // n-tiles of cos (and of sin) a warp takes in a pass
constexpr int kMels = 128;         // mel bins (MAX_MELS)
constexpr int kPwStride = kPassBins + 4;   // floats per power-tile row (bank-conflict free)
constexpr int kStages = 3;
constexpr int kDftStage = 2 * 2 * 2 * kPassBins * 4;   // floats: [hi|lo][half][2 x 104][4]
constexpr int kMelStage = 2 * 2 * kMels * 4;           // floats: [hi|lo][half][128][4]
constexpr int kClampThreads = 256;

__host__ __device__ inline int seg_samples(int hop, int n_fft) { return (kTF - 1) * hop + n_fft; }
// skewed floats of the signal stretch: 4 after every hop of samples
__host__ __device__ inline int seg_floats(int hop, int n_fft) {
  const int s = seg_samples(hop, n_fft);
  return s + 4 * ((s + hop - 1) / hop);
}
inline size_t smem_bytes(int hop, int n_fft) {
  int seg = seg_floats(hop, n_fft);
  if (seg < kTF * kPwStride) seg = kTF * kPwStride;   // pass 2's power goes over it
  return sizeof(float) * ((size_t)seg + kTF * kPwStride + (size_t)kStages * kDftStage);
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, each a TF32 value (the remainder rounded again)
__device__ __forceinline__ void split(uint32_t x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(__uint_as_float(x));
  lo = tf32_rna(__uint_as_float(x) - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a b in 3xTF32, the small terms first
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ahi)[4],
                                     const uint32_t (&alo)[4], uint32_t bh0, uint32_t bh1,
                                     uint32_t bl0, uint32_t bl1) {
  mma_tf32(d, alo, bh0, bh1);
  mma_tf32(d, ahi, bl0, bl1);
  mma_tf32(d, ahi, bh0, bh1);
}

// A fragments (16 rows x 8 k, row stride `stride` floats, k0 a multiple of 4 within a
// row) split into TF32 high and low parts
__device__ __forceinline__ void load_a_split(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                             const float* base, int stride, int lane) {
  uint32_t a[4];
  ldmatrix_x4(a, base + ((lane & 7) + ((lane >> 3) & 1) * 8) * stride + (lane >> 4) * 4);
#pragma unroll
  for (int e = 0; e < 4; ++e) split(a[e], hi[e], lo[e]);
}

// B fragments of two n-tiles (rows n0 .. n0 + 15) of a stage laid out [half][rows][4]:
// r[0], r[1] for rows n0 .. n0 + 7, r[2], r[3] for n0 + 8 .. n0 + 15 (the same as r[0],
// r[1] when !two, so nothing past the stage is read)
__device__ __forceinline__ void load_b_pair(uint32_t (&r)[4], const float* stage, int rows,
                                            int n0, bool two, int lane) {
  const int q = lane >> 3;
  ldmatrix_x4(r, stage + (q & 1) * rows * 4 + (n0 + (two ? (q >> 1) * 8 : 0) + (lane & 7)) * 4);
}

// 16-byte copies of `floats` floats from src into dst by the block
__device__ __forceinline__ void copy_stage(float* dst, const float* src, int floats) {
  for (int i = threadIdx.x * 4; i < floats; i += kThreads * 4) cp_async16(dst + i, src + i, true);
}

// grid (ceil(frames / 64), N); dynamic shared memory smem_bytes(hop, n_fft). dft: the
// prepared bases, [2 passes][n_fft / 8][hi | lo][half][208][4]; melw: the prepared mel
// weights, [26][hi | lo][half][128][4]; out [N, frames, n_mels] gets log10(max(mel, 1e-10));
// tile_max [N, gridDim.x] each tile's largest value.
__global__ void __launch_bounds__(kThreads, 2)
log_mel_power_kernel(const float* __restrict__ wins, const float* __restrict__ dft,
                     const float* __restrict__ melw, float* __restrict__ out,
                     float* __restrict__ tile_max, int L, int frames, int hop, int n_fft,
                     int n_mels) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float warp_max[kThreads / 32];
  int seg_len = seg_floats(hop, n_fft);
  if (seg_len < kTF * kPwStride) seg_len = kTF * kPwStride;
  float* seg = smem;                          // skewed signal; pass 2's power after the DFT
  float* pw1 = smem + seg_len;                // [kTF][kPwStride] pass 1's power
  float* ring = pw1 + kTF * kPwStride;        // kStages x kDftStage
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int fg = warp >> 1, cg = warp & 1;    // frame group; bin group (DFT) or mel group
  const int f0 = blockIdx.x * kTF;
  const int64_t n = blockIdx.y;
  const int ksteps = n_fft / 8;
  const int dft_stages = 2 * ksteps, total = dft_stages + kBins / 8;

  auto issue = [&](int j) {
    float* dst = ring + (j % kStages) * kDftStage;
    if (j < dft_stages) copy_stage(dst, dft + (size_t)j * kDftStage, kDftStage);
    else copy_stage(dst, melw + (size_t)(j - dft_stages) * kMelStage, kMelStage);
  };

  // The signal stretch, by 4-byte copies, in the first group with stage 0. Padded index
  // p = hop f0 + s; sample index i = p - n_fft/2, reflected at both edges (torch/numpy
  // "reflect": the edge sample is not repeated); samples of frames past the last read 0
  // where they fall outside the reflect range.
  {
    const float* x = wins + n * (int64_t)L;
    const int half = n_fft / 2, len = seg_samples(hop, n_fft);
    for (int s = threadIdx.x; s < len; s += kThreads) {
      long long i = (long long)hop * f0 + s - half;
      if (i < 0) i = -i;
      if (i >= L) i = 2LL * (L - 1) - i;
      const bool in = i >= 0 && i < L;
      cp_async4(seg + s + 4 * (s / hop), in ? x + i : x, in);
    }
  }
  issue(0);
  cp_async_commit();
  issue(1);
  cp_async_commit();

  // ---- the framed DFT, two passes of 104 bins, and the power of each pass
  float acc[2][2][kWarpTiles][4];   // [cos | sin][m-tile][n-tile][fragment]
  const int nt0 = cg * (kPassBins / 8 - kWarpTiles);   // 0 or 6
  for (int j = 0; j < dft_stages; ++j) {
    const int pass = j / ksteps, ks = j % ksteps;
    if (ks == 0) {
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < kWarpTiles; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[c][mt][nt][e] = 0.f;
    }
    cp_async_wait<kStages - 2>();
    __syncthreads();   // stage j has landed for every thread; stage j - 1 is consumed
    issue(j + kStages - 1);   // the DFT is followed by the mel's stages: always in range
    cp_async_commit();
    const float* st = ring + (j % kStages) * kDftStage;
    // the k-step's 8 samples of frame row r start at (hop + 4) r + 8 ks + 4 (8 ks / hop)
    const int k0 = 8 * ks + 4 * (8 * ks / hop);
    uint32_t ahi[2][4], alo[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      load_a_split(ahi[mt], alo[mt], seg + (hop + 4) * (fg * 32 + mt * 16) + k0, hop + 4, lane);
#pragma unroll
    for (int c = 0; c < 2; ++c)   // cos rows 0..103, sin rows 104..207 of the stage
#pragma unroll
      for (int p = 0; p < (kWarpTiles + 1) / 2; ++p) {
        const bool two = 2 * p + 1 < kWarpTiles;   // the last pair of an odd count is one
        const int n0 = c * kPassBins + (nt0 + 2 * p) * 8;
        uint32_t bh[4], bl[4];
        load_b_pair(bh, st, 2 * kPassBins, n0, two, lane);
        load_b_pair(bl, st + 2 * 2 * kPassBins * 4, 2 * kPassBins, n0, two, lane);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          if (2 * p + u >= kWarpTiles) break;
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            mma3(acc[c][mt][2 * p + u], ahi[mt], alo[mt], bh[2 * u], bh[2 * u + 1],
                 bl[2 * u], bl[2 * u + 1]);
        }
      }
    if (ks == ksteps - 1) {   // the pass's power: re re + im im per (frame, bin)
      float* pw = pass == 0 ? pw1 : seg;
      if (pass == 1) __syncthreads();   // every warp is done reading the signal
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < kWarpTiles; ++nt) {
          if (cg == 1 && nt == 0) continue;   // n-tile 6 is the first warp's
          const int col = (nt0 + nt) * 8 + 2 * t;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = fg * 32 + mt * 16 + g + 8 * h;
            const float c0 = acc[0][mt][nt][2 * h], c1 = acc[0][mt][nt][2 * h + 1];
            const float s0 = acc[1][mt][nt][2 * h], s1 = acc[1][mt][nt][2 * h + 1];
            *reinterpret_cast<float2*>(pw + row * kPwStride + col) =
                make_float2(__fadd_rn(__fmul_rn(c0, c0), __fmul_rn(s0, s0)),
                            __fadd_rn(__fmul_rn(c1, c1), __fmul_rn(s1, s1)));
          }
        }
    }
  }

  // ---- the mel product over the power tiles: warp (fg, cg) takes 32 frames x 64 mels
  float macc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) macc[mt][nt][e] = 0.f;
  constexpr int kPassSteps = kPassBins / 8;
  for (int mk = 0; mk < kBins / 8; ++mk) {
    const int j = dft_stages + mk;
    cp_async_wait<kStages - 2>();
    __syncthreads();   // the power tiles are complete; stage j has landed
    if (j + kStages - 1 < total) issue(j + kStages - 1);
    cp_async_commit();
    const float* st = ring + (j % kStages) * kDftStage;
    const float* pw = (mk < kPassSteps ? pw1 : seg) + (mk % kPassSteps) * 8;
    uint32_t ahi[2][4], alo[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      load_a_split(ahi[mt], alo[mt], pw + (fg * 32 + mt * 16) * kPwStride, kPwStride, lane);
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int n0 = cg * 64 + 16 * p;
      uint32_t bh[4], bl[4];
      load_b_pair(bh, st, kMels, n0, true, lane);
      load_b_pair(bl, st + 2 * kMels * 4, kMels, n0, true, lane);
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          mma3(macc[mt][2 * p + u], ahi[mt], alo[mt], bh[2 * u], bh[2 * u + 1], bl[2 * u],
               bl[2 * u + 1]);
    }
  }

  // ---- log10, the output, the tile's largest valid value
  float vmax = -INFINITY;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int f = f0 + fg * 32 + mt * 16 + g + 8 * h;
      if (f >= frames) continue;
      float* orow = out + (n * frames + f) * (int64_t)n_mels;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int mel = cg * 64 + nt * 8 + 2 * t;
        if (mel >= n_mels) continue;
        const float v0 = log10f(fmaxf(macc[mt][nt][2 * h], 1e-10f));
        const float v1 = log10f(fmaxf(macc[mt][nt][2 * h + 1], 1e-10f));
        *reinterpret_cast<float2*>(orow + mel) = make_float2(v0, v1);
        vmax = fmaxf(vmax, fmaxf(v0, v1));
      }
    }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) vmax = fmaxf(vmax, __shfl_xor_sync(0xffffffffu, vmax, off));
  if (lane == 0) warp_max[warp] = vmax;
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = warp_max[0];
#pragma unroll
    for (int w = 1; w < kThreads / 32; ++w) m = fmaxf(m, warp_max[w]);
    tile_max[n * gridDim.x + blockIdx.x] = m;
  }
}

// grid (tiles, N): the window's tile maxima reduced, then its tile rewritten in place.
__global__ void __launch_bounds__(kClampThreads)
log_mel_clamp_kernel(float* __restrict__ x, const float* __restrict__ tile_max, int frames,
                     int n_mels) {
  __shared__ float lo_s;
  const int64_t n = blockIdx.y;
  const int tiles = gridDim.x;
  if (threadIdx.x < 32) {
    float mx = -INFINITY;
    for (int i = threadIdx.x; i < tiles; i += 32) mx = fmaxf(mx, tile_max[n * tiles + i]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    if (threadIdx.x == 0) lo_s = mx - 8.0f;
  }
  __syncthreads();
  const float lo = lo_s;
  const int r0 = blockIdx.x * kTF, r1 = min(frames, r0 + kTF);
  float* w = x + (n * frames + r0) * (int64_t)n_mels;
  const int count = (r1 - r0) * n_mels;
  for (int i = threadIdx.x; i < count; i += kClampThreads) w[i] = (fmaxf(w[i], lo) + 4.0f) / 4.0f;
}

}  // namespace

// wins [N, L] f32; dft and melw the prepared bases (ops/kernels/log_mel.prepare_bases, for
// this n_fft); out [N, frames, n_mels] f32 receives log10(max(mel power, 1e-10));
// tile_max [N, ceil(frames / 64)] f32 each tile's largest value. All contiguous. Returns
// a cudaError_t (0 on success); cudaErrorInvalidValue for sizes the kernel does not take.
extern "C" int af_log_mel_power(const void* wins, const void* dft, const void* melw, void* out,
                                void* tile_max, int N, int L, int frames, int hop, int n_fft,
                                int n_mels, void* stream) {
  if (N <= 0 || N > 65535 || frames <= 0 || hop <= 0 || hop % 8 != 0 || n_fft <= 1 ||
      n_fft % 8 != 0 || n_fft / 2 >= L || n_mels <= 0 || n_mels > kMels || n_mels % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(hop, n_fft);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(log_mel_power_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((frames + kTF - 1) / kTF, N);
  log_mel_power_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(wins), static_cast<const float*>(dft),
      static_cast<const float*>(melw), static_cast<float*>(out),
      static_cast<float*>(tile_max), L, frames, hop, n_fft, n_mels);
  return (int)cudaGetLastError();
}

// x [N, frames, n_mels] f32, rewritten in place with the per-window clamp and scaling
// from tile_max [N, ceil(frames / 64)].
extern "C" int af_log_mel_clamp(void* x, const void* tile_max, int N, int frames, int n_mels,
                                void* stream) {
  if (N <= 0 || N > 65535 || frames <= 0 || n_mels <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((frames + kTF - 1) / kTF, N);
  log_mel_clamp_kernel<<<grid, kClampThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(x), static_cast<const float*>(tile_max), frames, n_mels);
  return (int)cudaGetLastError();
}
