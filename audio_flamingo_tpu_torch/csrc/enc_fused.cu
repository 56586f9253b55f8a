// The three w8a8 encoder-layer fusions (K9) for Hopper (sm_90a), plain C interface bound
// with ctypes.
//
// Replaces the Pallas TPU kernels of audio_flamingo_tpu/ops/pallas/enc_fused.py:
//   enc_ln_qkv (`_ln_qkv_kernel`): x -> f32 LayerNorm -> per-row int8 quantization ->
//     int8 product with the q|k|v codes -> (acc * h_scale) * w_scale + bias -> x's dtype;
//   enc_out_ln (`_out_ln_kernel`): attn -> per-row quantization -> int8 product with w_o
//     -> x2 = x + y + bias in f32, written in attn's dtype -> LayerNorm of the unrounded
//     f32 x2 -> int8 codes and f32 row scales;
//   enc_mlp (`_mlp_kernel`): per f tile, the fc1 product -> scale, bias -> the
//     polynomial-erf GELU -> re-quantization per (row, tile) -> the fc2 product times the
//     tile's row scale, added to an f32 accumulator tile after tile in order; then
//     acc * s2 + b2 + x2 -> x2's dtype. The [m, ffn] activations never reach memory.
//
// Shared design: 256 threads (8 warps); the activations' int8 codes of a block of rows
// sit in shared memory (row stride K + 16 bytes, so fragment loads hit 32 banks); the
// weights are read in the JAX layout [in, out] (int8, row-major), 64 input rows at a time,
// and transposed on the way into shared memory (4 x 4 byte tiles through __byte_perm) so
// that both mma operands are K-contiguous; products are mma.sync m16n8k32 s8.s8.s32,
// exact. Every float step follows JAX's order with round-to-nearest intrinsics (no FMA
// contraction); the LayerNorm sums are warp reductions, the one place whose order differs
// from the plain version. No float atomics: a replay is bit-identical.
//
// Row ownership: enc_ln_qkv takes 64 rows and a 640-column slice of the output per block
// (LayerNorm recomputed per slice). enc_out_ln needs whole rows before its LayerNorm: a
// block owns 32 rows and all d output columns, keeping x2 in f32 in shared memory
// (160 KB at d = 1280). enc_mlp needs a whole 2560-wide f tile of GELU output before the
// tile's row max: a block owns 16 rows and keeps the tile in f32 in shared memory
// (160 KB), quantized in place; fc2's f32 accumulators (16 x d) live in registers.
//
// Bound on the H100 (int8 ops at 1979 TOPS, or bytes at 3.35 TB/s, the larger) at
// m = 30,000 rows (a 10-minute input): enc_ln_qkv 0.149 ms (ops), enc_out_ln 0.081 ms
// (bytes), enc_mlp 0.397 ms (ops). The simple design re-reads each weight from L2 once
// per row block, loads without a pipeline and uses mma.sync, not wgmma; those are the
// levers of a later pass.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 64;          // weight rows (input features) per shared-memory chunk
constexpr int kWS = kBK + 16;    // transposed weight chunk row stride (bytes)

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// ops/quant.quantize_act's scale and code: max(amax, 1e-6) / 127, round half to even
__device__ __forceinline__ float row_scale(float amax) { return fmaxf(amax, 1e-6f) / 127.0f; }
__device__ __forceinline__ int8_t quant(float h, float s) {
  return (int8_t)fminf(fmaxf(rintf(h / s), -127.f), 127.f);
}

// Abramowitz & Stegun 7.1.26 erf inside exact GELU, in the JAX kernel's order
__device__ __forceinline__ float gelu(float x) {
  const float a1 = 0.254829592f, a2 = -0.284496736f, a3 = 1.421413741f,
              a4 = -1.453152027f, a5 = 1.061405429f;
  const float u = __fmul_rn(x, 0.7071067811865476f);
  const float sg = u > 0.f ? 1.f : (u < 0.f ? -1.f : 0.f);
  const float z = fabsf(u);
  const float t = __fdiv_rn(1.0f, __fadd_rn(1.0f, __fmul_rn(0.3275911f, z)));
  float poly = __fadd_rn(a4, __fmul_rn(t, a5));
  poly = __fadd_rn(a3, __fmul_rn(t, poly));
  poly = __fadd_rn(a2, __fmul_rn(t, poly));
  poly = __fadd_rn(a1, __fmul_rn(t, poly));
  poly = __fmul_rn(t, poly);
  const float erf = __fmul_rn(sg, __fsub_rn(1.0f, __fmul_rn(poly, expf(__fmul_rn(-z, z)))));
  return __fmul_rn(__fmul_rn(0.5f, x), __fadd_rn(1.0f, erf));
}

// f32 LayerNorm of one row (the whole warp), its int8 codes into dst and its scale out.
// src(c) gives element c as f32.
template <typename F>
__device__ __forceinline__ float ln_quant_row(F src, const float* w, const float* b, int d,
                                              float eps, int lane, int8_t* dst) {
  float sum = 0.f;
  for (int c = lane; c < d; c += 32) sum += src(c);
  const float mu = warp_sum(sum) / (float)d;
  float sq = 0.f;
  for (int c = lane; c < d; c += 32) {
    const float t = __fsub_rn(src(c), mu);
    sq = __fadd_rn(sq, __fmul_rn(t, t));
  }
  const float rstd = __fdiv_rn(1.0f, sqrtf(__fadd_rn(warp_sum(sq) / (float)d, eps)));
  float amax = 0.f;
  for (int c = lane; c < d; c += 32) {
    const float h = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(src(c), mu), rstd), w[c]), b[c]);
    amax = fmaxf(amax, fabsf(h));
  }
  const float s = row_scale(warp_max(amax));
  for (int c = lane; c < d; c += 32) {
    const float h = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(src(c), mu), rstd), w[c]), b[c]);
    dst[c] = quant(h, s);
  }
  return s;
}

// Per-row quantization of one row (the whole warp) into dst; returns the scale.
template <typename F>
__device__ __forceinline__ float quant_row(F src, int d, int lane, int8_t* dst) {
  float amax = 0.f;
  for (int c = lane; c < d; c += 32) amax = fmaxf(amax, fabsf(src(c)));
  const float s = row_scale(warp_max(amax));
  for (int c = lane; c < d; c += 32) dst[c] = quant(src(c), s);
  return s;
}

// Rows [k0, k0 + 64) x columns [n0, n0 + ncols) of W [K][N] (int8, row-major) into
// sW[n][k] (row stride kWS): 4 x 4 byte tiles, transposed in registers.
__device__ __forceinline__ void load_w_t(int8_t* sW, const int8_t* W, int N, int k0, int n0,
                                         int ncols, int tid) {
  const int nq = ncols / 4;
  for (int i = tid; i < (kBK / 4) * nq; i += kThreads) {
    const int kq = i / nq, cq = i % nq;
    const int8_t* src = W + (int64_t)(k0 + 4 * kq) * N + n0 + 4 * cq;
    const uint32_t r0 = ld32(src), r1 = ld32(src + N), r2 = ld32(src + 2 * N),
                   r3 = ld32(src + 3 * N);
    const uint32_t t0 = __byte_perm(r0, r1, 0x5140), t1 = __byte_perm(r0, r1, 0x7362);
    const uint32_t t2 = __byte_perm(r2, r3, 0x5140), t3 = __byte_perm(r2, r3, 0x7362);
    int8_t* dst = sW + 4 * cq * kWS + 4 * kq;
    *reinterpret_cast<uint32_t*>(dst) = __byte_perm(t0, t2, 0x5410);
    *reinterpret_cast<uint32_t*>(dst + kWS) = __byte_perm(t0, t2, 0x7632);
    *reinterpret_cast<uint32_t*>(dst + 2 * kWS) = __byte_perm(t1, t3, 0x5410);
    *reinterpret_cast<uint32_t*>(dst + 3 * kWS) = __byte_perm(t1, t3, 0x7632);
  }
}

// acc[mt][nt] += A[a_row0 + 16 mt .., a_k0 .. a_k0 + 64) x sW[w_n0 + 8 nt ..][0 .. 64)
template <int MT, int NTL>
__device__ __forceinline__ void mma_chunk(int (&acc)[MT][NTL][4], const int8_t* sA, int lda,
                                          int a_row0, int a_k0, const int8_t* sW, int w_n0,
                                          int gq, int tig) {
#pragma unroll
  for (int ks = 0; ks < kBK / 32; ++ks) {
    uint32_t a[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int8_t* p = sA + (a_row0 + 16 * mt + gq) * lda + a_k0 + 32 * ks + 4 * tig;
      a[mt][0] = ld32(p);
      a[mt][1] = ld32(p + 8 * lda);
      a[mt][2] = ld32(p + 16);
      a[mt][3] = ld32(p + 8 * lda + 16);
    }
#pragma unroll
    for (int nt = 0; nt < NTL; ++nt) {
      const int8_t* p = sW + (w_n0 + 8 * nt + gq) * kWS + 32 * ks + 4 * tig;
      const uint32_t b0 = ld32(p), b1 = ld32(p + 16);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) mma_s8(acc[mt][nt], a[mt], b0, b1);
    }
  }
}

template <int MT, int NTL>
__device__ __forceinline__ void zero(int (&acc)[MT][NTL][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NTL; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] =
        acc[mt][nt][3] = 0;
}

// ------------------------------------------------------------------------ enc_ln_qkv

constexpr int kQkvRows = 64;     // rows per block: 2 warp rows x 2 m16 tiles
constexpr int kQkvCols = 128;    // output columns per weight chunk: 4 warps x 32
constexpr int kQkvSlice = 640;   // output columns per block (5 chunks); or 128

template <typename T>
__global__ void __launch_bounds__(kThreads)
ln_qkv_kernel(const T* __restrict__ x, const float* __restrict__ lnw,
              const float* __restrict__ lnb, const int8_t* __restrict__ W,
              const float* __restrict__ wscale, const float* __restrict__ bias,
              T* __restrict__ out, int m, int d, int N, int slice, float eps) {
  extern __shared__ __align__(16) int8_t smem[];
  const int lda = d + 16;
  int8_t* sA = smem;                                   // [64][lda] codes
  int8_t* sW = sA + kQkvRows * lda;                    // [128][kWS]
  float* sHs = reinterpret_cast<float*>(sW + kQkvCols * kWS);   // [64]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tig = lane & 3;
  const int row0 = blockIdx.y * kQkvRows;

  for (int r = warp; r < kQkvRows; r += 8) {
    const int row = row0 + r;
    if (row >= m) {
      for (int c = lane; c < d; c += 32) sA[r * lda + c] = 0;
      if (lane == 0) sHs[r] = 0.f;
      continue;
    }
    const T* xr = x + (int64_t)row * d;
    const float s = ln_quant_row([&](int c) { return to_f32(xr[c]); }, lnw, lnb, d, eps,
                                 lane, sA + r * lda);
    if (lane == 0) sHs[r] = s;
  }

  const int wm = warp >> 2, wn = warp & 3;
  for (int n0 = blockIdx.x * slice; n0 < (blockIdx.x + 1) * slice; n0 += kQkvCols) {
    int acc[2][4][4];
    zero(acc);
    for (int k0 = 0; k0 < d; k0 += kBK) {
      __syncthreads();
      load_w_t(sW, W, N, k0, n0, kQkvCols, tid);
      __syncthreads();
      mma_chunk<2, 4>(acc, sA, lda, 32 * wm, k0, sW, 32 * wn, gq, tig);
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = 32 * wm + 16 * mt + gq + 8 * half;
        const int row = row0 + r;
        if (row >= m) continue;
        const float hs = sHs[r];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int c = n0 + 32 * wn + 8 * nt + 2 * tig;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float y = __fmul_rn(__fmul_rn((float)acc[mt][nt][2 * half + e], hs),
                                      wscale[c + e]);
            out[(int64_t)row * N + c + e] = from_f32<T>(__fadd_rn(y, bias[c + e]));
          }
        }
      }
  }
}

// ------------------------------------------------------------------------ enc_out_ln

constexpr int kOutRows = 32;     // rows per block: 2 warp rows x 1 m16 tile

template <typename T>
__global__ void __launch_bounds__(kThreads)
out_ln_kernel(const T* __restrict__ attn, const T* __restrict__ x, const int8_t* __restrict__ W,
              const float* __restrict__ wscale, const float* __restrict__ bias,
              const float* __restrict__ lnw, const float* __restrict__ lnb,
              T* __restrict__ x2_out, int8_t* __restrict__ hq_out, float* __restrict__ hs_out,
              int m, int d, float eps) {
  extern __shared__ __align__(16) int8_t smem[];
  const int lda = d + 16, ldx = d + 4;
  int8_t* sA = smem;                                            // [32][lda] attn codes
  float* sX2 = reinterpret_cast<float*>(sA + kOutRows * lda);   // [32][ldx] f32 x2
  int8_t* sW = reinterpret_cast<int8_t*>(sX2 + kOutRows * ldx); // [128][kWS]
  float* sAs = reinterpret_cast<float*>(sW + kQkvCols * kWS);   // [32]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tig = lane & 3;
  const int row0 = blockIdx.x * kOutRows;

  for (int r = warp; r < kOutRows; r += 8) {
    const int row = row0 + r;
    if (row >= m) {
      for (int c = lane; c < d; c += 32) sA[r * lda + c] = 0;
      if (lane == 0) sAs[r] = 0.f;
      continue;
    }
    const T* ar = attn + (int64_t)row * d;
    const float s = quant_row([&](int c) { return to_f32(ar[c]); }, d, lane, sA + r * lda);
    if (lane == 0) sAs[r] = s;
  }

  const int wm = warp >> 2, wn = warp & 3;
  for (int n0 = 0; n0 < d; n0 += kQkvCols) {
    int acc[1][4][4];
    zero(acc);
    for (int k0 = 0; k0 < d; k0 += kBK) {
      __syncthreads();
      load_w_t(sW, W, d, k0, n0, kQkvCols, tid);
      __syncthreads();
      mma_chunk<1, 4>(acc, sA, lda, 16 * wm, k0, sW, 32 * wn, gq, tig);
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = 16 * wm + gq + 8 * half;
      const int row = row0 + r;
      if (row >= m) continue;
      const float as = sAs[r];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int c = n0 + 32 * wn + 8 * nt + 2 * tig;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float y = __fmul_rn(__fmul_rn((float)acc[0][nt][2 * half + e], as),
                                    wscale[c + e]);
          const float v = __fadd_rn(__fadd_rn(to_f32(x[(int64_t)row * d + c + e]), y),
                                    bias[c + e]);
          sX2[r * ldx + c + e] = v;
          x2_out[(int64_t)row * d + c + e] = from_f32<T>(v);
        }
      }
    }
  }
  __syncthreads();
  for (int r = warp; r < kOutRows; r += 8) {
    const int row = row0 + r;
    if (row >= m) continue;
    const float* xr = sX2 + r * ldx;
    const float s = ln_quant_row([&](int c) { return xr[c]; }, lnw, lnb, d, eps, lane,
                                 hq_out + (int64_t)row * d);
    if (lane == 0) hs_out[row] = s;
  }
}

// ------------------------------------------------------------------------ enc_mlp

constexpr int kMlpRows = 16;     // rows per block: one m16 tile shared by the 8 warps
constexpr int kFc1Cols = 256;    // fc1 columns per weight chunk: 8 warps x 32
constexpr int kFc2Cols = 320;    // fc2 columns per pass: 8 warps x 40 (5 n8 tiles)
constexpr int kFc2Passes = 4;    // at most 4 x 320 = 1280 output columns (d)

template <typename T>
__global__ void __launch_bounds__(kThreads)
mlp_kernel(const int8_t* __restrict__ hq, const float* __restrict__ hs,
           const int8_t* __restrict__ W1, const float* __restrict__ s1,
           const float* __restrict__ b1, const int8_t* __restrict__ W2,
           const float* __restrict__ s2, const float* __restrict__ b2,
           const T* __restrict__ x2, T* __restrict__ out, int m, int d, int f, int ft) {
  extern __shared__ __align__(16) int8_t smem[];
  const int lda = d + 16;
  const int ldg = ft + 4;                                        // floats
  int8_t* sA = smem;                                             // [16][lda] h codes
  float* sG = reinterpret_cast<float*>(sA + kMlpRows * lda);     // [16][ldg] GELU / codes
  int8_t* sW = reinterpret_cast<int8_t*>(sG + kMlpRows * ldg);   // [320][kWS]
  float* sHs = reinterpret_cast<float*>(sW + kFc2Cols * kWS);    // [16]
  float* sGs = sHs + kMlpRows;                                   // [16]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tig = lane & 3;
  const int row0 = blockIdx.x * kMlpRows;
  const int passes = d / kFc2Cols;

  for (int i = tid; i < kMlpRows * d; i += kThreads) {
    const int r = i / d, c = i % d;
    sA[r * lda + c] = row0 + r < m ? hq[(int64_t)(row0 + r) * d + c] : 0;
  }
  if (tid < kMlpRows) sHs[tid] = row0 + tid < m ? hs[row0 + tid] : 1.f;

  float facc[kFc2Passes][5][4];
#pragma unroll
  for (int p = 0; p < kFc2Passes; ++p)
#pragma unroll
    for (int nt = 0; nt < 5; ++nt) facc[p][nt][0] = facc[p][nt][1] = facc[p][nt][2] =
        facc[p][nt][3] = 0.f;

  for (int f0 = 0; f0 < f; f0 += ft) {
    // fc1 -> scale, bias -> GELU, into sG in f32
    for (int n0 = 0; n0 < ft; n0 += kFc1Cols) {
      int acc[1][4][4];
      zero(acc);
      for (int k0 = 0; k0 < d; k0 += kBK) {
        __syncthreads();
        load_w_t(sW, W1, f, k0, f0 + n0, kFc1Cols, tid);
        __syncthreads();
        mma_chunk<1, 4>(acc, sA, lda, 0, k0, sW, 32 * warp, gq, tig);
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = gq + 8 * half;
        const float h_s = sHs[r];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int c = n0 + 32 * warp + 8 * nt + 2 * tig;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float g = __fadd_rn(
                __fmul_rn(__fmul_rn((float)acc[0][nt][2 * half + e], h_s), s1[f0 + c + e]),
                b1[f0 + c + e]);
            sG[r * ldg + c + e] = gelu(g);
          }
        }
      }
    }
    __syncthreads();
    // per-row max over the tile, then quantize in place: the codes of row r occupy the
    // first ft bytes of its f32 row; within a warp each step reads its 32 floats before
    // it writes 32 bytes that lie at or before them
    for (int r = 2 * warp; r < 2 * warp + 2; ++r) {
      float* gr = sG + r * ldg;
      float amax = 0.f;
      for (int c = lane; c < ft; c += 32) amax = fmaxf(amax, fabsf(gr[c]));
      const float s = row_scale(warp_max(amax));
      int8_t* qr = reinterpret_cast<int8_t*>(gr);
      for (int c0 = 0; c0 < ft; c0 += 32) {
        const float v = gr[c0 + lane];
        __syncwarp();
        qr[c0 + lane] = quant(v, s);
        __syncwarp();
      }
      if (lane == 0) sGs[r] = s;
    }
    __syncthreads();
    // fc2 over this tile: int32 per pass, then folded into the f32 accumulators
    const int8_t* w2 = W2 + (int64_t)f0 * d;
#pragma unroll
    for (int p = 0; p < kFc2Passes; ++p) {
      if (p >= passes) continue;
      int acc[1][5][4];
      zero(acc);
      for (int k0 = 0; k0 < ft; k0 += kBK) {
        __syncthreads();
        load_w_t(sW, w2, d, k0, p * kFc2Cols, kFc2Cols, tid);
        __syncthreads();
        mma_chunk<1, 5>(acc, reinterpret_cast<const int8_t*>(sG), 4 * ldg, 0, k0, sW,
                        40 * warp, gq, tig);
      }
#pragma unroll
      for (int nt = 0; nt < 5; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          facc[p][nt][e] = __fadd_rn(facc[p][nt][e],
                                     __fmul_rn((float)acc[0][nt][e], sGs[gq + 8 * (e >> 1)]));
    }
    __syncthreads();   // sG is rewritten by the next tile
  }

#pragma unroll
  for (int p = 0; p < kFc2Passes; ++p) {
    if (p >= passes) continue;
#pragma unroll
    for (int nt = 0; nt < 5; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + gq + 8 * (e >> 1);
        if (row >= m) continue;
        const int c = p * kFc2Cols + 40 * warp + 8 * nt + 2 * tig + (e & 1);
        const float y = __fadd_rn(__fmul_rn(facc[p][nt][e], s2[c]), b2[c]);
        const int64_t at = (int64_t)row * d + c;
        out[at] = from_f32<T>(__fadd_rn(to_f32(x2[at]), y));
      }
  }
}

template <typename K>
int set_smem(K kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

constexpr size_t kSmemLimit = 232448;

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and out). Returns a cudaError_t (0 on success);
// cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int af_enc_ln_qkv(const void* x, const void* lnw, const void* lnb, const void* w,
                             const void* wscale, const void* bias, void* out, int dtype,
                             int m, int d, int n, float eps, void* stream) {
  if (m <= 0 || d <= 0 || d % kBK != 0 || n % kQkvCols != 0) return (int)cudaErrorInvalidValue;
  const int slice = n % kQkvSlice == 0 ? kQkvSlice : kQkvCols;
  const size_t smem = (size_t)kQkvRows * (d + 16) + kQkvCols * kWS + kQkvRows * 4;
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  const dim3 grid(n / slice, (m + kQkvRows - 1) / kQkvRows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
#define AF_LN_QKV(T)                                                                      \
  err = set_smem(ln_qkv_kernel<T>, smem);                                                 \
  if (err) return err;                                                                    \
  ln_qkv_kernel<T><<<grid, kThreads, smem, s>>>(                                          \
      static_cast<const T*>(x), static_cast<const float*>(lnw),                           \
      static_cast<const float*>(lnb), static_cast<const int8_t*>(w),                      \
      static_cast<const float*>(wscale), static_cast<const float*>(bias),                 \
      static_cast<T*>(out), m, d, n, slice, eps);
  if (dtype == 0) {
    AF_LN_QKV(float)
  } else if (dtype == 1) {
    AF_LN_QKV(__nv_bfloat16)
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef AF_LN_QKV
  return (int)cudaGetLastError();
}

extern "C" int af_enc_out_ln(const void* attn, const void* x, const void* w,
                             const void* wscale, const void* bias, const void* lnw,
                             const void* lnb, void* x2, void* hq, void* hs, int dtype, int m,
                             int d, float eps, void* stream) {
  if (m <= 0 || d <= 0 || d % kQkvCols != 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)kOutRows * (d + 16) + (size_t)kOutRows * (d + 4) * 4 +
                      kQkvCols * kWS + kOutRows * 4;
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  const dim3 grid((m + kOutRows - 1) / kOutRows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
#define AF_OUT_LN(T)                                                                      \
  err = set_smem(out_ln_kernel<T>, smem);                                                 \
  if (err) return err;                                                                    \
  out_ln_kernel<T><<<grid, kThreads, smem, s>>>(                                          \
      static_cast<const T*>(attn), static_cast<const T*>(x), static_cast<const int8_t*>(w), \
      static_cast<const float*>(wscale), static_cast<const float*>(bias),                 \
      static_cast<const float*>(lnw), static_cast<const float*>(lnb), static_cast<T*>(x2), \
      static_cast<int8_t*>(hq), static_cast<float*>(hs), m, d, eps);
  if (dtype == 0) {
    AF_OUT_LN(float)
  } else if (dtype == 1) {
    AF_OUT_LN(__nv_bfloat16)
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef AF_OUT_LN
  return (int)cudaGetLastError();
}

extern "C" int af_enc_mlp(const void* hq, const void* hs, const void* w1, const void* s1,
                          const void* b1, const void* w2, const void* s2, const void* b2,
                          const void* x2, void* out, int dtype, int m, int d, int f, int ft,
                          void* stream) {
  if (m <= 0 || d <= 0 || d % kFc2Cols != 0 || d / kFc2Cols > kFc2Passes || d % kBK != 0 ||
      ft <= 0 || ft % kFc1Cols != 0 || f % ft != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)kMlpRows * (d + 16) + (size_t)kMlpRows * (ft + 4) * 4 +
                      kFc2Cols * kWS + 2 * kMlpRows * 4;
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  const dim3 grid((m + kMlpRows - 1) / kMlpRows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
#define AF_MLP(T)                                                                         \
  err = set_smem(mlp_kernel<T>, smem);                                                    \
  if (err) return err;                                                                    \
  mlp_kernel<T><<<grid, kThreads, smem, s>>>(                                             \
      static_cast<const int8_t*>(hq), static_cast<const float*>(hs),                      \
      static_cast<const int8_t*>(w1), static_cast<const float*>(s1),                      \
      static_cast<const float*>(b1), static_cast<const int8_t*>(w2),                      \
      static_cast<const float*>(s2), static_cast<const float*>(b2),                       \
      static_cast<const T*>(x2), static_cast<T*>(out), m, d, f, ft);
  if (dtype == 0) {
    AF_MLP(float)
  } else if (dtype == 1) {
    AF_MLP(__nv_bfloat16)
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef AF_MLP
  return (int)cudaGetLastError();
}
