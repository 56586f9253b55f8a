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
// Shared design: 256 threads (8 warps); products are mma.sync m16n8k32 s8.s8.s32, exact.
// Every float step follows JAX's order with round-to-nearest intrinsics (no FMA
// contraction); the LayerNorm sums are warp reductions, the one place whose order differs
// from the plain version. No float atomics: a replay is bit-identical.
//
// enc_ln_qkv and enc_out_ln keep the activations' int8 codes of a block of rows in shared
// memory (row stride K + 16 bytes, so fragment loads hit 32 banks) and read the weights
// in the JAX layout [in, out], 64 input rows at a time, transposed on the way into shared
// memory (4 x 4 byte tiles through __byte_perm) so that both mma operands are
// K-contiguous. enc_ln_qkv takes 64 rows and a 640-column slice of the output per block
// (LayerNorm recomputed per slice). enc_out_ln needs whole rows before its LayerNorm: a
// block owns 32 rows and all d output columns, keeping x2 in f32 in shared memory (160 KB
// at d = 1280). enc_mlp (redesigned; see its section) reads K-major copies of its weights
// through a TMA ring, 64 rows per block and f tile.
//
// Bound on the H100 (int8 ops at 1979 TOPS, or bytes at 3.35 TB/s, the larger) at
// m = 30,000 rows (a 10-minute input): enc_ln_qkv 0.149 ms (ops), enc_out_ln 0.081 ms
// (bytes), enc_mlp 0.397 ms (ops). enc_ln_qkv and enc_out_ln re-read each weight from L2
// once per row block, load without a pipeline and use mma.sync, not wgmma; those are the
// levers of a later pass. enc_mlp streams about 12 MB of weights through L2 per 64-row
// block (fc1 twice, fc2 once) and evaluates its GELUs twice.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <cuda.h>          // CUtensorMap (TMA), encoded through the runtime's driver entry point
#include <cudaTypedefs.h>

#include "flash_mma.cuh"   // ldmatrix_x4

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
//
// One block per (f tile, R rows): R = 64 (16 warps), or 32 (8 warps) while 64-row blocks
// would not fill the card once (a 30 s input); grid (f / ft, ceil(m / R)). The weights
// come as K-major int8 copies, W1^T [f, d] and W2^T [d, f] (ops/kernels/enc_fused.
// mlp_kmajor), so each ring step is one TMA box of [256 rows x 64 k] weight codes (with
// fc1's [R x 64 k] activation codes beside it), 64-byte swizzled, landing on an mbarrier;
// thread 0 issues, one block barrier a step frees the previous buffer (3 buffers at
// R = 64, 8 at R = 32). No block transposes and no thread computes a copy's address: a
// cp.async ring of 16-byte copies measured slower here, its copies per SM in flight the
// limit. A tile's re-quantization needs the row maxima of its whole f32 GELU tile before
// any code: R x 2560 f32 does not fit, so fc1 runs twice, the first pass keeping only
// each row's max |GELU|, the second quantizing each value as it leaves the accumulators
// into the tile's int8 codes (R x ft bytes of shared memory). fc2 then takes those codes
// over the tile's ft rows of W2^T, 256 output columns a pass, and writes y_j = f32(int32)
// * row scale to an f32 scratch [tiles, m, d]; a second kernel adds the tiles in JAX's
// order (0 + y_0 + y_1 ...) and applies s2, b2 and x2. Every warp holds 32 rows x 32
// columns (2 m16 x 4 n8 tiles); fragments come by ldmatrix. The int8 work is 1.5x JAX's
// (fc1 twice) for 4x fewer row blocks than 16-row blocks would need.

constexpr int kMlpKC = 64;       // k per ring step: one 64-byte row of a TMA box
constexpr int kMlpNC = 256;      // output columns per pass: 8 warp columns x 32
constexpr int kOutThreads = 256;

// Rows of a block (32 or 64: WR warp rows of 32), its threads (8 warp columns each), its
// ring step (the R x 32 activation codes, then 256 x 32 weight codes, 1024-byte aligned)
// and ring depth (what shared memory leaves beside the tile's codes at ft = 2560).
template <int WR> constexpr int kMlpRows = 32 * WR;
template <int WR> constexpr int kMlpThreads = 256 * WR;
template <int WR> constexpr int kMlpStep = kMlpRows<WR> * kMlpKC + kMlpNC * kMlpKC;
template <int WR> constexpr int kMlpStages = (WR == 1 ? 147456 : 61440) / kMlpStep<WR>;
template <int WR>
constexpr size_t mlp_smem(int ft) {   // alignment slack, ring, codes, hs, tile scales, maxima
  return 1024 + (size_t)kMlpStages<WR> * kMlpStep<WR> + (size_t)kMlpRows<WR> * (ft + 16) +
         10 * kMlpRows<WR> * sizeof(float);
}

// Byte offset of 16-byte chunk c (0-3) of row r in a TMA box of 64-byte rows stored with
// the 64-byte swizzle (address bits 4-5 XOR bits 7-8), so that an ldmatrix phase's 8 rows
// hit 8 distinct bank groups; the box starts 1024-byte aligned.
__device__ __forceinline__ int swz(int r, int c) { return r * 64 + ((c ^ ((r >> 1) & 3)) << 4); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_addr(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}

// One 2D TMA box (64 bytes x rows, at byte column x of row y) into shared memory,
// completing on bar.
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map, int x, int y,
                                        uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(smem_addr(dst)), "l"(map), "r"(x), "r"(y), "r"(smem_addr(bar)) : "memory");
}

// A TMA ring over ncc column chunks of nkc k-steps each, S buffers with a full barrier
// each; `step` counts the steps of every sequence so far (buffer step % S, phase
// step / S). Thread 0 issues load(buf, cc, kc) (arming bar[buf]); every thread waits
// for its step, then compute(buf); epilogue(cc) follows a chunk's last step. One block
// barrier a step frees the previous step's buffer. The caller syncs between sequences.
template <int S, typename L, typename C, typename E>
__device__ __forceinline__ void ring(int ncc, int nkc, int& step, uint64_t* bar, L load,
                                     C compute, E epilogue) {
  const int n = ncc * nkc;
  int lcc = 0, lkc = 0, ls = 0;   // the next step to load
  auto next = [&]() {
    if (ls < n && threadIdx.x == 0) load((step + ls) % S, lcc, lkc);
    ++ls;
    if (++lkc == nkc) { lkc = 0; ++lcc; }
  };
#pragma unroll
  for (int i = 0; i < S - 1; ++i) next();
  int g = step;
  for (int cc = 0; cc < ncc; ++cc) {
    for (int kc = 0; kc < nkc; ++kc, ++g) {
      mbar_wait(&bar[g % S], (g / S) & 1);
      __syncthreads();   // every thread is done with step g - 1: its buffer is free
      next();
      compute(g % S);
    }
    epilogue(cc);
  }
  step += n;
}

constexpr int kMlpK32 = kMlpKC / 32;   // mma k-steps a ring step

// acc[mt][nt] += A (the warp's 32 rows) x B (its 32 columns) over one ring step's kMlpKC:
// a + a_off[ks][mt] and b + b_off[ks][p] are the lane's ldmatrix row addresses at k-step ks
__device__ __forceinline__ void mma_step(int (&acc)[2][4][4], const int8_t* a,
                                         const int (&a_off)[kMlpK32][2], const int8_t* b,
                                         const int (&b_off)[kMlpK32][2]) {
#pragma unroll
  for (int ks = 0; ks < kMlpK32; ++ks) {
    uint32_t af[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) ldmatrix_x4(af[mt], a + a_off[ks][mt]);
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      uint32_t bf[4];
      ldmatrix_x4(bf, b + b_off[ks][p]);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        mma_s8(acc[mt][2 * p], af[mt], bf[0], bf[1]);
        mma_s8(acc[mt][2 * p + 1], af[mt], bf[2], bf[3]);
      }
    }
  }
}

// map_h: hq [m, d] in boxes of 64 bytes x R rows; map_w1: W1^T [f, d] and map_w2: W2^T
// [d, f] in boxes of 64 bytes x 256 rows; all with the 64-byte swizzle.
template <int WR>
__global__ void __launch_bounds__(kMlpThreads<WR>, 1)
mlp_tile_kernel(const __grid_constant__ CUtensorMap map_h,
                const __grid_constant__ CUtensorMap map_w1,
                const __grid_constant__ CUtensorMap map_w2, const float* __restrict__ hs,
                const float* __restrict__ s1, const float* __restrict__ b1,
                float* __restrict__ y, int m, int d, int f, int ft) {
  constexpr int R = kMlpRows<WR>, kStep = kMlpStep<WR>, S = kMlpStages<WR>;
  constexpr int kStepA = R * kMlpKC;
  extern __shared__ __align__(16) int8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar[S];
  const int ldg = ft + 16;
  int8_t* sRing = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);   // S steps
  int8_t* sG = sRing + S * kStep;                                    // [R][ldg] codes
  float* sHs = reinterpret_cast<float*>(sG + R * ldg);               // [R]
  float* sGs = sHs + R;                                              // [R] tile row scales
  float* sMax = sGs + R;                                             // [8][R]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 3, wn = warp & 7;   // 32 rows x 32 columns a warp
  const int tile = blockIdx.x, f0 = tile * ft, row0 = blockIdx.y * R;
  if (tid < R) sHs[tid] = row0 + tid < m ? hs[row0 + tid] : 1.f;
  if (tid == 0) {
    for (int i = 0; i < S; ++i) mbar_init(&bar[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // ldmatrix row addresses at k-step ks: A rows (lane & 15) of each m16 tile, chunk
  // 2 ks + (lane >> 4); B rows (n) p * 16 + (lane >> 4) * 8 + (lane & 7), chunk
  // 2 ks + ((lane >> 3) & 1)
  int a_off[kMlpK32][2], g_off[kMlpK32][2], b_off[kMlpK32][2];
#pragma unroll
  for (int ks = 0; ks < kMlpK32; ++ks) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int r = wm * 32 + mt * 16 + (lane & 15);
      a_off[ks][mt] = swz(r, 2 * ks + (lane >> 4));
      g_off[ks][mt] = r * ldg + ks * 32 + (lane >> 4) * 16;
    }
#pragma unroll
    for (int p = 0; p < 2; ++p)
      b_off[ks][p] = swz(wn * 32 + p * 16 + (lane >> 4) * 8 + (lane & 7),
                         2 * ks + ((lane >> 3) & 1));
  }

  int acc[2][4][4];
  zero(acc);
  int step = 0;
  const int nk1 = d / kMlpKC;
  float rmax[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
  for (int pass = 0; pass < 2; ++pass) {
    __syncthreads();
    ring<S>(
        ft / kMlpNC, nk1, step, bar,
        [&](int buf, int cc, int kc) {
          int8_t* st = sRing + buf * kStep;
          mbar_expect(&bar[buf], kStep);
          tma_box(st, &map_h, kc * kMlpKC, row0, &bar[buf]);   // rows past m read as 0
          tma_box(st + kStepA, &map_w1, kc * kMlpKC, f0 + cc * kMlpNC, &bar[buf]);
        },
        [&](int buf) {
          const int8_t* st = sRing + buf * kStep;
          mma_step(acc, st, a_off, st + kStepA, b_off);
        },
        [&](int cc) {
          // fc1 -> scale, bias -> GELU; pass 0 keeps |max| per row, pass 1 quantizes
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int r = wm * 32 + mt * 16 + g + 8 * half;
              const float h_s = sHs[r];
              const float gs = sGs[r];   // pass 1 only (written after pass 0)
#pragma unroll
              for (int nt = 0; nt < 4; ++nt) {
                const int c = cc * kMlpNC + wn * 32 + nt * 8 + 2 * t;
                float v[2];
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  const float a = __fmul_rn(__fmul_rn((float)acc[mt][nt][2 * half + e], h_s),
                                            s1[f0 + c + e]);
                  v[e] = gelu(__fadd_rn(a, b1[f0 + c + e]));
                }
                if (pass == 0) {
                  rmax[mt][half] = fmaxf(rmax[mt][half], fmaxf(fabsf(v[0]), fabsf(v[1])));
                } else {
                  const uint16_t q2 = (uint16_t)(uint8_t)quant(v[0], gs) |
                                      (uint16_t)(uint8_t)quant(v[1], gs) << 8;
                  *reinterpret_cast<uint16_t*>(sG + r * ldg + c) = q2;
                }
              }
            }
          zero(acc);
        });
    if (pass == 0) {   // the tile's row scales: max over the quad, then over the 8 warp columns
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float v = rmax[mt][half];
          v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
          v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
          if (t == 0) sMax[wn * R + wm * 32 + mt * 16 + g + 8 * half] = v;
        }
      __syncthreads();
      if (tid < R) {
        float mx = sMax[tid];
#pragma unroll
        for (int c = 1; c < 8; ++c) mx = fmaxf(mx, sMax[c * R + tid]);
        sGs[tid] = row_scale(mx);
      }
    }
  }

  // fc2 over the tile's codes: y[tile] = f32(int32 product) * the row's tile scale
  __syncthreads();
  int g_k = 0;   // the consumed step's first k within the tile
  ring<S>(
      d / kMlpNC, ft / kMlpKC, step, bar,
      [&](int buf, int cc, int kc) {
        mbar_expect(&bar[buf], kMlpNC * kMlpKC);
        tma_box(sRing + buf * kStep, &map_w2, f0 + kc * kMlpKC, cc * kMlpNC, &bar[buf]);
      },
      [&](int buf) {
        // A: the codes at this step's k (the ring's steps walk k in order within a chunk)
        mma_step(acc, sG + g_k, g_off, sRing + buf * kStep, b_off);
        g_k += kMlpKC;
      },
      [&](int cc) {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = wm * 32 + mt * 16 + g + 8 * half;
            if (row0 + r >= m) continue;
            const float gs = sGs[r];
            float* yr = y + ((int64_t)tile * m + row0 + r) * d + cc * kMlpNC + wn * 32 + 2 * t;
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
              *reinterpret_cast<float2*>(yr + nt * 8) =
                  make_float2(__fmul_rn((float)acc[mt][nt][2 * half], gs),
                              __fmul_rn((float)acc[mt][nt][2 * half + 1], gs));
          }
        zero(acc);
        g_k = 0;
      });
}

// out = x2 + ((0 + y_0 + y_1 + ...) * s2 + b2), the tiles added in order, in x2's dtype
template <typename T>
__global__ void __launch_bounds__(kOutThreads)
mlp_out_kernel(const float* __restrict__ y, int tiles, const float* __restrict__ s2,
               const float* __restrict__ b2, const T* __restrict__ x2, T* __restrict__ out,
               int m, int d) {
  const int64_t count = (int64_t)m * d;
  const int64_t i = (int64_t)blockIdx.x * kOutThreads + threadIdx.x;
  if (i >= count) return;
  const int c = (int)(i % d);
  float acc = 0.f;
  for (int j = 0; j < tiles; ++j) acc = __fadd_rn(acc, y[j * count + i]);
  const float v = __fadd_rn(__fmul_rn(acc, s2[c]), b2[c]);
  out[i] = from_f32<T>(__fadd_rn(to_f32(x2[i]), v));
}

template <typename K>
int set_smem(K kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

constexpr size_t kSmemLimit = 232448;

// A TMA map of a row-major int8 [rows, cols] matrix read in boxes of 64 bytes x box_rows,
// 64-byte swizzled, rows past the end read as zeros. The encoder comes from the driver
// through the runtime (no link against libcuda).
bool byte_map(CUtensorMap* map, const void* base, int cols, int rows, int box_rows) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found) !=
            cudaSuccess || found != cudaDriverEntryPointSuccess)
      fn = nullptr;
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols};
  const cuuint32_t box[2] = {(cuuint32_t)kMlpKC, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

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

// hq [m, d] int8, hs [m] f32, w1t [f, d] and w2t [d, f] int8 (the K-major copies of the
// JAX layout's w1 [d, f] and w2 [f, d]), per-column f32 s1, b1 [f], s2, b2 [d]; x2, out
// [m, d] in the dtype; y: f32 scratch of (f / ft) * m * d. d and ft multiples of 256
// (cudaErrorInvalidValue otherwise); hq, w1t and w2t 16-byte aligned. Two launches: the
// tile kernel and the kernel that adds the tiles.
extern "C" int af_enc_mlp(const void* hq, const void* hs, const void* w1t, const void* s1,
                          const void* b1, const void* w2t, const void* s2, const void* b2,
                          const void* x2, void* out, void* y, int dtype, int m, int d, int f,
                          int ft, void* stream) {
  if (m <= 0 || d <= 0 || d % kMlpNC != 0 || ft <= 0 || ft % kMlpNC != 0 || f % ft != 0 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(hq) | reinterpret_cast<uintptr_t>(w1t) |
       reinterpret_cast<uintptr_t>(w2t)) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  const int tiles = f / ft;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 64-row blocks, or 32-row blocks while 64-row ones would not fill the card once
  static const int sms = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n;
  }();
  const bool small = (int64_t)tiles * ((m + kMlpRows<2> - 1) / kMlpRows<2>) < sms;
  const size_t smem = small ? mlp_smem<1>(ft) : mlp_smem<2>(ft);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  CUtensorMap map_h, map_w1, map_w2;
  const int rows = small ? kMlpRows<1> : kMlpRows<2>;
  if (!byte_map(&map_h, hq, d, m, rows) || !byte_map(&map_w1, w1t, d, f, kMlpNC) ||
      !byte_map(&map_w2, w2t, f, d, kMlpNC))
    return (int)cudaErrorInvalidValue;
  int err;
#define AF_MLP_TILE(WR)                                                                   \
  err = set_smem(mlp_tile_kernel<WR>, smem);                                              \
  if (err) return err;                                                                    \
  mlp_tile_kernel<WR><<<dim3(tiles, (m + kMlpRows<WR> - 1) / kMlpRows<WR>), kMlpThreads<WR>, \
                        smem, s>>>(                                                       \
      map_h, map_w1, map_w2, static_cast<const float*>(hs), static_cast<const float*>(s1), \
      static_cast<const float*>(b1), static_cast<float*>(y), m, d, f, ft);
  if (small) {
    AF_MLP_TILE(1)
  } else {
    AF_MLP_TILE(2)
  }
#undef AF_MLP_TILE
  err = (int)cudaGetLastError();
  if (err) return err;
  const unsigned blocks = (unsigned)(((int64_t)m * d + kOutThreads - 1) / kOutThreads);
#define AF_MLP_OUT(T)                                                                     \
  mlp_out_kernel<T><<<blocks, kOutThreads, 0, s>>>(                                       \
      static_cast<const float*>(y), tiles, static_cast<const float*>(s2),                 \
      static_cast<const float*>(b2), static_cast<const T*>(x2), static_cast<T*>(out), m, d);
  if (dtype == 0) {
    AF_MLP_OUT(float)
  } else {
    AF_MLP_OUT(__nv_bfloat16)
  }
#undef AF_MLP_OUT
  return (int)cudaGetLastError();
}
