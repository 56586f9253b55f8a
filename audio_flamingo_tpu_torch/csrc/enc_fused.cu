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
// Shared design: products are mma.sync m16n8k32 s8.s8.s32, exact. Every float step
// follows JAX's order with round-to-nearest intrinsics (no FMA contraction); the
// LayerNorm sums are warp reductions (enc_out_ln's over 256-column shares added in
// order), the one place whose order differs from the plain version. No float atomics: a
// replay is bit-identical.
//
// All three stages read K-major int8 copies of their weights (W^T, made once where the
// fused encoder reaches the card: ops/kernels/enc_fused.attach_kmajor) through one TMA
// ring (`ring`: 2D boxes of 256 weight rows x 64 k, 64-byte swizzled, an mbarrier a
// step, thread 0 issuing), 16 warps of 32 x 32 accumulators a block, one block an SM.
//   enc_ln_qkv: a block takes 64 rows and walks 256-column passes of q|k|v; a cluster of
//     C blocks (`ln_qkv_cluster`, from the card's SM count: 4 at m = 1500, 1 at
//     m = 30,000 on 132 SMs, as measured) shares the row block, each block normalizing
//     and quantizing 64 / C of the rows once (a row read once into registers by 16-byte
//     loads) and copying the others' codes from their shared memory, then taking every
//     C-th pass (6-slot ring). Shared memory at d = 1280: 182,528 bytes.
//   Both stages take rows of at most 2048 elements (kRegD), held in registers.
//   enc_out_ln: a cluster of ceil(d / 256) blocks (5 at d = 1280) shares 64 rows, each
//     block one 256-column share of x2 kept in f32 (64 KB) and of w_o, so w_o is read once
//     per 64 rows and no block holds whole rows; the LayerNorm's per-row partials (the
//     sum, then the centred squares, then the |h| maxima) cross the cluster through
//     distributed shared memory. 4-slot ring; 217,856 bytes at d = 1280.
//   enc_mlp: see its section (64 rows a block and f tile, fc1 twice, fc2 into a scratch).
//
// Bound on the H100 (int8 ops at 1979 TOPS, or bytes at 3.35 TB/s, the larger) at
// m = 30,000 rows (a 10-minute input): enc_ln_qkv 0.149 ms (ops), enc_out_ln 0.081 ms
// (bytes), enc_mlp 0.397 ms (ops). Measured there (scripts/torch_k3_k9_times.py, NVIDIA
// H100 80GB HBM3 at 700 W): enc_ln_qkv 0.84 ms, enc_out_ln 0.82 ms (the previous design's stages,
// which transposed the JAX-layout weights into shared memory on every block: 2.97 and
// 2.70 ms), enc_mlp 3.35 ms. Left: wgmma (mma.sync's int8 rate is a fraction of
// the card's), a producer warp and persistent blocks so that one row block's epilogue
// and normalization overlap the next one's products, and, for enc_mlp, fc1 once.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <cuda.h>          // CUtensorMap (TMA), encoded through the runtime's driver entry point
#include <cudaTypedefs.h>

#include <cooperative_groups.h>

#include "flash_mma.cuh"   // ldmatrix_x4

namespace cg = cooperative_groups;

namespace {


__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

template <int MT, int NTL>
__device__ __forceinline__ void zero(int (&acc)[MT][NTL][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NTL; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] =
        acc[mt][nt][3] = 0;
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

// ------------------------------------------------------------- enc_ln_qkv, enc_out_ln
//
// Both stages share enc_mlp's TMA ring (`ring`, `mma_step`, 64-byte swizzled boxes of
// 256 weight rows x 64 k on an mbarrier a step) over K-major copies of their weights
// (W^T [N, d] int8, made once per encoder: ops/kernels/enc_fused.kmajor), 64 rows a
// block in 16 warps (2 warp rows x 8 warp columns of 32 x 32), one block an SM. The A
// operand is the rows' int8 codes, kept in shared memory (row stride d + 16, so an
// ldmatrix phase's 8 rows hit distinct banks). A thread-block cluster of C blocks shares
// one row block: block `rank` normalizes and quantizes rows rank, rank + C, .., and every
// block copies the other rows' codes and scales from their owners' shared memory
// (distributed shared memory), so each row is normalized and quantized once per row block.

constexpr int kRows = 64;                        // rows a block
constexpr int kRowThreads = 512;                 // 16 warps
constexpr int kWBox = kMlpNC * kMlpKC;           // one weight box: 256 rows x 64 k

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_sync_all() {
  cluster_arrive();
  cluster_wait();
}

// Rows are normalized and quantized from registers: the warp reads the row once with
// 16-byte loads (lane l holds 16-byte vectors l, l + 32, ..) and every pass over it (sum,
// centred squares, |h| maxima, codes) runs on those values. So enc_ln_qkv and enc_out_ln
// take rows of at most kRegD elements (Whisper's widest encoder has 1280).
constexpr int kRegD = 2048;
constexpr int kRegN = kRegD / 32;   // floats a lane

template <typename T>
__device__ __forceinline__ void load_row(const T* src, float (&f)[kRegN], int d, int lane) {
  constexpr int kE = 16 / (int)sizeof(T), kV = kRegN / kE;
  const int vecs = d / kE;
#pragma unroll
  for (int i = 0; i < kV; ++i) {
    const int v = lane + 32 * i;
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (v < vecs) u = *reinterpret_cast<const uint4*>(src + (int64_t)v * kE);
    if (sizeof(T) == 4) {
      f[i * kE] = __uint_as_float(u.x);
      f[i * kE + 1] = __uint_as_float(u.y);
      f[i * kE + 2] = __uint_as_float(u.z);
      f[i * kE + 3] = __uint_as_float(u.w);
    } else {
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 x = __bfloat1622float2(h[e]);
        f[i * kE + 2 * e] = x.x;
        f[i * kE + 2 * e + 1] = x.y;
      }
    }
  }
}

// The codes of a row held by load_row<T> (h: its values), at scale s, into dst.
template <typename T>
__device__ __forceinline__ void store_codes(const float (&h)[kRegN], float s, int d, int lane,
                                            int8_t* dst) {
  constexpr int kE = 16 / (int)sizeof(T), kV = kRegN / kE;
  const int vecs = d / kE;
#pragma unroll
  for (int i = 0; i < kV; ++i) {
    const int v = lane + 32 * i;
    if (v >= vecs) continue;
    uint32_t w[kE / 4];
#pragma unroll
    for (int q = 0; q < kE / 4; ++q) {
      w[q] = 0u;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        w[q] |= (uint32_t)(uint8_t)quant(h[i * kE + 4 * q + e], s) << (8 * e);
    }
    if (kE == 8)
      *reinterpret_cast<uint2*>(dst + kE * v) = make_uint2(w[0], w[kE / 4 - 1]);
    else
      *reinterpret_cast<uint32_t*>(dst + kE * v) = w[0];
  }
}

// The f32 LayerNorm of a row held by load_row<T> (the whole warp), its int8 codes into
// dst and its scale returned: mean, centred squares and |h| maxima each summed by a lane
// over its own elements in order, then across the warp; every float step rounded as JAX
// takes it (no contraction).
template <typename T>
__device__ __forceinline__ float ln_quant_regs(float (&f)[kRegN], const float* w, const float* b,
                                               int d, float eps, int lane, int8_t* dst) {
  constexpr int kE = 16 / (int)sizeof(T), kV = kRegN / kE;
  const int vecs = d / kE;
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < kV; ++i)
    if (lane + 32 * i < vecs)
#pragma unroll
      for (int e = 0; e < kE; ++e) sum += f[i * kE + e];
  const float mu = warp_sum(sum) / (float)d;
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < kV; ++i)
    if (lane + 32 * i < vecs)
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        const float t = __fsub_rn(f[i * kE + e], mu);
        sq = __fadd_rn(sq, __fmul_rn(t, t));
      }
  const float rstd = __fdiv_rn(1.0f, sqrtf(__fadd_rn(warp_sum(sq) / (float)d, eps)));
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < kV; ++i) {
    const int c0 = kE * (lane + 32 * i);
    if (c0 < d)
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        const float h = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(f[i * kE + e], mu), rstd),
                                            __ldg(w + c0 + e)),
                                  __ldg(b + c0 + e));
        f[i * kE + e] = h;
        amax = fmaxf(amax, fabsf(h));
      }
  }
  const float s = row_scale(warp_max(amax));
  store_codes<T>(f, s, d, lane, dst);
  return s;
}

// quant_row on a row in registers.
template <typename T>
__device__ __forceinline__ float quant_regs(const float (&f)[kRegN], int d, int lane,
                                            int8_t* dst) {
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < kRegN; ++i) amax = fmaxf(amax, fabsf(f[i]));   // zeros past d
  const float s = row_scale(warp_max(amax));
  store_codes<T>(f, s, d, lane, dst);
  return s;
}

// The rows of sA (codes, row stride lda) and sScale that other blocks of the cluster
// own (row r belongs to rank r % C), copied from their shared memory. The caller has
// synchronized the cluster after the owners wrote them.
__device__ __forceinline__ void share_rows(cg::cluster_group& cluster, int8_t* sA, int lda,
                                           float* sScale, int d, int C, int rank) {
  if (C == 1) return;
  const int vecs = d / 16;
  for (int i = threadIdx.x; i < kRows * vecs; i += blockDim.x) {
    const int r = i / vecs, v = i % vecs;
    if (r % C == rank) continue;
    int4* dst = reinterpret_cast<int4*>(sA + r * lda) + v;
    *dst = *cluster.map_shared_rank(dst, r % C);
  }
  for (int r = threadIdx.x; r < kRows; r += blockDim.x)
    if (r % C != rank) sScale[r] = *cluster.map_shared_rank(sScale + r, r % C);
}

// Warp-level ldmatrix row offsets of the A codes (row stride lda) and of a swizzled
// weight box, at k-step ks (as mlp_tile_kernel computes them for fc2).
__device__ __forceinline__ void row_offsets(int (&a_off)[kMlpK32][2], int (&b_off)[kMlpK32][2],
                                            int lda, int wm, int wn, int lane) {
#pragma unroll
  for (int ks = 0; ks < kMlpK32; ++ks) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      a_off[ks][mt] = (wm * 32 + mt * 16 + (lane & 15)) * lda + ks * 32 + (lane >> 4) * 16;
#pragma unroll
    for (int p = 0; p < 2; ++p)
      b_off[ks][p] = swz(wn * 32 + p * 16 + (lane >> 4) * 8 + (lane & 7),
                         2 * ks + ((lane >> 3) & 1));
  }
}

template <typename T> __device__ __forceinline__ float2 load2(const T* p);
template <> __device__ __forceinline__ float2 load2<float>(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
template <> __device__ __forceinline__ float2 load2<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

template <typename T> __device__ __forceinline__ void store2(T* p, float a, float b);
template <> __device__ __forceinline__ void store2<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <> __device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* p, float a,
                                                                  float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __halves2bfloat162(__float2bfloat16(a),
                                                             __float2bfloat16(b));
}

// enc_ln_qkv: grid (C, ceil(m / 64)), cluster (C, 1, 1); block `rank` of a cluster takes
// the 256-column passes rank, rank + C, .. of the N output columns. Shared memory:
// 1024 (alignment) + 6 x 16 KB ring + 64 (d + 16) codes + 64 scales (231,680 bytes at
// d = kRegD).
constexpr int kQkvStages = 6;

template <typename T>
__global__ void __launch_bounds__(kRowThreads, 1)
ln_qkv_kernel(const __grid_constant__ CUtensorMap map_w, const T* __restrict__ x,
              const float* __restrict__ lnw, const float* __restrict__ lnb,
              const float* __restrict__ wscale, const float* __restrict__ bias,
              T* __restrict__ out, int m, int d, int N, float eps) {
  constexpr int S = kQkvStages;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  extern __shared__ __align__(16) int8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar[S];
  const int lda = d + 16;
  int8_t* sRing = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  int8_t* sA = sRing + S * kWBox;                                  // [64][lda] codes
  float* sHs = reinterpret_cast<float*>(sA + kRows * lda);         // [64] row scales
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 3, wn = warp & 7;
  const int row0 = blockIdx.y * kRows;
  if (tid == 0) {
    for (int i = 0; i < S; ++i) mbar_init(&bar[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // this block's rows: LayerNorm -> int8 codes and row scale (rows past m: zeros)
  for (int r = rank + C * warp; r < kRows; r += C * (kRowThreads / 32)) {
    const int row = row0 + r;
    if (row >= m) {
      for (int c = lane; c < d; c += 32) sA[r * lda + c] = 0;
      if (lane == 0) sHs[r] = 0.f;
      continue;
    }
    float f[kRegN];   // d <= kRegD
    load_row<T>(x + (int64_t)row * d, f, d, lane);
    const float s = ln_quant_regs<T>(f, lnw, lnb, d, eps, lane, sA + r * lda);
    if (lane == 0) sHs[r] = s;
  }
  cluster_sync_all();
  share_rows(cluster, sA, lda, sHs, d, C, rank);
  cluster_arrive();   // done reading the others' rows (waited for before exit)
  __syncthreads();

  int a_off[kMlpK32][2], b_off[kMlpK32][2];
  row_offsets(a_off, b_off, lda, wm, wn, lane);
  const int passes = (N + kMlpNC - 1) / kMlpNC;
  const int ncc = (passes - rank + C - 1) / C;
  int acc[2][4][4];
  zero(acc);
  int step = 0, k0 = 0;
  ring<S>(
      ncc, d / kMlpKC, step, bar,
      [&](int buf, int cc, int kc) {
        mbar_expect(&bar[buf], kWBox);
        tma_box(sRing + buf * kWBox, &map_w, kc * kMlpKC, (rank + cc * C) * kMlpNC, &bar[buf]);
      },
      [&](int buf) {
        mma_step(acc, sA + k0, a_off, sRing + buf * kWBox, b_off);
        k0 += kMlpKC;
      },
      [&](int cc) {
        const int col0 = (rank + cc * C) * kMlpNC + wn * 32 + 2 * t;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = wm * 32 + mt * 16 + g + 8 * half;
            const int row = row0 + r;
            if (row >= m) continue;
            const float hs = sHs[r];
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
              const int c = col0 + nt * 8;
              if (c >= N) continue;
              float y[2];
#pragma unroll
              for (int e = 0; e < 2; ++e)
                y[e] = __fadd_rn(__fmul_rn(__fmul_rn((float)acc[mt][nt][2 * half + e], hs),
                                           wscale[c + e]),
                                 bias[c + e]);
              store2<T>(out + (int64_t)row * N + c, y[0], y[1]);
            }
          }
        zero(acc);
        k0 = 0;
      });
  cluster_wait();
}

// enc_out_ln: grid (C, ceil(m / 64)), cluster (C, 1, 1) with C = ceil(d / 256): block
// `rank` owns output columns [256 rank, 256 rank + 256) of its 64 rows and keeps their
// f32 x2 in shared memory; the LayerNorm's per-row partial sums (the mean's, then the
// centred squares', then the |h| maxima) are exchanged through distributed shared memory
// and added in rank order. Shared memory: 1024 + S x 16 KB + 64 (d + 16) + 64 x 260 x 4
// + 7 x 64 x 4 (217,856 bytes at d = 1280).
constexpr int kOutStages = 4;
constexpr int kLdx = kMlpNC + 4;   // x2 row stride (floats)

template <typename T>
__global__ void __launch_bounds__(kRowThreads, 1)
out_ln_kernel(const __grid_constant__ CUtensorMap map_w, const T* __restrict__ attn,
              const T* __restrict__ x, const float* __restrict__ wscale,
              const float* __restrict__ bias, const float* __restrict__ lnw,
              const float* __restrict__ lnb, T* __restrict__ x2_out, int8_t* __restrict__ hq_out,
              float* __restrict__ hs_out, int m, int d, float eps) {
  constexpr int S = kOutStages;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  extern __shared__ __align__(16) int8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar[S];
  const int lda = d + 16;
  int8_t* sRing = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  int8_t* sA = sRing + S * kWBox;                                   // [64][lda] attn codes
  float* sX2 = reinterpret_cast<float*>(sA + kRows * lda);          // [64][kLdx] f32 x2
  float* sAs = sX2 + kRows * kLdx;                                  // [64] attn row scales
  float* sPart = sAs + kRows;                                       // [3][64] partials
  float* sStat = sPart + 3 * kRows;                                 // [3][64] mu, rstd, scale
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 3, wn = warp & 7;
  const int row0 = blockIdx.y * kRows;
  const int col0 = rank * kMlpNC, ncols = min(kMlpNC, d - col0);
  if (tid == 0) {
    for (int i = 0; i < S; ++i) mbar_init(&bar[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int r = rank + C * warp; r < kRows; r += C * (kRowThreads / 32)) {
    const int row = row0 + r;
    if (row >= m) {
      for (int c = lane; c < d; c += 32) sA[r * lda + c] = 0;
      if (lane == 0) sAs[r] = 0.f;
      continue;
    }
    float f[kRegN];   // d <= kRegD
    load_row<T>(attn + (int64_t)row * d, f, d, lane);
    const float s = quant_regs<T>(f, d, lane, sA + r * lda);
    if (lane == 0) sAs[r] = s;
  }
  cluster_sync_all();
  share_rows(cluster, sA, lda, sAs, d, C, rank);
  __syncthreads();

  int a_off[kMlpK32][2], b_off[kMlpK32][2];
  row_offsets(a_off, b_off, lda, wm, wn, lane);
  int acc[2][4][4];
  zero(acc);
  int step = 0, k0 = 0;
  ring<S>(
      1, d / kMlpKC, step, bar,
      [&](int buf, int, int kc) {
        mbar_expect(&bar[buf], kWBox);
        tma_box(sRing + buf * kWBox, &map_w, kc * kMlpKC, col0, &bar[buf]);
      },
      [&](int buf) {
        mma_step(acc, sA + k0, a_off, sRing + buf * kWBox, b_off);
        k0 += kMlpKC;
      },
      [&](int) {   // x2 = x + y + bias in f32: kept, and written in the dtype
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = wm * 32 + mt * 16 + g + 8 * half;
            const int row = row0 + r;
            if (row >= m) continue;
            const float as = sAs[r];
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
              const int c = wn * 32 + nt * 8 + 2 * t;   // within the block's columns
              if (c >= ncols) continue;
              const float2 xv = load2<T>(x + (int64_t)row * d + col0 + c);
              const float xe[2] = {xv.x, xv.y};
              float v[2];
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const float y = __fmul_rn(__fmul_rn((float)acc[mt][nt][2 * half + e], as),
                                          wscale[col0 + c + e]);
                v[e] = __fadd_rn(__fadd_rn(xe[e], y), bias[col0 + c + e]);
              }
              *reinterpret_cast<float2*>(sX2 + r * kLdx + c) = make_float2(v[0], v[1]);
              store2<T>(x2_out + (int64_t)row * d + col0 + c, v[0], v[1]);
            }
          }
      });
  __syncthreads();

  // The LayerNorm of the f32 x2 rows over all d columns: each block's partial over its
  // columns (a warp a row), exchanged and added in rank order; the float steps as
  // ln_quant_regs takes them.
  auto exchange = [&](int which, bool is_max) {
    cluster_sync_all();   // every block's partials of `which` are written
    if (tid < kRows) {
      float v = 0.f;   // a sum, or a max of |h| >= 0
      for (int k = 0; k < C; ++k) {
        const float p = *cluster.map_shared_rank(sPart + which * kRows + tid, k);
        v = is_max ? fmaxf(v, p) : v + p;
      }
      sStat[which * kRows + tid] = v;
    }
    __syncthreads();
  };
  for (int r = warp; r < kRows; r += kRowThreads / 32) {
    float sum = 0.f;
    for (int c = lane; c < ncols; c += 32) sum += sX2[r * kLdx + c];
    sum = warp_sum(sum);
    if (lane == 0) sPart[r] = sum;
  }
  exchange(0, false);
  if (tid < kRows) sStat[tid] = sStat[tid] / (float)d;   // mu
  __syncthreads();
  for (int r = warp; r < kRows; r += kRowThreads / 32) {
    const float mu = sStat[r];
    float sq = 0.f;
    for (int c = lane; c < ncols; c += 32) {
      const float u = __fsub_rn(sX2[r * kLdx + c], mu);
      sq = __fadd_rn(sq, __fmul_rn(u, u));
    }
    sq = warp_sum(sq);
    if (lane == 0) sPart[kRows + r] = sq;
  }
  exchange(1, false);
  if (tid < kRows)
    sStat[kRows + tid] = __fdiv_rn(1.0f, sqrtf(__fadd_rn(sStat[kRows + tid] / (float)d, eps)));
  __syncthreads();
  auto h_of = [&](int r, int c) {
    return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(sX2[r * kLdx + c], sStat[r]),
                                         sStat[kRows + r]),
                               lnw[col0 + c]),
                     lnb[col0 + c]);
  };
  for (int r = warp; r < kRows; r += kRowThreads / 32) {
    float amax = 0.f;
    for (int c = lane; c < ncols; c += 32) amax = fmaxf(amax, fabsf(h_of(r, c)));
    amax = warp_max(amax);
    if (lane == 0) sPart[2 * kRows + r] = amax;
  }
  exchange(2, true);
  for (int r = warp; r < kRows; r += kRowThreads / 32) {
    const int row = row0 + r;
    if (row >= m) continue;
    const float s = row_scale(sStat[2 * kRows + r]);
    for (int c = lane; c < ncols; c += 32) hq_out[(int64_t)row * d + col0 + c] = quant(h_of(r, c), s);
    if (rank == 0 && lane == 0) hs_out[row] = s;
  }
  cluster_sync_all();   // no block leaves while another may still read its partials
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

// A launch of `kernel` in clusters of (cluster, 1, 1) blocks.
template <typename... P, typename... A>
cudaError_t launch_clusters(void (*kernel)(P...), dim3 grid, int threads, size_t smem,
                            int cluster, cudaStream_t stream, A... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// The streaming multiprocessors of the current device.
int device_sms() {
  static int sms[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (sms[dev] == 0) cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
  return sms[dev];
}

// Blocks a cluster of enc_ln_qkv gives one 64-row block (each takes every C-th of the
// ceil(n / 256) column passes; one block an SM): 1 while the row blocks alone fill the
// card, else the largest power of two (at most 8 and the passes) whose clusters still run
// in one wave. Measured on an H100 80GB HBM3 (scripts/torch_k3_k9_times.py --clusters):
// C = 1 is fastest at m = 30,000 (each block's normalization and ring start cost more than
// the tail they balance), C = 4 at m = 1500 (5-block clusters no longer fit one wave).
int ln_qkv_cluster(int m, int n) {
  const int passes = (n + kMlpNC - 1) / kMlpNC;
  const long long row_blocks = (m + kRows - 1) / kRows;
  const int cap = passes < 8 ? passes : 8;
  int c = 1;
  while (2 * c <= cap && 2 * c * row_blocks <= device_sms()) c *= 2;
  return c;
}

template <typename T>
int run_ln_qkv(const CUtensorMap& map, const void* x, const void* lnw, const void* lnb,
               const void* wscale, const void* bias, void* out, int m, int d, int n,
               int cluster, float eps, size_t smem, cudaStream_t s) {
  int err = set_smem(ln_qkv_kernel<T>, smem);
  if (err) return err;
  return (int)launch_clusters(ln_qkv_kernel<T>, dim3(cluster, (m + kRows - 1) / kRows),
                              kRowThreads, smem, cluster, s, map, static_cast<const T*>(x),
                              static_cast<const float*>(lnw), static_cast<const float*>(lnb),
                              static_cast<const float*>(wscale), static_cast<const float*>(bias),
                              static_cast<T*>(out), m, d, n, eps);
}

template <typename T>
int run_out_ln(const CUtensorMap& map, const void* attn, const void* x, const void* wscale,
               const void* bias, const void* lnw, const void* lnb, void* x2, void* hq,
               void* hs, int m, int d, float eps, size_t smem, cudaStream_t s) {
  int err = set_smem(out_ln_kernel<T>, smem);
  if (err) return err;
  const int cluster = (d + kMlpNC - 1) / kMlpNC;
  return (int)launch_clusters(out_ln_kernel<T>, dim3(cluster, (m + kRows - 1) / kRows),
                              kRowThreads, smem, cluster, s, map, static_cast<const T*>(attn),
                              static_cast<const T*>(x), static_cast<const float*>(wscale),
                              static_cast<const float*>(bias), static_cast<const float*>(lnw),
                              static_cast<const float*>(lnb), static_cast<T*>(x2),
                              static_cast<int8_t*>(hq), static_cast<float*>(hs), m, d, eps);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and out). wt: the K-major codes W^T [n, d] int8
// (16-byte aligned), per-column f32 wscale, bias [n]; cluster: blocks sharing a 64-row
// block (1 .. 8, at most ceil(n / 256)), or 0 for ln_qkv_cluster's choice. d % 64 == 0
// and d <= 2048, n % 128 == 0. Returns a cudaError_t (0 on success);
// cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int af_enc_ln_qkv(const void* x, const void* lnw, const void* lnb, const void* wt,
                             const void* wscale, const void* bias, void* out, int dtype,
                             int m, int d, int n, int cluster, float eps, void* stream) {
  if (m <= 0 || d <= 0 || d % kMlpKC != 0 || d > kRegD || n <= 0 || n % 128 != 0 ||
      cluster < 0 || cluster > 8 || cluster > (n + kMlpNC - 1) / kMlpNC ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(wt) % 16 != 0) return (int)cudaErrorMisalignedAddress;
  if (cluster == 0) cluster = ln_qkv_cluster(m, n);
  const size_t smem = 1024 + (size_t)kQkvStages * kWBox + (size_t)kRows * (d + 16) + kRows * 4;
  static_assert(1024 + kQkvStages * kWBox + kRows * (kRegD + 16) + kRows * 4 + 64 <= kSmemLimit,
                "enc_ln_qkv's ring, codes and scales fit at d = kRegD");
  CUtensorMap map;
  if (!byte_map(&map, wt, d, n, kMlpNC)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = dtype == 0
      ? run_ln_qkv<float>(map, x, lnw, lnb, wscale, bias, out, m, d, n, cluster, eps, smem, s)
      : run_ln_qkv<__nv_bfloat16>(map, x, lnw, lnb, wscale, bias, out, m, d, n, cluster, eps,
                                  smem, s);
  if (err) return err;
  return (int)cudaGetLastError();
}

// attn, x, x2 [m, d] in the dtype; wt: W_o^T [d, d] int8 (16-byte aligned); hq [m, d]
// int8, hs [m] f32. d % 128 == 0 and d <= 2048 (a cluster of ceil(d / 256) blocks).
extern "C" int af_enc_out_ln(const void* attn, const void* x, const void* wt,
                             const void* wscale, const void* bias, const void* lnw,
                             const void* lnb, void* x2, void* hq, void* hs, int dtype, int m,
                             int d, float eps, void* stream) {
  static_assert(kRegD <= 8 * kMlpNC, "a row's column shares fit in one cluster");
  if (m <= 0 || d <= 0 || d % 128 != 0 || d > kRegD || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(wt) % 16 != 0) return (int)cudaErrorMisalignedAddress;
  const size_t smem = 1024 + (size_t)kOutStages * kWBox + (size_t)kRows * (d + 16) +
                      (size_t)kRows * kLdx * 4 + 7 * kRows * 4;
  if (smem + 64 > kSmemLimit) return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  if (!byte_map(&map, wt, d, d, kMlpNC)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = dtype == 0
      ? run_out_ln<float>(map, attn, x, wscale, bias, lnw, lnb, x2, hq, hs, m, d, eps, smem, s)
      : run_out_ln<__nv_bfloat16>(map, attn, x, wscale, bias, lnw, lnb, x2, hq, hs, m, d, eps,
                                  smem, s);
  if (err) return err;
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
  const bool small = (int64_t)tiles * ((m + kMlpRows<2> - 1) / kMlpRows<2>) < device_sms();
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
