// w8a16 matmul (K4) for Hopper (sm_90a), plain C interface bound with ctypes.
//
// Replaces the Pallas TPU kernel audio_flamingo_tpu/ops/pallas/quant_matmul.py
// `w8a16_matmul` (:44, body `_kernel` :25): y = (x [m, K] @ int8 w [K, N]) * scale [N],
// x f32 or bf16, the product accumulated in f32 over all of K, then scaled per column in
// f32 and rounded once to the output dtype (x's dtype, or f32 for the LM head). Every
// code is widened exactly (the byte placed in the mantissa of 2^23 and the bias
// subtracted, no int-to-float conversion) and every product is exact in f32 (a bf16 x on
// the tensor cores, an f32 x on the CUDA cores), so only the order of the sums differs
// from JAX's. The codes come in one of two layouts:
//   layout 0: [K, N] row-major, JAX's layout (a layer of an [L, K, N] stack is the same
//             call at a pointer offset, so no slice is copied);
//   layout 1: [N, K] row-major, read as its transpose: the tied int8 embedding [V, d]
//             used as the head (`w_q.t()`), never copied to [K, N].
//
// Design, layout 0 (every layer product and the untied head): a weight-streaming
// product over tiles of 128 columns, built like K5's (csrc/w4a16_matmul.cu). A block (4
// warps) walks the code rows of its K range through a cp.async ring in shared memory (4
// stages of 32 rows x 128 columns, 16-byte copies, one barrier a stage), each stage
// carrying the matching entries of the block's rows of x beside the codes; every
// thread's copy addresses are computed once. One launch takes up to four products that
// share x (q|k|v, gate|up: `af_w8a16_matmul_group`), each read in place from its own
// codes and scales into its own columns of one output; the grid walks the products'
// column tiles in turn. K is split over grid.y in whole 32-row stages until the grid has
// about two blocks per SM (the wrapper's plan; at m = 1 and 8, 1-32 splits measured,
// this count was fastest at q, gate, down and gate|up); each split writes f32 partial
// sums, and the last split of a tile to finish (an integer counter per tile, reset by it)
// adds all the tile's partial sums in split order, scales and rounds: no second launch,
// no float atomics, so replays are bit-identical. With one split the block writes y.
// N must be a multiple of 16, K of 32, the codes and x 16-byte aligned.
//
// bf16 x: tensor cores (w8_mma_kernel). y^T = W^T x^T with mma.sync m16n8k16 (bf16 in,
//   f32 accumulate): W^T is the A operand (16 output columns a tile), x^T the B operand
//   (8 rows of x a tile; m <= 8 pads to 8). ldmatrix.trans of a [16 rows x 16 columns]
//   byte tile hands each thread the bytes (k 2t, 2t+1) x (columns 2g, 2g+1), so output
//   row g of an MMA tile is column 2g and row g + 8 column 2g + 1; each code is widened
//   exactly to f32 (__byte_perm into 2^23) and two are packed into a bf16 pair (int8
//   values are exact in bf16). Each 32-row stage sums into fresh accumulators that join
//   the f32 total by CUDA-core additions, so the tensor cores' own accumulation spans 32
//   products at most. 8, 16 or 32 rows of x per block (more tile over grid.z).
// f32 x: CUDA cores (w8_fma_kernel; TF32 would break the f32 tolerance). One thread per
//   column; x read as float4 broadcasts; 1, 2, 4 or 8 rows of x per block.
//
// Design, layout 1: one warp per 4 columns, 8 warps per block. Each lane reads 16
// contiguous codes of a column's K row (one 16-byte load per column); x is staged 512 K
// entries at a time in shared memory, transposed so that lane l's 16 entries sit at banks
// l, l + 32, ... (conflict-free reads), and each entry is read once for all 4 columns. The
// lanes' partial sums are added by a shuffle butterfly in a fixed order. There is no K
// split: this layout serves the tied head, whose 152,064 columns give thousands of blocks.
//
// Bound on the H100: bytes at decode. The codes are read once (the f32 scales, x and y
// are small): the int8 head [3584, 152064] is 545 MB = 0.163 ms at 3.35 TB/s; one 7B
// decode step's 113 launches (28 x (q|k|v, o, gate|up, down) + the head) read ~7.08 GB =
// 2.11 ms. What is left: the conversion of every code (4 byte-permutes, 4 subtractions
// and 2 packs per 4 codes) is ALU work that a smaller m cannot amortize, and the last
// split of a tile waits for the slowest.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "flash_mma.cuh"   // mma_bf16, ldmatrix_x4(_trans), cp_async16, cp_async_commit/wait

namespace {

constexpr int kThreads = 128;            // 4 warps; one column per thread on the CUDA cores
constexpr int kBN = 128;                 // columns per block (BLOCK_N in the wrapper)
constexpr int kRows = 32;                // code rows per ring stage (STAGE_ROWS)
constexpr int kStages = 4;
constexpr int kWStride = kBN + 16;       // bytes per ring row of codes (the 8 rows of an
                                         // ldmatrix phase hit 8 bank groups)
constexpr int kStageW = kRows * kWStride;
constexpr int kMaxProducts = 4;          // MAX_PRODUCTS
constexpr int kNkWarps = 8;              // layout 1
constexpr int kNkWarpCols = 4;           // columns per warp
constexpr int kNkChunk = 512;            // K entries per step: 32 lanes x 16 codes

// bytes per ring row of x: kRows entries + 16
template <typename T> constexpr int kXStride = kRows * (int)sizeof(T) + 16;
template <typename T, int BM> constexpr int kStage = kStageW + BM * kXStride<T>;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T> __device__ __forceinline__ void store_pair(T* p, float a, float b);
template <> __device__ __forceinline__ void store_pair<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <> __device__ __forceinline__ void store_pair<__nv_bfloat16>(__nv_bfloat16* p, float a,
                                                                      float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Byte j of `biased` (the four codes XOR 0x80, i.e. code + 128 as an unsigned byte) as
// the exact float code: 2^23 + (code + 128) has the byte as its low mantissa bits.
template <int J>
__device__ __forceinline__ float widen(uint32_t biased) {
  return __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7650 | J)) - 8388736.f;
}

// codes (bytes J0, J1 of a biased word) as a bf16 pair, J0 in the low half; exact
template <int J0, int J1>
__device__ __forceinline__ uint32_t codes_bf16x2(uint32_t biased) {
  return pack_bf16(widen<J0>(biased), widen<J1>(biased));
}

// The products of one launch: their codes, scales and output columns, and the prefix of
// their 128-column tiles (block x of the grid belongs to the product p with
// tile0[p] <= x < tile0[p + 1]).
struct Group {
  const int8_t* w[kMaxProducts];
  const float* scale[kMaxProducts];
  int n[kMaxProducts];
  int col0[kMaxProducts];        // the product's first column in out and partials
  int tile0[kMaxProducts + 1];
  int nprod;
};

// This block's product (its codes, scales, N and first output column), its column base
// within the product, and the K range of its split. The product is selected by unrolled
// comparisons, so the parameter arrays are never indexed at run time (no local copy).
struct Tile {
  const int8_t* w;
  const float* scale;
  int n, col0, col_base, k_begin, nchunks;
  __device__ Tile(const Group& g, int k, int rows_per_split) {
    w = g.w[0];
    scale = g.scale[0];
    n = g.n[0];
    col0 = g.col0[0];
    int t0 = 0;
#pragma unroll
    for (int i = 1; i < kMaxProducts; ++i)
      if (i < g.nprod && (int)blockIdx.x >= g.tile0[i]) {
        w = g.w[i];
        scale = g.scale[i];
        n = g.n[i];
        col0 = g.col0[i];
        t0 = g.tile0[i];
      }
    col_base = ((int)blockIdx.x - t0) * kBN;
    k_begin = blockIdx.y * rows_per_split;
    nchunks = max(0, min(k, k_begin + rows_per_split) - k_begin) / kRows;
  }
};

// This thread's 16-byte copies of every ring stage, addressed once: kW chunks of code
// rows (rows t/8 + 16 j, bytes (t % 8) * 16 of the block's 128 columns), then up to kX
// chunks of the block's rows of x; stage c adds c kRows rows (codes) or entries (x).
// Columns past n and rows past m are zero-filled.
template <typename T, int BM>
struct Copies {
  static constexpr int kW = kRows * 8 / kThreads;
  static constexpr int kXc = kRows * (int)sizeof(T) / 16;   // chunks per x row
  static constexpr int kX = (BM * kXc + kThreads - 1) / kThreads;
  const int8_t* w_src[kW];
  const T* x_src[kX];
  int w_dst[kW], x_dst[kX];
  bool w_in, x_use[kX], x_in[kX];
  size_t w_step;

  __device__ Copies(const int8_t* w, const T* x, int k_begin, int col_base, int row0, int m,
                    int k, int n) {
    const int t = threadIdx.x, ch = t & 7;
    w_in = col_base + ch * 16 < n;
    w_step = (size_t)kRows * n;
#pragma unroll
    for (int j = 0; j < kW; ++j) {
      const int r = (t >> 3) + j * (kThreads / 8);
      w_src[j] = w_in ? w + (size_t)(k_begin + r) * n + col_base + ch * 16 : w;
      w_dst[j] = r * kWStride + ch * 16;
    }
#pragma unroll
    for (int j = 0; j < kX; ++j) {
      const int i = t + j * kThreads, r = i / kXc, c = i % kXc;
      x_use[j] = i < BM * kXc;
      x_in[j] = x_use[j] && row0 + r < m;
      x_src[j] = x_in[j] ? x + (size_t)(row0 + r) * k + k_begin + c * (16 / (int)sizeof(T)) : x;
      x_dst[j] = kStageW + r * kXStride<T> + c * 16;
    }
  }

  __device__ __forceinline__ void fetch(uint8_t* st, int c) const {
    const size_t wo = w_in ? c * w_step : 0;
#pragma unroll
    for (int j = 0; j < kW; ++j) cp_async16(st + w_dst[j], w_src[j] + wo, w_in);
    const int xo = c * kRows;
#pragma unroll
    for (int j = 0; j < kX; ++j)
      if (x_use[j]) cp_async16(st + x_dst[j], x_src[j] + (x_in[j] ? xo : 0), x_in[j]);
  }
};

// The epilogue of a split tile: every split has written its partial sums; the last one
// to arrive adds them in split order, scales and rounds. Returns after the block's part.
template <typename TO, int BM>
__device__ __forceinline__ void finish_split(const float* partials, int* counters,
                                             const float* scale, TO* out, int m, int n,
                                             int ldo, int col0, int col_base, int row0) {
  __shared__ int last;
  __threadfence();   // this block's partial sums are visible before it is counted
  __syncthreads();
  if (threadIdx.x == 0) {
    int* cnt = counters + blockIdx.z * gridDim.x + blockIdx.x;
    last = atomicAdd(cnt, 1) == (int)gridDim.y - 1;
    if (last) *cnt = 0;   // ready for the next launch
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int col = col_base + threadIdx.x;   // one column per thread, BM rows
  if (col >= n) return;
  const float sc = __ldg(scale + col);
#pragma unroll 1
  for (int i = 0; i < BM; ++i) {
    const int row = row0 + i;
    if (row >= m) break;
    float s = 0.f;
    for (int p = 0; p < (int)gridDim.y; ++p)
      s += __ldcg(partials + ((size_t)p * m + row) * ldo + col0 + col);
    out[(size_t)row * ldo + col0 + col] = from_f32<TO>(s * sc);
  }
}

// ---------------------------------------------------------------- bf16: tensor cores

// grid (tiles of all products, splits, ceil(m / (8 NT))); dynamic shared memory
// kStages * kStage<bf16, 8 NT> bytes.
template <typename TO, int NT>
__global__ void __launch_bounds__(kThreads)
w8_mma_kernel(const __nv_bfloat16* __restrict__ x, const Group g, TO* __restrict__ out,
              float* __restrict__ partials, int* __restrict__ counters, int m, int k, int ldo,
              int rows_per_split) {
  using T = __nv_bfloat16;
  constexpr int BM = 8 * NT;
  constexpr int kStg = kStage<T, BM>;
  extern __shared__ __align__(16) uint8_t smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gr = lane >> 2, t = lane & 3, q = lane >> 3, r8 = lane & 7;
  const Tile tl(g, k, rows_per_split);
  const int n = tl.n, row0 = blockIdx.z * BM;
  const Copies<T, BM> cp(tl.w, x, tl.k_begin, tl.col_base, row0, m, k, n);
  auto load = [&](int c) { cp.fetch(smem + (c % kStages) * kStg, c); };

  // each stage's 32-k products sum on the tensor cores into fresh accumulators (part),
  // which join acc by f32 additions on the CUDA cores, stage after stage
  float acc[2][NT][4], part[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < tl.nchunks) load(s);
    cp_async_commit();
  }
  for (int c = 0; c < tl.nchunks; ++c) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // stage c has landed for every thread; stage c - 1 is consumed
    if (c + kStages - 1 < tl.nchunks) load(c + kStages - 1);
    cp_async_commit();
    const uint8_t* st = smem + (c % kStages) * kStg;
    // x rows 8 j + 0..7; matrices: k 0..7 | 8..15 | 16..23 | 24..31
    uint32_t b[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
      ldmatrix_x4(b[j], st + kStageW + (j * 8 + r8) * kXStride<T> + q * 16);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[mt][j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kRows / 16; ++ks) {
      // matrices: code rows 16 ks + 0..7 | 8..15 of columns warp*32 + 0..15, then 16..31
      uint32_t d[4];
      ldmatrix_x4_trans(d, st + (ks * 16 + (q & 1) * 8 + r8) * kWStride + warp * 32 +
                               (q >> 1) * 16);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const uint32_t e0 = d[2 * mt] ^ 0x80808080u, e1 = d[2 * mt + 1] ^ 0x80808080u;
        const uint32_t a[4] = {codes_bf16x2<0, 2>(e0), codes_bf16x2<1, 3>(e0),
                               codes_bf16x2<0, 2>(e1), codes_bf16x2<1, 3>(e1)};
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_bf16(part[mt][j], a, b[j][2 * ks], b[j][2 * ks + 1]);
      }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][j][e] += part[mt][j][e];
  }
  cp_async_wait<0>();

  // acc[mt][j]: e0, e2 = columns (col, col + 1) of x row 8 j + 2 t; e1, e3 the same of
  // row 8 j + 2 t + 1
  const float* scale = tl.scale;
  const int col0 = tl.col0;
  const bool split = gridDim.y > 1;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int col = tl.col_base + warp * 32 + mt * 16 + 2 * gr;
    if (col >= n) continue;
    float2 sc = make_float2(1.f, 1.f);
    if (!split) sc = __ldg(reinterpret_cast<const float2*>(scale + col));
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + j * 8 + 2 * t + h;
        if (row >= m) continue;
        const float v0 = acc[mt][j][h], v1 = acc[mt][j][2 + h];
        if (split)
          *reinterpret_cast<float2*>(partials + ((size_t)blockIdx.y * m + row) * ldo + col0 +
                                     col) = make_float2(v0, v1);
        else
          store_pair<TO>(out + (size_t)row * ldo + col0 + col, v0 * sc.x, v1 * sc.y);
      }
  }
  if (split)
    finish_split<TO, BM>(partials, counters, scale, out, m, n, ldo, col0, tl.col_base, row0);
}

// ---------------------------------------------------------------- f32: CUDA cores

// grid (tiles of all products, splits, ceil(m / BM)); dynamic shared memory
// kStages * kStage<float, BM> bytes.
template <typename TO, int BM>
__global__ void __launch_bounds__(kThreads)
w8_fma_kernel(const float* __restrict__ x, const Group g, TO* __restrict__ out,
              float* __restrict__ partials, int* __restrict__ counters, int m, int k, int ldo,
              int rows_per_split) {
  constexpr int kStg = kStage<float, BM>;
  constexpr int kXf = kXStride<float> / 4;   // x row stride in floats
  extern __shared__ __align__(16) uint8_t smem[];
  const Tile tl(g, k, rows_per_split);
  const int n = tl.n, row0 = blockIdx.z * BM;
  const int col = tl.col_base + threadIdx.x;
  const Copies<float, BM> cp(tl.w, x, tl.k_begin, tl.col_base, row0, m, k, n);
  auto load = [&](int c) { cp.fetch(smem + (c % kStages) * kStg, c); };
  float acc[BM];
#pragma unroll
  for (int i = 0; i < BM; ++i) acc[i] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < tl.nchunks) load(s);
    cp_async_commit();
  }
  for (int c = 0; c < tl.nchunks; ++c) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (c + kStages - 1 < tl.nchunks) load(c + kStages - 1);
    cp_async_commit();
    const uint8_t* wst = smem + (c % kStages) * kStg + threadIdx.x;
    const float* xst = reinterpret_cast<const float*>(smem + (c % kStages) * kStg + kStageW);
#pragma unroll
    for (int r4 = 0; r4 < kRows; r4 += 4) {
      float w[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) w[u] = widen<0>((uint32_t)wst[(r4 + u) * kWStride] ^ 0x80u);
#pragma unroll
      for (int i = 0; i < BM; ++i) {
        const float4 xv = *reinterpret_cast<const float4*>(xst + i * kXf + r4);
        acc[i] = fmaf(xv.w, w[3], fmaf(xv.z, w[2], fmaf(xv.y, w[1], fmaf(xv.x, w[0], acc[i]))));
      }
    }
  }
  cp_async_wait<0>();
  const float* scale = tl.scale;
  const int col0 = tl.col0;
  const bool split = gridDim.y > 1;
  if (col < n) {
    const float sc = split ? 1.f : __ldg(scale + col);
#pragma unroll
    for (int i = 0; i < BM; ++i) {
      const int row = row0 + i;
      if (row >= m) break;
      if (split)
        partials[((size_t)blockIdx.y * m + row) * ldo + col0 + col] = acc[i];
      else
        out[(size_t)row * ldo + col0 + col] = from_f32<TO>(acc[i] * sc);
    }
  }
  if (split)
    finish_split<TO, BM>(partials, counters, scale, out, m, n, ldo, col0, tl.col_base, row0);
}

template <typename K, typename TX, typename TO>
cudaError_t launch(K kernel, int bm, size_t stage, const TX* x, const Group& g, TO* out,
                   float* partials, int* counters, int m, int k, int ldo, int rows_per_split,
                   int splits, cudaStream_t stream) {
  const dim3 grid(g.tile0[g.nprod], splits, (m + bm - 1) / bm);
  const size_t smem = (size_t)kStages * stage;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(x, g, out, partials, counters, m, k, ldo,
                                           rows_per_split);
  return cudaGetLastError();
}

template <typename TO>
cudaError_t run_mma(const void* x, const Group& g, void* out, float* partials, int* counters,
                    int m, int k, int ldo, int rows_per_split, int splits,
                    cudaStream_t stream) {
  using T = __nv_bfloat16;
  const T* xb = static_cast<const T*>(x);
  TO* o = static_cast<TO*>(out);
#define AF_W8(NT) launch(w8_mma_kernel<TO, NT>, 8 * NT, kStage<T, 8 * NT>, xb, g, o, partials, \
                         counters, m, k, ldo, rows_per_split, splits, stream)
  return m <= 8 ? AF_W8(1) : m <= 16 ? AF_W8(2) : AF_W8(4);   // rows_per_block in the wrapper
#undef AF_W8
}

template <typename TO>
cudaError_t run_fma(const void* x, const Group& g, void* out, float* partials, int* counters,
                    int m, int k, int ldo, int rows_per_split, int splits,
                    cudaStream_t stream) {
  const float* xf = static_cast<const float*>(x);
  TO* o = static_cast<TO*>(out);
#define AF_W8(BM) launch(w8_fma_kernel<TO, BM>, BM, kStage<float, BM>, xf, g, o, partials, \
                         counters, m, k, ldo, rows_per_split, splits, stream)
  return m <= 1 ? AF_W8(1) : m <= 2 ? AF_W8(2) : m <= 4 ? AF_W8(4) : AF_W8(8);
#undef AF_W8
}

// ---------------------------------------------------------------- layout 1

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

template <typename TX, typename TO>
cudaError_t run_nk(const void* x, const void* w, const void* scale, void* out, int m, int k,
                   int n, cudaStream_t stream) {
  const int cols_per_block = kNkWarps * kNkWarpCols;
#define AF_NK(MT)                                                                  \
  w8_nk_kernel<TX, TO, MT><<<dim3((m + MT - 1) / MT, (n + cols_per_block - 1) /    \
                                                      cols_per_block),             \
                             kNkWarps * 32, 0, stream>>>(                          \
      static_cast<const TX*>(x), static_cast<const int8_t*>(w),                          \
      static_cast<const float*>(scale), static_cast<TO*>(out), m, k, n)
  if (m <= 1) AF_NK(1);
  else if (m <= 2) AF_NK(2);
  else if (m <= 4) AF_NK(4);
  else AF_NK(8);
#undef AF_NK
  return cudaGetLastError();
}

bool aligned(const void* p, uintptr_t a) { return reinterpret_cast<uintptr_t>(p) % a == 0; }

}  // namespace

// Layout 0, one launch for 1 to 4 products that share x. x [m, k] contiguous (x_dtype 0 =
// f32, 1 = bf16; 16-byte aligned); `table` a host array of 4 int64 per product: its codes
// [k, n] row-major (16-byte aligned), its f32 scales [n], its first column in out and
// partials, and n (a multiple of 16). out [m, ldo] (out_dtype 0 = f32, 1 = bf16), ldo >=
// the products' columns. K is split into `splits` runs of `rows_per_split` rows (whole
// 32-row stages; splits = ceil(k / rows_per_split)); with splits > 1, partials [splits,
// m, ldo] f32 and counters (one int per tile, zero, left zero) are needed. Returns a
// cudaError_t value (0 on success).
extern "C" int af_w8a16_matmul_group(const void* x, const int64_t* table, int nprod,
                                     void* out, void* partials, void* counters, int x_dtype,
                                     int out_dtype, int m, int k, int ldo,
                                     int rows_per_split, int splits, void* stream) {
  if (nprod <= 0 || nprod > kMaxProducts || m <= 0 || k <= 0 || k % kRows != 0 ||
      splits <= 0 || splits > 65535 || (x_dtype != 0 && x_dtype != 1) ||
      (out_dtype != 0 && out_dtype != 1) || rows_per_split <= 0 ||
      rows_per_split % kRows != 0 || splits != (k + rows_per_split - 1) / rows_per_split ||
      (splits > 1 && (partials == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (!aligned(x, 16) || !aligned(out, 8)) return (int)cudaErrorMisalignedAddress;
  Group g{};
  g.nprod = nprod;
  g.tile0[0] = 0;
  for (int p = 0; p < nprod; ++p) {
    g.w[p] = reinterpret_cast<const int8_t*>(table[4 * p]);
    g.scale[p] = reinterpret_cast<const float*>(table[4 * p + 1]);
    g.col0[p] = (int)table[4 * p + 2];
    g.n[p] = (int)table[4 * p + 3];
    if (g.n[p] <= 0 || g.n[p] % 16 != 0 || g.col0[p] % 2 != 0 || g.col0[p] + g.n[p] > ldo)
      return (int)cudaErrorInvalidValue;
    if (!aligned(g.w[p], 16) || !aligned(g.scale[p], 8)) return (int)cudaErrorMisalignedAddress;
    g.tile0[p + 1] = g.tile0[p] + (g.n[p] + kBN - 1) / kBN;
  }
  for (int p = nprod; p < kMaxProducts; ++p) g.tile0[p + 1] = g.tile0[nprod];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partials);
  int* cnt = static_cast<int*>(counters);
  cudaError_t err;
  if (x_dtype == 0 && out_dtype == 0)
    err = run_fma<float>(x, g, out, part, cnt, m, k, ldo, rows_per_split, splits, st);
  else if (x_dtype == 0)
    err = run_fma<__nv_bfloat16>(x, g, out, part, cnt, m, k, ldo, rows_per_split, splits,
                                 st);
  else if (out_dtype == 0)
    err = run_mma<float>(x, g, out, part, cnt, m, k, ldo, rows_per_split, splits, st);
  else
    err = run_mma<__nv_bfloat16>(x, g, out, part, cnt, m, k, ldo, rows_per_split, splits,
                                 st);
  return (int)err;
}

// Layout 1: x [m, k] contiguous (x_dtype 0 = f32, 1 = bf16), w [n, k] row-major (k % 16
// == 0, 16-byte aligned), scale [n] f32, out [m, n] (out_dtype 0 = f32, 1 = bf16).
// Returns a cudaError_t value (0 on success).
extern "C" int af_w8a16_matmul_nk(const void* x, const void* w, const void* scale, void* out,
                                  int x_dtype, int out_dtype, int m, int k, int n,
                                  void* stream) {
  if (m <= 0 || k <= 0 || n <= 0 || k % 16 != 0 || !aligned(w, 16) ||
      n / (kNkWarps * kNkWarpCols) >= 65535 || (x_dtype != 0 && x_dtype != 1) ||
      (out_dtype != 0 && out_dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (x_dtype == 0 && out_dtype == 0)
    err = run_nk<float, float>(x, w, scale, out, m, k, n, st);
  else if (x_dtype == 0)
    err = run_nk<float, __nv_bfloat16>(x, w, scale, out, m, k, n, st);
  else if (out_dtype == 0)
    err = run_nk<__nv_bfloat16, float>(x, w, scale, out, m, k, n, st);
  else
    err = run_nk<__nv_bfloat16, __nv_bfloat16>(x, w, scale, out, m, k, n, st);
  return (int)err;
}
