// Weight-only quantized matmul, y = x @ dequantize(w), for NVIDIA Hopper
// (sm_90a).
//
// opsagent_quant_matmul  replaces  quant_matmul_pallas
//     (opsagent_tpu/ops/quant_matmul_pallas.py, bodies _kernel_int8 and
//     _kernel_int4): every projection and the lm_head of a model served
//     with int8 or int4 weights. One launch per projection per forward.
//
// Contract (identical to the TPU kernel and to the plain PyTorch version in
// opsagent_tpu_torch/ops/quant_matmul.py): x [T, In] in bf16 or f32, row
// major; weight codes q int8 [In, Out] (int8) or packed [In / 2, Out]
// (int4: the low nibble is contraction row 2i, the high nibble row 2i + 1,
// both sign-extended); f32 scales [1, Out] (int8) or [G, 1, Out] (int4:
// row k takes scale row k / (In / G)). Each weight element is dequantized
// in f32 (code * scale), cast to x's dtype, and the products accumulate in
// f32; y [T, Out] is written in x's dtype.
//
// Design. Each thread block owns a BM x BN tile of y and walks the
// contraction axis 32 rows at a time. The block's threads load the next
// x tile and the next tile of weight codes into registers while the
// tensor cores (or, for f32, the CUDA cores) work on the current one, then
// dequantize the codes into shared memory in x's dtype: no dequantized
// copy of the weight is ever written to device memory, as on the TPU.
//   - bf16: mma.sync m16n8k16 (bf16 in, f32 accumulate), operands read
//     with ldmatrix (the weight tile is stored k-major and read with
//     .trans); BM = 16 for decode-sized T, 64 otherwise.
//   - f32: FMA on CUDA cores, so the product keeps full f32 (TF32 would
//     not hold the f32 tolerance).
// Ragged edges (T, In, Out not multiples of the tile) load zeros.
//
// What bounds it on the H100: a decode step (T = 8) reads each weight
// byte once and does 2 * T operations per byte, far below the ~295 the
// tensor cores need per byte: it is bound by the weight bytes at
// 3.35 TB/s. A mixed tick (T up to 1024) does 2 * T operations per byte
// and is bound by the tensor cores' 989 TFLOP/s.
//
// What this simple design leaves on the table, for later work:
//   - one tile of 32 rows in flight per block, and few blocks when Out is
//     narrow (Out / 64 for decode): the decode case is bound by load
//     latency, not bandwidth; a split over the contraction axis (or a
//     deeper cp.async / TMA pipeline) would fill the card;
//   - mma.sync on 64 x 64 tiles, not wgmma on larger ones;
//   - the int4 scales are read per element (through L1), not staged.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBK = 32;  // contraction rows per tile

// ---- loads ------------------------------------------------------------------

// 8 codes: columns [n, n + 8) of stored row `row` of q (zeros outside).
__device__ __forceinline__ uint2 load_codes(const int8_t* __restrict__ q, int row,
                                            int rows, int n, int Out, bool vec) {
  uint2 raw = make_uint2(0u, 0u);
  if (row >= rows) return raw;
  const int8_t* p = q + static_cast<size_t>(row) * Out + n;
  if (vec && n + 8 <= Out) return __ldg(reinterpret_cast<const uint2*>(p));
  uint32_t w[2] = {0u, 0u};
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (n + j < Out) w[j / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(p[j])) << (8 * (j % 4));
  raw.x = w[0];
  raw.y = w[1];
  return raw;
}

__device__ __forceinline__ uint8_t byte_of(uint2 raw, int j) {
  return static_cast<uint8_t>(((j < 4 ? raw.x : raw.y) >> (8 * (j % 4))) & 0xffu);
}

// 8 bf16 values: columns [k, k + 8) of row m of x (zeros outside).
__device__ __forceinline__ uint4 load_x(const __nv_bfloat16* __restrict__ x, int m,
                                        int T, int k, int In, bool vec) {
  uint4 raw = make_uint4(0u, 0u, 0u, 0u);
  if (m >= T || k >= In) return raw;
  const __nv_bfloat16* p = x + static_cast<size_t>(m) * In + k;
  if (vec) return __ldg(reinterpret_cast<const uint4*>(p));  // In % 8 == 0
  __align__(16) __nv_bfloat16 b[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) b[j] = k + j < In ? p[j] : __float2bfloat16(0.f);
  return *reinterpret_cast<const uint4*>(b);
}

// 4 f32 values: columns [k, k + 4) of row m of x (zeros outside).
__device__ __forceinline__ float4 load_x(const float* __restrict__ x, int m, int T,
                                         int k, int In, bool vec) {
  if (m >= T || k >= In) return make_float4(0.f, 0.f, 0.f, 0.f);
  const float* p = x + static_cast<size_t>(m) * In + k;
  if (vec) return __ldg(reinterpret_cast<const float4*>(p));  // In % 4 == 0
  float v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = k + j < In ? p[j] : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

// ---- dequantize into shared memory ----------------------------------------

__device__ __forceinline__ void store8(__nv_bfloat16* dst, const float (&v)[8]) {
  uint4 out;
  uint32_t* w = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const __nv_bfloat162 pair = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
    w[j] = *reinterpret_cast<const uint32_t*>(&pair);
  }
  *reinterpret_cast<uint4*>(dst) = out;
}

__device__ __forceinline__ void store8(float* dst, const float (&v)[8]) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// Dequantize one item of codes (8 columns from n, tile row r) into the
// k-major weight tile `ws` [kBK][ldb] at column `col`, in OT (x's dtype).
// int8: row r is contraction row k0 + r, scaled by s8 (this chunk's
// per-column scales). int4: packed row r holds rows k0 + 2r (low nibble)
// and k0 + 2r + 1 (high nibble).
template <int BITS, typename OT>
__device__ __forceinline__ void dequant_store(uint2 raw, int r, int k0, int n, int In,
                                              int Out, int group,
                                              const float* __restrict__ scale,
                                              const float (&s8)[8], OT* ws, int ldb,
                                              int col) {
  if constexpr (BITS == 8) {
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      v[j] = static_cast<float>(static_cast<int8_t>(byte_of(raw, j))) * s8[j];
    store8(ws + r * ldb + col, v);
  } else {
    const int kl = k0 + 2 * r, kh = kl + 1;
    const float* sl = scale + static_cast<size_t>(kl / group) * Out + n;
    const float* sh = scale + static_cast<size_t>(kh / group) * Out + n;
    float lo[8], hi[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint8_t u = byte_of(raw, j);
      const int low = static_cast<int8_t>(static_cast<uint8_t>(u << 4)) >> 4;
      const int high = static_cast<int8_t>(u) >> 4;
      const bool col_ok = n + j < Out;
      lo[j] = col_ok && kl < In ? static_cast<float>(low) * __ldg(sl + j) : 0.f;
      hi[j] = col_ok && kh < In ? static_cast<float>(high) * __ldg(sh + j) : 0.f;
    }
    store8(ws + (2 * r) * ldb + col, lo);
    store8(ws + (2 * r + 1) * ldb + col, hi);
  }
}

// ---- tensor-core primitives ------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---- bf16 activations: mma.sync ----------------------------------------------

// Block tile BM x BN of y, WM x WN warps, each warp a (BM / WM) x (BN / WN)
// tile of m16n8 products.
template <int BITS, int BM, int BN, int WM, int WN>
__global__ void __launch_bounds__(WM * WN * 32) qmm_bf16_kernel(
    const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
    const float* __restrict__ scale, __nv_bfloat16* __restrict__ y, int T, int In,
    int Out, int group) {
  constexpr int kThreads = WM * WN * 32;
  constexpr int LDA = kBK + 8;  // padded rows: ldmatrix reads hit distinct banks
  constexpr int LDB = BN + 8;
  constexpr int WTM = BM / WM, WTN = BN / WN;
  constexpr int MT = WTM / 16, NT = WTN / 8;
  constexpr int NCH = BN / 8;                       // 8-column chunks per row
  constexpr int QROWS = BITS == 8 ? kBK : kBK / 2;  // stored code rows per tile
  constexpr int W_ITEMS = QROWS * NCH;
  constexpr int W_ITERS = (W_ITEMS + kThreads - 1) / kThreads;
  constexpr int A_ITEMS = BM * (kBK / 8);
  constexpr int A_ITERS = (A_ITEMS + kThreads - 1) / kThreads;
  static_assert(MT >= 1 && NT % 2 == 0 && kThreads % NCH == 0, "tile shape");

  __shared__ __align__(16) __nv_bfloat16 xs[BM * LDA];
  __shared__ __align__(16) __nv_bfloat16 ws[kBK * LDB];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / WN, wn = warp % WN;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int qrows = BITS == 8 ? In : In / 2;
  const bool wvec = Out % 8 == 0, xvec = In % 8 == 0;
  const int nc = tid % NCH;  // every item of this thread has this chunk
  const int n = n0 + nc * 8;

  float s8[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) s8[j] = BITS == 8 && n + j < Out ? __ldg(scale + n + j) : 0.f;

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  uint4 x_raw[A_ITERS];
  uint2 w_raw[W_ITERS];
  auto load_tiles = [&](int k0) {
#pragma unroll
    for (int it = 0; it < A_ITERS; ++it) {
      const int i = tid + it * kThreads;
      if (i < A_ITEMS) x_raw[it] = load_x(x, m0 + i / 4, T, k0 + (i % 4) * 8, In, xvec);
    }
#pragma unroll
    for (int it = 0; it < W_ITERS; ++it) {
      const int i = tid + it * kThreads;
      const int row = (BITS == 8 ? k0 : k0 / 2) + i / NCH;
      if (i < W_ITEMS) w_raw[it] = load_codes(q, row, qrows, n, Out, wvec);
    }
  };

  const int ntiles = (In + kBK - 1) / kBK;
  load_tiles(0);
  for (int kt = 0; kt < ntiles; ++kt) {
    const int k0 = kt * kBK;
#pragma unroll
    for (int it = 0; it < A_ITERS; ++it) {
      const int i = tid + it * kThreads;
      if (i < A_ITEMS) *reinterpret_cast<uint4*>(xs + (i / 4) * LDA + (i % 4) * 8) = x_raw[it];
    }
#pragma unroll
    for (int it = 0; it < W_ITERS; ++it) {
      const int i = tid + it * kThreads;
      if (i < W_ITEMS)
        dequant_store<BITS>(w_raw[it], i / NCH, k0, n, In, Out, group, scale, s8, ws, LDB,
                            nc * 8);
    }
    __syncthreads();
    if (kt + 1 < ntiles) load_tiles(k0 + kBK);  // in flight during the products
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldmatrix_x4(a[mt], xs + (wm * WTM + mt * 16 + (lane & 15)) * LDA + ks * 16 +
                               (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, ws + (ks * 16 + (lane & 15)) * LDB + wn * WTN + np * 16 +
                                 (lane >> 4) * 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(acc[mt][2 * np], a[mt], b[0], b[1]);
          mma_bf16(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
        }
      }
    }
    __syncthreads();
  }

  const int g = lane / 4, tig = lane % 4;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * WTM + mt * 16 + g + h * 8;
        const int col = n0 + wn * WTN + nt * 8 + tig * 2;
        if (row >= T) continue;
        __nv_bfloat16* out = y + static_cast<size_t>(row) * Out + col;
        if (col < Out) out[0] = __float2bfloat16(acc[mt][nt][2 * h]);
        if (col + 1 < Out) out[1] = __float2bfloat16(acc[mt][nt][2 * h + 1]);
      }
}

// ---- f32 activations: CUDA cores ---------------------------------------------

constexpr int kF32BM = 32, kF32BN = 64, kF32Threads = 256;

// 16 x 16 threads; thread (ty, tx) owns rows 2ty, 2ty + 1 and columns
// tx + 16j (j < 4) of the block's 32 x 64 tile.
template <int BITS>
__global__ void __launch_bounds__(kF32Threads) qmm_f32_kernel(
    const float* __restrict__ x, const int8_t* __restrict__ q,
    const float* __restrict__ scale, float* __restrict__ y, int T, int In, int Out,
    int group) {
  constexpr int BM = kF32BM, BN = kF32BN, kThreads = kF32Threads;
  constexpr int NCH = BN / 8;
  constexpr int QROWS = BITS == 8 ? kBK : kBK / 2;
  constexpr int W_ITEMS = QROWS * NCH;
  constexpr int W_ITERS = (W_ITEMS + kThreads - 1) / kThreads;
  constexpr int A_ITEMS = BM * (kBK / 4);
  constexpr int A_ITERS = (A_ITEMS + kThreads - 1) / kThreads;
  static_assert(kThreads % NCH == 0, "tile shape");

  __shared__ float xs[BM][kBK + 1];
  __shared__ __align__(16) float ws[kBK * BN];

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int qrows = BITS == 8 ? In : In / 2;
  const bool wvec = Out % 8 == 0, xvec = In % 4 == 0;
  const int nc = tid % NCH;
  const int n = n0 + nc * 8;

  float s8[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) s8[j] = BITS == 8 && n + j < Out ? __ldg(scale + n + j) : 0.f;

  float acc[2][4] = {};
  float4 x_raw[A_ITERS];
  uint2 w_raw[W_ITERS];
  auto load_tiles = [&](int k0) {
#pragma unroll
    for (int it = 0; it < A_ITERS; ++it) {
      const int i = tid + it * kThreads;
      if (i < A_ITEMS) x_raw[it] = load_x(x, m0 + i / 8, T, k0 + (i % 8) * 4, In, xvec);
    }
#pragma unroll
    for (int it = 0; it < W_ITERS; ++it) {
      const int i = tid + it * kThreads;
      const int row = (BITS == 8 ? k0 : k0 / 2) + i / NCH;
      if (i < W_ITEMS) w_raw[it] = load_codes(q, row, qrows, n, Out, wvec);
    }
  };

  const int ntiles = (In + kBK - 1) / kBK;
  load_tiles(0);
  for (int kt = 0; kt < ntiles; ++kt) {
    const int k0 = kt * kBK;
#pragma unroll
    for (int it = 0; it < A_ITERS; ++it) {
      const int i = tid + it * kThreads;
      if (i < A_ITEMS) {
        float* dst = &xs[i / 8][(i % 8) * 4];
        dst[0] = x_raw[it].x;
        dst[1] = x_raw[it].y;
        dst[2] = x_raw[it].z;
        dst[3] = x_raw[it].w;
      }
    }
#pragma unroll
    for (int it = 0; it < W_ITERS; ++it) {
      const int i = tid + it * kThreads;
      if (i < W_ITEMS)
        dequant_store<BITS>(w_raw[it], i / NCH, k0, n, In, Out, group, scale, s8, ws, BN,
                            nc * 8);
    }
    __syncthreads();
    if (kt + 1 < ntiles) load_tiles(k0 + kBK);
#pragma unroll 8
    for (int k = 0; k < kBK; ++k) {
      const float a0 = xs[2 * ty][k], a1 = xs[2 * ty + 1][k];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float b = ws[k * BN + tx + 16 * j];
        acc[0][j] = fmaf(a0, b, acc[0][j]);
        acc[1][j] = fmaf(a1, b, acc[1][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = m0 + 2 * ty + h;
    if (row >= T) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < Out) y[static_cast<size_t>(row) * Out + col] = acc[h][j];
    }
  }
}

// ---- launch -------------------------------------------------------------------

template <int BITS, int BM, int BN, int WM, int WN>
cudaError_t launch_bf16(const void* x, const void* q, const void* scale, void* y, int T,
                        int In, int Out, int group, cudaStream_t stream) {
  const dim3 grid((Out + BN - 1) / BN, (T + BM - 1) / BM);
  qmm_bf16_kernel<BITS, BM, BN, WM, WN><<<grid, WM * WN * 32, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q),
      static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(y), T, In, Out, group);
  return cudaGetLastError();
}

template <int BITS>
cudaError_t launch(const void* x, const void* q, const void* scale, void* y, int T, int In,
                   int Out, int group, int dtype, cudaStream_t stream) {
  if (dtype == 1) {  // bf16
    if (T <= 16) return launch_bf16<BITS, 16, 64, 1, 4>(x, q, scale, y, T, In, Out, group, stream);
    return launch_bf16<BITS, 64, 64, 2, 2>(x, q, scale, y, T, In, Out, group, stream);
  }
  if (dtype == 0) {  // f32
    const dim3 grid((Out + kF32BN - 1) / kF32BN, (T + kF32BM - 1) / kF32BM);
    qmm_f32_kernel<BITS><<<grid, kF32Threads, 0, stream>>>(
        static_cast<const float*>(x), static_cast<const int8_t*>(q),
        static_cast<const float*>(scale), static_cast<float*>(y), T, In, Out, group);
    return cudaGetLastError();
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C interface, bound with ctypes. Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() (0 = launched). `bits` is 8
// or 4; `group` is the int4 scale group In / G (ignored for int8); `dtype`
// 0 = f32, 1 = bf16.
extern "C" int opsagent_quant_matmul(const void* x, const void* q, const void* scale,
                                     void* y, int T, int In, int Out, int bits, int group,
                                     int dtype, void* stream) {
  if (T == 0 || Out == 0) return cudaSuccess;
  const auto s = static_cast<cudaStream_t>(stream);
  if (bits == 8) return launch<8>(x, q, scale, y, T, In, Out, group, dtype, s);
  if (bits == 4 && In % 2 == 0 && group > 0 && In % group == 0)
    return launch<4>(x, q, scale, y, T, In, Out, group, dtype, s);
  return cudaErrorInvalidValue;
}
