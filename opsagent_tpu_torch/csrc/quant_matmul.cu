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
// f32; y [T, Out] is written in x's dtype. The scale stays inside the
// product: applying it to the sums would round each weight differently.
//
// Five instances, chosen by the caller from shapes alone (the rule is
// `plan` in ops/quant_matmul.py, restated and checked here). Two are the
// staged kernels, qmm_m128_kernel and qmm_m16_kernel below, built from the
// same stage functions; they take bf16 x when In % 8 == 0, Out % 16 == 0
// and, for int4, the scale group is even and >= 16: every 16-byte copy is
// aligned and each packed byte's two rows share one scale row. Every
// projection and lm_head of bench-8b and Qwen2.5-7B qualifies.
//   - m128, T > 16 (mixed ticks): 128 rows of x a block.
//   - m16, T <= 16 (decode steps, the lm_head): 16 rows of x a block, the
//     contraction axis split over blocks.
//   - m64, T > 16 at any other shape (a ragged In, an odd group):
//     qmm_bf16_kernel with 64 x 64 tiles.
//   - r16, T <= 16 at any other shape: qmm_bf16_kernel with 16 x 64 tiles.
//   - f32 x: qmm_f32_kernel, FMA on CUDA cores, so the product keeps full
//     f32 (TF32 would not hold the f32 tolerance).
//
// What bounds it on the H100: a decode step (T = 8) reads each weight
// byte once and does 2 * T operations per byte, far below the ~295 the
// tensor cores need per byte: it is bound by the weight bytes at
// 3.35 TB/s. A mixed tick (T = 128 to 1024) does 2 * T operations per byte
// and is bound by the tensor cores' 989 TFLOP/s.
//
// The staged kernels. A block owns ROWS rows of x by BN = 128 columns of y
// (64 where 128-wide column tiles would leave most SMs idle); each warp a
// tile of m16n8k16 products (mma.sync, bf16 in, f32 accumulate). The
// contraction axis goes 64 rows a stage through a ring of stages in
// dynamic shared memory, each holding the raw operands: the x tile
// (ROWS x 64 bf16), the codes (64 x BN int8, or 32 x BN packed int4) and,
// for int4, the few scale rows the stage touches; all filled by 16-byte
// cp.async, zero-filled past T, In and Out. Each stage is dequantized once
// per block into one bf16 tile (code to f32 by byte permute, times its
// scale in f32, rounded to bf16), which all warps read with
// ldmatrix.trans. int8 scales sit in registers (each thread dequantizes
// the same 8 columns every stage); int4 scales are read from the staged
// rows, never per element from device memory. Two barriers per 64 rows.
//
// m128 (the mixed ticks): 8 warps (2 x 4) of 64 x BN/4 tiles, a 3-stage
// ring, two blocks an SM (~95 KB of shared memory each); the cost of
// dequantizing is spread over 128 rows of x. Blocks walk the rows of x
// fastest, so the blocks in flight share weight columns and the weight is
// read from device memory about once. Measured against alternatives on the
// H100 (scripts/ablate_quant_matmul.py): 64 x 64 warp tiles (4 warps a
// block), 128 x 256 blocks and a 4-stage ring were all slower, and a
// second bf16 tile that lets stage s + 1 be dequantized beside stage s's
// products gained at most 1 %; with the products removed the kernel is no
// faster, so the stage's serial phases (wait, barrier, dequantize, barrier,
// products), not the tensor cores, set its pace.
//
// The two kernels share the stage functions (issue_stage, dequantize_stage,
// stage_products) but keep their own stage loops: one template body that
// also carried m16's split ran m128 4-16 % slower at T = 1024 on the H100
// (scripts/ab_quant_matmul.py against the source before m16 existed).
//
// m16 (decode steps, lm_heads; bound by the weight bytes): 4 warps (1 x 4)
// of 16 x BN/4 tiles, x's T <= 16 rows zero-filled to 16, a 4-stage ring,
// three blocks an SM (~59 KB int8, ~53 KB int4). A decode step's
// projections have too few column tiles to keep enough bytes in flight
// (wg: 112, wk: 16), so the contraction axis is split over blockIdx.z
// (ops/quant_matmul.py `split_k`: about two waves of blocks, each split at
// least 4 whole stages; one split where the column tiles fill the card, as
// the lm_head's do). One split writes y directly. More write f32 partials
// to a workspace; the last block of a tile to arrive (an atomic counter per
// tile, after __threadfence) adds them in split order 0 .. S - 1, read
// past L1, writes y and resets its counter: y is bit-identical from run to
// run, and a projection stays one launch.
//
// What it leaves for later work: mma.sync, not wgmma with TMA and warp
// specialisation (a producer warp would take the loads and the
// dequantization off the consumers' path); at decode, the partials'
// round trip through L2 and the padding of T = 8 to 16 rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "mma_ptx.cuh"

namespace {

using namespace ptx;

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

// ---- bf16 activations: mma.sync ----------------------------------------------

// The r16 and m64 instances. Block tile BM x BN of y, WM x WN warps, each
// warp a (BM / WM) x (BN / WN) tile of m16n8 products. The contraction axis
// goes kBK rows a tile: the next tile's x and codes load into registers
// while the tensor cores work on the current one, then are dequantized into
// shared memory in x's dtype.
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

// ---- bf16 activations, aligned shapes: the m128 and m16 instances -----------

constexpr int kStageK = 64;     // contraction rows per stage
constexpr int kScaleRows = 5;   // int4 scale rows 64 contraction rows touch, group >= 16

// The staged kernel's two instances, by the rows of x a block owns.
//   m128 (T > 16, mixed ticks): 8 warps, 2 (rows) x 4 (columns), each a
//     64 x BN/4 tile; a ring of 3 stages; two blocks an SM.
//   m16 (T <= 16, decode steps and lm_heads): 4 warps, 1 x 4, each a
//     16 x BN/4 tile; a ring of 4 stages; three blocks an SM.
template <int ROWS>
struct Staged {
  static constexpr int WM = ROWS == 128 ? 2 : 1;  // warps along the rows
  static constexpr int WN = 4;                    // warps along the columns
  static constexpr int THREADS = WM * WN * 32;
  static constexpr int STAGES = ROWS == 128 ? 3 : 4;
  static constexpr int MIN_BLOCKS = ROWS == 128 ? 2 : 3;
};

// Dynamic shared memory of one block: STAGES stages of raw operands (x tile
// [ROWS][64 + 8] bf16, codes [QROWS][BN] int8, int4 scale rows
// [kScaleRows][BN] f32), then the dequantized weight tile [64][BN + 8]
// bf16. Padded rows keep ldmatrix free of bank conflicts; every part is a
// multiple of 16 bytes.
template <int ROWS, int BITS, int BN>
struct StagedLayout {
  static constexpr int LDA = kStageK + 8;
  static constexpr int LDB = BN + 8;
  static constexpr int QROWS = BITS == 8 ? kStageK : kStageK / 2;  // stored code rows a stage
  static constexpr int X_BYTES = ROWS * LDA * 2;
  static constexpr int Q_BYTES = QROWS * BN;
  static constexpr int S_BYTES = BITS == 4 ? kScaleRows * BN * 4 : 0;
  static constexpr int STAGE = X_BYTES + Q_BYTES + S_BYTES;
  static constexpr int SMEM = Staged<ROWS>::STAGES * STAGE + kStageK * LDB * 2;
};

// The stage functions both staged kernels call. A block's ring slot
// `base` holds one stage's raw operands; `k0` is the stage's first
// contraction row.

// Stage k0's operands into the slot at `base`, by 16-byte cp.async.
template <int ROWS, int BITS, int BN>
__device__ __forceinline__ void issue_stage(unsigned char* base, const __nv_bfloat16* __restrict__ x,
                                            const int8_t* __restrict__ q,
                                            const float* __restrict__ scale, int k0, int m0,
                                            int n0, int T, int In, int Out, int group,
                                            int tid) {
  using L = StagedLayout<ROWS, BITS, BN>;
  constexpr int THREADS = Staged<ROWS>::THREADS;
  constexpr int QCP = BN / 16;                       // 16-byte copies per code row
  constexpr int SCP = BN / 4;                        // 16-byte copies per scale row
  constexpr int XCP = ROWS * kStageK / 8 / THREADS;  // x copies per thread
  static_assert(XCP * THREADS * 8 == ROWS * kStageK, "tile shape");
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(base);
  int8_t* qs = reinterpret_cast<int8_t*>(base + L::X_BYTES);
#pragma unroll
  for (int it = 0; it < XCP; ++it) {
    const int i = tid + it * THREADS;
    const int r = i / 8, c = (i % 8) * 8;
    const bool ok = m0 + r < T && k0 + c < In;
    cp_async16(xs + r * L::LDA + c, x + (ok ? static_cast<size_t>(m0 + r) * In + k0 + c : 0), ok);
  }
  const int qrows = BITS == 8 ? In : In / 2;
  const int row0 = BITS == 8 ? k0 : k0 / 2;
#pragma unroll
  for (int it = 0; it < (L::QROWS * QCP + THREADS - 1) / THREADS; ++it) {
    const int i = tid + it * THREADS;
    if ((L::QROWS * QCP) % THREADS != 0 && i >= L::QROWS * QCP) break;
    const int r = i / QCP, c = (i % QCP) * 16;
    const bool ok = row0 + r < qrows && n0 + c < Out;
    cp_async16(qs + r * BN + c, q + (ok ? static_cast<size_t>(row0 + r) * Out + n0 + c : 0), ok);
  }
  if constexpr (BITS == 4) {
    // The scale rows of the groups this stage's contraction rows fall in.
    float* ss = reinterpret_cast<float*>(base + L::X_BYTES + L::Q_BYTES);
    const int g_lo = k0 / group, g_hi = (min(k0 + kStageK, In) - 1) / group;
    for (int i = tid; i < (g_hi - g_lo + 1) * SCP; i += THREADS) {
      const int r = i / SCP, c = (i % SCP) * 4;
      const bool ok = n0 + c < Out;
      cp_async16(ss + r * BN + c, scale + (ok ? static_cast<size_t>(g_lo + r) * Out + n0 + c : 0),
                 ok);
    }
  }
}

// The codes of the stage at `base`, dequantized into the bf16 tile ws
// [64][LDB]. Thread tid dequantizes the 8 columns from (tid % (BN / 8)) * 8
// every stage; `s8` holds their int8 scales.
template <int ROWS, int BITS, int BN>
__device__ __forceinline__ void dequantize_stage(const unsigned char* base, __nv_bfloat16* ws,
                                                 int k0, int In, int group,
                                                 const float (&s8)[8], int tid) {
  using L = StagedLayout<ROWS, BITS, BN>;
  constexpr int CH = BN / 8;                         // 8-column chunks of a code row
  constexpr int RPP = Staged<ROWS>::THREADS / CH;    // code rows the block dequantizes per pass
  constexpr int ITEMS = L::QROWS / RPP;              // chunks each thread dequantizes per stage
  static_assert(L::QROWS % RPP == 0, "tile shape");
  const int8_t* qs = reinterpret_cast<const int8_t*>(base + L::X_BYTES);
  const int ch = tid % CH;
  const bool one_group = BITS == 4 && group % kStageK == 0;  // one int4 scale row a stage
#pragma unroll
  for (int it = 0; it < ITEMS; ++it) {
    const int r = tid / CH + it * RPP;  // stored code row of the stage
    const uint2 raw = *reinterpret_cast<const uint2*>(qs + r * BN + ch * 8);
    if constexpr (BITS == 8) {
      const uint32_t w[2] = {raw.x ^ 0x80808080u, raw.y ^ 0x80808080u};
      uint4 out;
      uint32_t* o = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        o[e] = pack_bf16(code_f32(w[e / 2], 2 * (e % 2)) * s8[2 * e],
                         code_f32(w[e / 2], 2 * (e % 2) + 1) * s8[2 * e + 1]);
      }
      *reinterpret_cast<uint4*>(ws + r * L::LDB + ch * 8) = out;
    } else {
      // Rows k0 + 2r (low nibbles) and k0 + 2r + 1 (high) share a group:
      // the group is even. A group that 64 divides puts the whole stage in
      // one scale row, with no division. Rows past In hold zero codes; they
      // read the last staged scale row, which is finite.
      const float* ss = reinterpret_cast<const float*>(base + L::X_BYTES + L::Q_BYTES);
      const int gi = one_group ? 0 : min(k0 + 2 * r, In - 1) / group - k0 / group;
      const float4 sa = *reinterpret_cast<const float4*>(ss + gi * BN + ch * 8);
      const float4 sb = *reinterpret_cast<const float4*>(ss + gi * BN + ch * 8 + 4);
      const float sc[8] = {sa.x, sa.y, sa.z, sa.w, sb.x, sb.y, sb.z, sb.w};
      // Each nibble offset to unsigned (n ^ 8 = code + 8) in its own byte.
      const uint32_t lo[2] = {(raw.x & 0x0F0F0F0Fu) ^ 0x08080808u,
                              (raw.y & 0x0F0F0F0Fu) ^ 0x08080808u};
      const uint32_t hi[2] = {((raw.x >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u,
                              ((raw.y >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u};
      constexpr float kBias = 8388616.f;  // 2^23 + 8
      uint4 out_lo, out_hi;
      uint32_t* ol = reinterpret_cast<uint32_t*>(&out_lo);
      uint32_t* oh = reinterpret_cast<uint32_t*>(&out_hi);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int b = 2 * (e % 2);
        ol[e] = pack_bf16((byte_f32(lo[e / 2], b) - kBias) * sc[2 * e],
                          (byte_f32(lo[e / 2], b + 1) - kBias) * sc[2 * e + 1]);
        oh[e] = pack_bf16((byte_f32(hi[e / 2], b) - kBias) * sc[2 * e],
                          (byte_f32(hi[e / 2], b + 1) - kBias) * sc[2 * e + 1]);
      }
      *reinterpret_cast<uint4*>(ws + (2 * r) * L::LDB + ch * 8) = out_lo;
      *reinterpret_cast<uint4*>(ws + (2 * r + 1) * L::LDB + ch * 8) = out_hi;
    }
  }
}

// A warp's products over one stage: its (ROWS / WM) x (BN / WN) tile of y
// from the x tile xs [ROWS][LDA] and the dequantized weight tile ws.
template <int ROWS, int BITS, int BN, int MT, int NT>
__device__ __forceinline__ void stage_products(float (&acc)[MT][NT][4],
                                               const __nv_bfloat16* xs,
                                               const __nv_bfloat16* ws, int wm, int wn,
                                               int lane) {
  using L = StagedLayout<ROWS, BITS, BN>;
  static_assert(NT % 2 == 0, "tile shape");
#pragma unroll
  for (int ks = 0; ks < kStageK / 16; ++ks) {
    uint32_t a[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      ldmatrix_x4(a[mt], xs + (wm * MT * 16 + mt * 16 + (lane & 15)) * L::LDA + ks * 16 +
                             (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, ws + (ks * 16 + (lane & 15)) * L::LDB + wn * NT * 8 + np * 16 +
                               (lane >> 4) * 8);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16(acc[mt][2 * np], a[mt], b[0], b[1]);
        mma_bf16(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
      }
    }
  }
}

// The m128 instance. Blocks (blockIdx.x, blockIdx.y) own rows
// [128 x, 128 (x + 1)) of x and columns [BN y, BN (y + 1)) of y, and walk
// the whole contraction axis.
template <int BITS, int BN>
__global__ void __launch_bounds__(Staged<128>::THREADS, Staged<128>::MIN_BLOCKS) qmm_m128_kernel(
    const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
    const float* __restrict__ scale, __nv_bfloat16* __restrict__ y, int T, int In,
    int Out, int group) {
  using C = Staged<128>;
  using L = StagedLayout<128, BITS, BN>;
  constexpr int MT = 128 / C::WM / 16, NT = BN / C::WN / 8;

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem + C::STAGES * L::STAGE);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp / C::WN, wn = warp % C::WN;
  const int m0 = blockIdx.x * 128, n0 = blockIdx.y * BN;
  const int stages = (In + kStageK - 1) / kStageK;
  const int n_ch = n0 + (tid % (BN / 8)) * 8;

  float s8[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) s8[j] = BITS == 8 && n_ch + j < Out ? __ldg(scale + n_ch + j) : 0.f;

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  // Stage s's operands into ring slot s % STAGES.
  auto issue = [&](int s) {
    issue_stage<128, BITS, BN>(smem + (s % C::STAGES) * L::STAGE, x, q, scale, s * kStageK, m0,
                               n0, T, In, Out, group, tid);
  };
  // One commit group per stage, empty past the last, so that wait_group 1
  // always means "stage s has landed".
  issue(0);
  cp_async_commit();
  if (stages > 1) issue(1);
  cp_async_commit();
  for (int s = 0; s < stages; ++s) {
    cp_async_wait<1>();
    __syncthreads();  // stage s landed for every thread; stage s - 1 fully consumed
    if (s + 2 < stages) issue(s + 2);  // into the slot stage s - 1 held
    cp_async_commit();
    const unsigned char* slot = smem + (s % C::STAGES) * L::STAGE;
    dequantize_stage<128, BITS, BN>(slot, ws, s * kStageK, In, group, s8, tid);
    __syncthreads();  // the bf16 weight tile is written
    stage_products<128, BITS, BN>(acc, reinterpret_cast<const __nv_bfloat16*>(slot), ws, wm, wn,
                                  lane);
  }

  // Out % 16 == 0: a pair of columns is wholly inside or outside.
  const int g = lane / 4, tig = lane % 4;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * MT * 16 + mt * 16 + g + h * 8;
        const int col = n0 + wn * NT * 8 + nt * 8 + tig * 2;
        if (row < T && col < Out) {
          *reinterpret_cast<uint32_t*>(y + static_cast<size_t>(row) * Out + col) =
              pack_bf16(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
        }
      }
}

// The m16 instance. Blocks (blockIdx.x, blockIdx.y, blockIdx.z) own rows
// [16 x, 16 (x + 1)) of x, columns [BN y, BN (y + 1)) of y, and split z of
// gridDim.z: a run of whole stages of the contraction axis, the stages
// shared out evenly. With one split a block writes y. With more, it writes
// its f32 sums to partial [splits, T, Out]; the last block of the (x, y)
// tile to arrive, counted by the int counters that follow the partials,
// adds them in split order and writes y.
template <int BITS, int BN>
__global__ void __launch_bounds__(Staged<16>::THREADS, Staged<16>::MIN_BLOCKS) qmm_m16_kernel(
    const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
    const float* __restrict__ scale, __nv_bfloat16* __restrict__ y, int T, int In,
    int Out, int group, float* __restrict__ partial) {
  using C = Staged<16>;
  using L = StagedLayout<16, BITS, BN>;
  constexpr int STAGES = C::STAGES;
  constexpr int MT = 1, NT = BN / C::WN / 8;

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem + STAGES * L::STAGE);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wn = warp % C::WN;
  const int m0 = blockIdx.x * 16, n0 = blockIdx.y * BN;
  const int splits = gridDim.z, all = (In + kStageK - 1) / kStageK;
  const int s0 = blockIdx.z * all / splits, s1 = (blockIdx.z + 1) * all / splits;
  const int n_ch = n0 + (tid % (BN / 8)) * 8;

  float s8[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) s8[j] = BITS == 8 && n_ch + j < Out ? __ldg(scale + n_ch + j) : 0.f;

  float acc[MT][NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[0][nt][e] = 0.f;

  // Stage s's operands into ring slot s % STAGES.
  auto issue = [&](int s) {
    issue_stage<16, BITS, BN>(smem + (s % STAGES) * L::STAGE, x, q, scale, s * kStageK, m0, n0,
                              T, In, Out, group, tid);
  };
  // One commit group per stage, empty past the last, so that
  // wait_group STAGES - 2 always means "stage s has landed".
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (s0 + i < s1) issue(s0 + i);
    cp_async_commit();
  }
  for (int s = s0; s < s1; ++s) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage s landed for every thread; stage s - 1 fully consumed
    if (s + STAGES - 1 < s1) issue(s + STAGES - 1);  // into the slot stage s - 1 held
    cp_async_commit();
    const unsigned char* slot = smem + (s % STAGES) * L::STAGE;
    dequantize_stage<16, BITS, BN>(slot, ws, s * kStageK, In, group, s8, tid);
    __syncthreads();  // the bf16 weight tile is written
    stage_products<16, BITS, BN>(acc, reinterpret_cast<const __nv_bfloat16*>(slot), ws, 0, wn,
                                 lane);
  }

  // Out % 16 == 0: a pair of columns is wholly inside or outside. One
  // split writes y; more write this split's sums into its partial.
  const int g = lane / 4, tig = lane % 4;
  float* mine = partial + static_cast<size_t>(blockIdx.z) * T * Out;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + g + h * 8;
      const int col = n0 + wn * NT * 8 + nt * 8 + tig * 2;
      if (row >= T || col >= Out) continue;
      const size_t at = static_cast<size_t>(row) * Out + col;
      if (splits == 1)
        *reinterpret_cast<uint32_t*>(y + at) = pack_bf16(acc[0][nt][2 * h], acc[0][nt][2 * h + 1]);
      else
        *reinterpret_cast<float2*>(mine + at) = make_float2(acc[0][nt][2 * h], acc[0][nt][2 * h + 1]);
    }
  if (splits == 1) return;

  // The last block of this tile to arrive adds the partials in split order
  // 0 .. splits - 1, whichever block that is: y is the same from run to
  // run. It resets the tile's counter for the next launch.
  __shared__ bool last;
  int* counter = reinterpret_cast<int*>(partial + static_cast<size_t>(splits) * T * Out) +
                 blockIdx.x * gridDim.y + blockIdx.y;
  __threadfence();  // this block's partials are visible before its arrival counts
  __syncthreads();
  if (tid == 0) last = atomicAdd(counter, 1) == splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + g + h * 8;
      const int col = n0 + wn * NT * 8 + nt * 8 + tig * 2;
      if (row >= T || col >= Out) continue;
      const size_t at = static_cast<size_t>(row) * Out + col;
      float2 sum = __ldcg(reinterpret_cast<const float2*>(partial + at));  // past L1
      for (int z = 1; z < splits; ++z) {
        const float2 p = __ldcg(reinterpret_cast<const float2*>(
            partial + static_cast<size_t>(z) * T * Out + at));
        sum.x += p.x;
        sum.y += p.y;
      }
      *reinterpret_cast<uint32_t*>(y + at) = pack_bf16(sum.x, sum.y);
    }
  if (tid == 0) *counter = 0;
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

// Above 48 KB a block's dynamic shared memory needs an opt-in, once per
// instance; a refusal is returned to the caller.
template <int BITS, int BN>
cudaError_t launch_m128(const void* x, const void* q, const void* scale, void* y, int T,
                        int In, int Out, int group, cudaStream_t stream) {
  constexpr int smem = StagedLayout<128, BITS, BN>::SMEM;
  static const cudaError_t prepared = cudaFuncSetAttribute(
      qmm_m128_kernel<BITS, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (prepared != cudaSuccess) return prepared;
  const dim3 grid((T + 127) / 128, (Out + BN - 1) / BN);
  qmm_m128_kernel<BITS, BN><<<grid, Staged<128>::THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q),
      static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(y), T, In, Out, group);
  return cudaGetLastError();
}

template <int BITS, int BN>
cudaError_t launch_m16(const void* x, const void* q, const void* scale, void* y, int T,
                       int In, int Out, int group, int splits, float* partial,
                       cudaStream_t stream) {
  constexpr int smem = StagedLayout<16, BITS, BN>::SMEM;
  static const cudaError_t prepared = cudaFuncSetAttribute(
      qmm_m16_kernel<BITS, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (prepared != cudaSuccess) return prepared;
  const dim3 grid((T + 15) / 16, (Out + BN - 1) / BN, splits);
  qmm_m16_kernel<BITS, BN><<<grid, Staged<16>::THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q),
      static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(y), T, In, Out, group,
      partial);
  return cudaGetLastError();
}

enum Instance { kF32 = 0, kM16 = 1, kM64 = 2, kM128 = 3, kR16 = 4 };

template <int BITS>
cudaError_t launch(const void* x, const void* q, const void* scale, void* y, int T, int In,
                   int Out, int group, int dtype, int instance, int block_n, int splits,
                   float* workspace, cudaStream_t stream) {
  if ((instance == kF32) != (dtype == 0) || dtype < 0 || dtype > 1)
    return cudaErrorInvalidValue;
  // Only m16 splits the contraction axis, into runs of whole stages, and
  // more than one split needs the workspace.
  if (splits < 1 || (splits > 1 && (instance != kM16 || workspace == nullptr ||
                                    splits > (In + kStageK - 1) / kStageK)))
    return cudaErrorInvalidValue;
  switch (instance) {
    case kF32: {
      const dim3 grid((Out + kF32BN - 1) / kF32BN, (T + kF32BM - 1) / kF32BM);
      qmm_f32_kernel<BITS><<<grid, kF32Threads, 0, stream>>>(
          static_cast<const float*>(x), static_cast<const int8_t*>(q),
          static_cast<const float*>(scale), static_cast<float*>(y), T, In, Out, group);
      return cudaGetLastError();
    }
    case kR16:
      return launch_bf16<BITS, 16, 64, 1, 4>(x, q, scale, y, T, In, Out, group, stream);
    case kM64:
      return launch_bf16<BITS, 64, 64, 2, 2>(x, q, scale, y, T, In, Out, group, stream);
    case kM16:
    case kM128:
      // The shapes the staged instances take: aligned 16-byte copies, and
      // int4 groups whose packed rows share a scale row (see the note at
      // the top).
      if (In % 8 != 0 || Out % 16 != 0 || (BITS == 4 && (group % 2 != 0 || group < 16)))
        return cudaErrorInvalidValue;
      if (instance == kM16) {
        if (block_n == 128)
          return launch_m16<BITS, 128>(x, q, scale, y, T, In, Out, group, splits, workspace,
                                       stream);
        if (block_n == 64)
          return launch_m16<BITS, 64>(x, q, scale, y, T, In, Out, group, splits, workspace,
                                      stream);
        return cudaErrorInvalidValue;
      }
      if (block_n == 128)
        return launch_m128<BITS, 128>(x, q, scale, y, T, In, Out, group, stream);
      if (block_n == 64)
        return launch_m128<BITS, 64>(x, q, scale, y, T, In, Out, group, stream);
      return cudaErrorInvalidValue;
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C interface, bound with ctypes. Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() (0 = launched). `bits` is 8
// or 4; `group` is the int4 scale group In / G (ignored for int8); `dtype`
// 0 = f32, 1 = bf16; `instance` one of Instance (f32 takes f32 x, the
// others bf16); `block_n` the staged instances' block columns, 128 or 64;
// `splits` the m16 instance's split of the contraction axis (1 for the
// others). With splits > 1, `workspace` holds splits * T * Out floats of
// partial sums, then one int counter per (16-row tile, column tile), zero
// before the call and zero again after it.
extern "C" int opsagent_quant_matmul(const void* x, const void* q, const void* scale,
                                     void* y, int T, int In, int Out, int bits, int group,
                                     int dtype, int instance, int block_n, int splits,
                                     void* workspace, void* stream) {
  if (T == 0 || Out == 0) return cudaSuccess;
  const auto s = static_cast<cudaStream_t>(stream);
  float* ws = static_cast<float*>(workspace);
  if (bits == 8)
    return launch<8>(x, q, scale, y, T, In, Out, group, dtype, instance, block_n, splits, ws, s);
  if (bits == 4 && In % 2 == 0 && group > 0 && In % group == 0)
    return launch<4>(x, q, scale, y, T, In, Out, group, dtype, instance, block_n, splits, ws, s);
  return cudaErrorInvalidValue;
}
