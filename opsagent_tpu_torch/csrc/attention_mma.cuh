// The tensor-core tile routine of the bf16 ragged paged-attention kernels
// (ragged_kernel in paged_attention.cu, ragged_split_kernel in
// paged_attention_grid.cu), for NVIDIA Hopper (sm_90a).
//
// `attend_mma` attends one (sequence, kv head, tile of 64 query rows) over
// the cache positions [t_begin, t_stop) that its rows can see. It computes
// the function of attend_split (same contract, same rows, same masks) in
// the shape of FlashAttention-2:
//
//   - Rows. Tile rows are (s, g) pairs of one kv head's group, r = s * G + g,
//     so any G works. Each of the 4 warps owns 16 rows, one m16 fragment;
//     per-row causal limits are a mask on the score fragment.
//   - Q is staged once through shared memory into bf16 A fragments
//     (ldmatrix). The D^-1/2 scale is applied to the f32 scores after the
//     product: rounding q * D^-1/2 to bf16 would add an error.
//   - S = Q K^T and O += P V run on tensor cores, mma.sync m16n8k16 with
//     bf16 inputs and an f32 accumulator, over chunks of 64 positions. K is
//     read with ldmatrix, V with ldmatrix.trans.
//   - The online softmax stays in f32 registers, per row: max and sum by
//     quad shuffles, in base 2 (scores prescaled by log2 e).
//   - P is split into two bf16 halves, hi = bf16(p) and lo = bf16(p - hi),
//     and both go through the P V product. One bf16 P (2^-9 relative)
//     moves an output near a bf16 rounding boundary by one ulp, 0.0156 at
//     |out| >= 2, past the 1e-2 bf16 tolerance; hi + lo keeps p to ~2^-18.
//   - Pages are gathered with 16-byte cp.async copies, double-buffered:
//     chunk i + 1 is in flight while chunk i is multiplied. Each position's
//     K/V row is looked up once, through the page table (slot read as
//     max(slot, 0)), two chunks ahead, into a small table in shared memory,
//     and the table read's latency hides behind a chunk's math (a lookup
//     per 16-byte copy costs a runtime division and a dependent table read
//     each, 16 times a row at D = 128).
//     Positions past the range are zero-filled, so every operand is finite
//     and a masked probability is exactly 0. Shared-memory rows are padded
//     by 16 bytes, so ldmatrix has no bank conflicts.
//   - int8 pages: the codes and their f32 scales are gathered with
//     cp.async into a two-stage staging buffer, then dequantized in shared
//     memory, code * scale of that (token, kv head) in f32 rounded to bf16,
//     as the plain version reads them (the code reaches f32 through a byte
//     permute, not the quarter-rate I2F). The mma operand therefore holds
//     the plain version's values (score-space scaling, as the TPU kernel
//     does, misses 1e-2 by one bf16 ulp: paged_attention.cu says why).
//   - Rows with nothing visible are written as exact zeros.
//
// f32 q keeps the CUDA-core bodies: the tensor cores have no f32 product
// that holds the f32 tolerance of 1e-5 (TF32 keeps ~3 digits), so the
// kernels pick this routine by q's dtype at compile time. It is the bf16
// design, not a fallback.
//
// What bounds it on the H100: the K/V rows each tile can see, read once
// per tile (2 * D * bytes per position), and at a long prefill chunk the
// tensor-core work, 4 * D operations per (query head, visible position),
// 6 * D with both halves of P. In practice the serial walk of the blocks
// that hold the longest row sets the time: ~2.6 us per 64-position chunk
// at D = 128, about half of it mma.sync issue and half the softmax, the
// barriers and the gather, with two blocks (8 warps) per SM at ~240
// registers a thread. A warpgroup (wgmma) form with TMA loads, a deeper
// ring and more rows per warp is the next step.

#pragma once

#include "attention_common.cuh"
#include "mma_ptx.cuh"

namespace attn {

using namespace ptx;

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = kMmaWarps * kWarp;
constexpr int kMmaRows = 16 * kMmaWarps;   // query rows per tile: one m16 fragment a warp
constexpr int kMmaChunk = 64;              // cache positions per pipeline stage
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Dynamic shared memory of one block: the K/V row index of each position
// of two chunks [2][chunk] int32; then for pages in q's dtype two stages of
// K and V chunks [chunk][D + 8] bf16; for int8 pages one bf16 K/V pair, two
// stages of K and V codes [chunk][D] and two stages of their f32 scales
// [chunk]. The q tile [64][D + 8] is staged in the second stage (int8: in
// the bf16 pair) before any chunk lands there.
static_assert(2 * kMmaChunk >= kMmaRows, "the q tile is staged in one K/V pair");
template <typename PT, int D>
constexpr int mma_smem_bytes() {
  constexpr int rows = 2 * kMmaChunk * 4;
  constexpr int pair = 2 * kMmaChunk * (D + 8) * 2;
  if constexpr (std::is_same_v<PT, int8_t>) {
    return rows + pair + 2 * 2 * kMmaChunk * D + 2 * 2 * kMmaChunk * 4;
  } else {
    return rows + 2 * pair;
  }
}

// (x, y) as hi = bf16 pair and lo = bf16 pair of the remainders.
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi, uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = pack_bf16(x - hf.x, y - hf.y);
}

// Gather ROWS K/V rows of the pages with THREADS threads, this one `idx`:
// rows[j] is row j's index in the [N * P * K] rows of the pages, -1 for a
// row past the range (zero-filled; nothing is read). 16-byte cp.async
// copies, not committed. Pages in bf16 land in ks / vs [ROWS][D + 8];
// int8 codes in kc / vc [ROWS][D] and their f32 scales in ksc / vsc
// [ROWS] (the other pointers are not read).
template <typename PT, int D, int ROWS, int THREADS>
__device__ __forceinline__ void gather_rows(
    const int* rows, const PT* __restrict__ k_pages, const PT* __restrict__ v_pages,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
    __nv_bfloat16* ks, __nv_bfloat16* vs, int8_t* kc, int8_t* vc, float* ksc, float* vsc,
    int idx) {
  constexpr int LD = D + 8;
  if constexpr (!std::is_same_v<PT, int8_t>) {
    constexpr int VPR = D / 8;                // 16-byte bf16 vectors per row
    constexpr int N = ROWS * VPR;
#pragma unroll
    for (int n = 0; n < (N + THREADS - 1) / THREADS; ++n) {
      const int i = idx + n * THREADS;
      if (N % THREADS != 0 && i >= N) break;
      const int j = i / VPR, c = (i % VPR) * 8;
      const int row = rows[j];
      const size_t at = static_cast<size_t>(max(row, 0)) * D + c;
      cp_async16(ks + j * LD + c, k_pages + at, row >= 0);
      cp_async16(vs + j * LD + c, v_pages + at, row >= 0);
    }
  } else {
    constexpr int CPR = D / 16;               // 16-byte code vectors per row
    constexpr int N = ROWS * CPR + ROWS;
#pragma unroll
    for (int n = 0; n < (N + THREADS - 1) / THREADS; ++n) {
      const int i = idx + n * THREADS;
      if (N % THREADS != 0 && i >= N) break;
      if (i < ROWS * CPR) {
        const int j = i / CPR, c = (i % CPR) * 16;
        const int row = rows[j];
        const size_t at = static_cast<size_t>(max(row, 0)) * D + c;
        cp_async16(kc + j * D + c, k_pages + at, row >= 0);
        cp_async16(vc + j * D + c, v_pages + at, row >= 0);
      } else {
        const int j = i - ROWS * CPR;
        const int row = rows[j];
        cp_async4(ksc + j, k_scale + max(row, 0), row >= 0);
        cp_async4(vsc + j, v_scale + max(row, 0), row >= 0);
      }
    }
  }
}

// Dequantize ROWS gathered int8 K/V rows (codes kc / vc [ROWS][D], scales
// ksc / vsc [ROWS]) into bf16 kb / vb [ROWS][D + 8] with THREADS threads,
// this one `idx`: code * scale in f32 rounded to bf16, as the plain
// version reads them (the code reaches f32 through a byte permute, not the
// quarter-rate I2F). The caller orders it after the gather and before the
// reads with its own barriers.
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void dequantize_rows(
    const int8_t* kc, const int8_t* vc, const float* ksc, const float* vsc,
    __nv_bfloat16* kb, __nv_bfloat16* vb, int idx) {
  constexpr int LD = D + 8;
  constexpr int VPR = D / 8;
  static_assert(ROWS * VPR % THREADS == 0, "every thread converts whole steps");
#pragma unroll
  for (int n = 0; n < ROWS * VPR / THREADS; ++n) {
    const int i = idx + n * THREADS;
    const int j = i / VPR, c = (i % VPR) * 8;
    const uint2 kr = *reinterpret_cast<const uint2*>(kc + j * D + c);
    const uint2 vr = *reinterpret_cast<const uint2*>(vc + j * D + c);
    const uint32_t kw[2] = {kr.x ^ 0x80808080u, kr.y ^ 0x80808080u};
    const uint32_t vw[2] = {vr.x ^ 0x80808080u, vr.y ^ 0x80808080u};
    const float kss = ksc[j], vss = vsc[j];
    uint4 ko, vo;
    uint32_t* kp = reinterpret_cast<uint32_t*>(&ko);
    uint32_t* vp = reinterpret_cast<uint32_t*>(&vo);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      kp[e] = pack_bf16(code_f32(kw[e / 2], 2 * (e % 2)) * kss,
                        code_f32(kw[e / 2], 2 * (e % 2) + 1) * kss);
      vp[e] = pack_bf16(code_f32(vw[e / 2], 2 * (e % 2)) * vss,
                        code_f32(vw[e / 2], 2 * (e % 2) + 1) * vss);
    }
    *reinterpret_cast<uint4*>(kb + j * LD + c) = ko;
    *reinterpret_cast<uint4*>(vb + j * LD + c) = vo;
  }
}

// Where a tile's rows go, each at its offset s * H + h inside the
// sequence: normalised into `out` (bf16 [S, H, D]) when it is not null,
// else as unnormalised partials, max and sum at ml[2 * row] and
// ml[2 * row + 1] (the max in natural-log units), accumulator at
// acc[row * D ...].
struct TileOut {
  __nv_bfloat16* out;
  float* ml;
  float* acc;
};

// One block of kMmaThreads threads: sequence rows `q` [S, H, D] (this
// sequence only), kv head `kh`, query rows [tile * 64, tile * 64 + 64) of
// the (s, g) enumeration, cache positions [t_begin, t_stop) clamped to what
// the tile can see. Pages hold PT: bf16, or int8 with scale planes k_scale
// / v_scale [N, P, K].
template <typename PT, int D>
__device__ __forceinline__ void attend_mma(
    const __nv_bfloat16* __restrict__ q, const PT* __restrict__ k_pages,
    const PT* __restrict__ v_pages, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ table_row,
    const TileOut& dst, int S, int H, int K, int P, int max_pages, int kh, int tile,
    int start, int qlen, int t_begin, int t_stop, float scale) {
  constexpr bool kInt8 = std::is_same_v<PT, int8_t>;
  constexpr int LD = D + 8;                 // padded bf16 row of every smem tile
  constexpr int NT = kMmaChunk / 8;         // 8-column tiles of a score fragment
  constexpr int KQ = D / 16;                // k-steps of Q K^T
  constexpr int DT = D / 8;                 // 8-column tiles of the output
  constexpr int VPR = D / 8;                // 16-byte bf16 vectors per row
  using bf16 = __nv_bfloat16;

  const int G = H / K;
  const int tid = threadIdx.x;
  const int lane = tid % kWarp;
  const int warp = tid / kWarp;
  const int row0 = tile * kMmaRows;
  // Positions the tile can see: up to its last valid row's window.
  const int s_first = row0 / G;
  const int s_last = min(min((row0 + kMmaRows - 1) / G, S - 1), qlen - 1);
  const int tile_limit = s_first <= s_last ? min(start + s_last + 1, max_pages * P) : 0;
  const int t_end = min(t_stop, tile_limit);

  // This thread's two rows of every fragment: lane / 4 and lane / 4 + 8 of
  // its warp's 16. Each sees positions < lim; orow < 0 marks padding.
  int lim[2], orow[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int gr = row0 + warp * 16 + lane / 4 + 8 * i;
    const int s = gr / G, g = gr % G;
    orow[i] = s < S ? s * H + kh * G + g : -1;
    lim[i] = (s < S && s < qlen) ? min(start + s + 1, t_end) : 0;
  }

  if (t_begin >= t_end) {
    // Nothing of the range is visible to the tile: a normalised output is
    // zeros; partials are not read.
    if (dst.out != nullptr) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (orow[i] < 0) continue;
#pragma unroll
        for (int dt = 0; dt < DT; ++dt) {
          *reinterpret_cast<uint32_t*>(dst.out + static_cast<size_t>(orow[i]) * D + dt * 8 +
                                       2 * (lane & 3)) = 0u;
        }
      }
    }
    return;
  }

  extern __shared__ __align__(16) unsigned char mma_smem[];
  int* rows_s = reinterpret_cast<int*>(mma_smem);
  bf16* kv_s = reinterpret_cast<bf16*>(rows_s + 2 * kMmaChunk);
  int8_t* codes = reinterpret_cast<int8_t*>(kv_s + 2 * kMmaChunk * LD);
  float* scales = reinterpret_cast<float*>(codes + 2 * 2 * kMmaChunk * D);
  bf16* q_s = kInt8 ? kv_s : kv_s + 2 * kMmaChunk * LD;

  // The row of position t's K/V in the [N * P * K] rows of the pages, from
  // its page-table slot (read as max(slot, 0)); -1 past the range (its
  // copy is zero-filled).
  auto slot_of = [&](int t) { return t < t_end ? __ldg(table_row + t / P) : 0; };
  auto row_of = [&](int t, int slot) {
    return t < t_end ? (max(slot, 0) * P + t % P) * K + kh : -1;
  };
  // Rows of the chunks at t_begin (slot 0) and the next (slot 1); later
  // chunks' rows are looked up two chunks ahead, inside the loop.
  static_assert(kMmaChunk <= kMmaThreads, "one thread looks up each position's row");
  for (int i = tid; i < 2 * kMmaChunk; i += kMmaThreads) {
    rows_s[i] = row_of(t_begin + i, slot_of(t_begin + i));
  }
  for (int i = tid; i < kMmaRows * VPR; i += kMmaThreads) {
    const int r = i / VPR, c = (i % VPR) * 8;
    const int gr = row0 + r, s = gr / G, g = gr % G;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (s < S) {
      v = __ldg(reinterpret_cast<const uint4*>(q + (static_cast<size_t>(s) * H + kh * G + g) * D + c));
    }
    *reinterpret_cast<uint4*>(q_s + r * LD + c) = v;
  }
  __syncthreads();  // rows and q tile written

  // Gather the chunk whose rows are in rows_s slot `stage` into `stage`.
  auto issue = [&](int stage) {
    bf16* ks = kv_s + stage * 2 * kMmaChunk * LD;
    int8_t* kc = codes + stage * 2 * kMmaChunk * D;
    float* ksc = scales + stage * 2 * kMmaChunk;
    gather_rows<PT, D, kMmaChunk, kMmaThreads>(
        rows_s + stage * kMmaChunk, k_pages, v_pages, k_scale, v_scale, ks,
        ks + kMmaChunk * LD, kc, kc + kMmaChunk * D, ksc, ksc + kMmaChunk, tid);
    cp_async_commit();
  };

  const int chunks = (t_end - t_begin + kMmaChunk - 1) / kMmaChunk;
  issue(0);  // stage 0 does not hold the q tile
  uint32_t qa[KQ][4];
#pragma unroll
  for (int kq = 0; kq < KQ; ++kq) {
    ldmatrix_x4(qa[kq], q_s + (warp * 16 + (lane & 15)) * LD + kq * 16 + (lane >> 4) * 8);
  }
  __syncthreads();  // q tile read: its buffer takes chunks from here on
  // The warp's rows see nothing at or past warp_lim: it skips those chunks.
  const int warp_lim = __reduce_max_sync(kFull, max(lim[0], lim[1]));

  float o[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};   // running max, base-2 units
  float l[2] = {0.f, 0.f};                       // this thread's share of the sum
  const float sl = scale * kLog2e;

  for (int ci = 0; ci < chunks; ++ci) {
    const int c0 = t_begin + ci * kMmaChunk;
    // The page-table slot of chunk ci + 2's position tid, read now and
    // turned into its row after this chunk's math, so the read's latency
    // hides behind it.
    const int t_ahead = c0 + 2 * kMmaChunk + tid;
    const bool ahead = ci + 2 < chunks && tid < kMmaChunk;
    const int slot_ahead = ahead ? slot_of(t_ahead) : 0;
    if (ci + 1 < chunks) {
      issue((ci + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // chunk ci landed for every thread

    const bf16* ks;
    const bf16* vs;
    if constexpr (kInt8) {
      // Dequantize the chunk's codes into the bf16 K/V pair.
      const int8_t* kc = codes + (ci & 1) * 2 * kMmaChunk * D;
      const int8_t* vc = kc + kMmaChunk * D;
      const float* ksc = scales + (ci & 1) * 2 * kMmaChunk;
      const float* vsc = ksc + kMmaChunk;
      bf16* kb = kv_s;
      bf16* vb = kv_s + kMmaChunk * LD;
      dequantize_rows<D, kMmaChunk, kMmaThreads>(kc, vc, ksc, vsc, kb, vb, tid);
      __syncthreads();
      ks = kb;
      vs = vb;
    } else {
      ks = kv_s + (ci & 1) * 2 * kMmaChunk * LD;
      vs = ks + kMmaChunk * LD;
    }

    if (c0 < warp_lim) {  // warp-uniform
      // S = Q K^T: sc[nt] holds columns nt * 8 .. nt * 8 + 7 of the chunk.
      float sc[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
#pragma unroll
      for (int kq = 0; kq < KQ; ++kq) {
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t b[4];
          ldmatrix_x4(b, ks + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * LD + kq * 16 +
                             ((lane >> 3) & 1) * 8);
          mma_bf16(sc[2 * np], qa[kq], b[0], b[1]);
          mma_bf16(sc[2 * np + 1], qa[kq], b[2], b[3]);
        }
      }

      // Mask, scale, and the online softmax of the thread's two rows.
      float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
      if (c0 + kMmaChunk <= min(lim[0], lim[1])) {  // both rows see the whole chunk
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            sc[nt][e] *= sl;
            mx[e >> 1] = fmaxf(mx[e >> 1], sc[nt][e]);
          }
        }
      } else {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int t = c0 + nt * 8 + 2 * (lane & 3) + (e & 1);
            const float v = t < lim[e >> 1] ? sc[nt][e] * sl : -CUDART_INF_F;
            sc[nt][e] = v;
            mx[e >> 1] = fmaxf(mx[e >> 1], v);
          }
        }
      }
      float alpha[2], base[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 2));
        const float m_new = fmaxf(m[i], mx[i]);
        base[i] = m_new == -CUDART_INF_F ? 0.f : m_new;   // the row has seen nothing yet
        alpha[i] = exp2f(m[i] - base[i]);
        m[i] = m_new;
        l[i] *= alpha[i];
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(sc[nt][e] - base[e >> 1]);
          sc[nt][e] = p;
          l[e >> 1] += p;
        }
      }
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        o[dt][0] *= alpha[0];
        o[dt][1] *= alpha[0];
        o[dt][2] *= alpha[1];
        o[dt][3] *= alpha[1];
      }

      // O += P V, P as hi + lo bf16 A fragments, 16 positions a k-step.
#pragma unroll
      for (int kc = 0; kc < NT / 2; ++kc) {
        uint32_t ph[4], pl[4];
        split_bf16(sc[2 * kc][0], sc[2 * kc][1], ph[0], pl[0]);
        split_bf16(sc[2 * kc][2], sc[2 * kc][3], ph[1], pl[1]);
        split_bf16(sc[2 * kc + 1][0], sc[2 * kc + 1][1], ph[2], pl[2]);
        split_bf16(sc[2 * kc + 1][2], sc[2 * kc + 1][3], ph[3], pl[3]);
#pragma unroll
        for (int dp = 0; dp < DT / 2; ++dp) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, vs + (kc * 16 + (lane & 15)) * LD + dp * 16 + (lane >> 4) * 8);
          mma_bf16(o[2 * dp], ph, b[0], b[1]);
          mma_bf16(o[2 * dp + 1], ph, b[2], b[3]);
          mma_bf16(o[2 * dp], pl, b[0], b[1]);
          mma_bf16(o[2 * dp + 1], pl, b[2], b[3]);
        }
      }
    }
    // Chunk ci's row slot was last read by its gather, before the previous
    // barrier; chunk ci + 2's gather reads it after the next.
    if (ahead) rows_s[(ci & 1) * kMmaChunk + tid] = row_of(t_ahead, slot_ahead);
    __syncthreads();  // chunk ci consumed before its stage is refilled
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(kFull, l[i], 1);
    l[i] += __shfl_xor_sync(kFull, l[i], 2);
    if (orow[i] < 0) continue;
    const size_t at = static_cast<size_t>(orow[i]) * D + 2 * (lane & 3);
    if (dst.out != nullptr) {
      const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        *reinterpret_cast<uint32_t*>(dst.out + at + dt * 8) =
            l[i] > 0.f ? pack_bf16(o[dt][2 * i] * inv, o[dt][2 * i + 1] * inv) : 0u;
      }
    } else {
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        *reinterpret_cast<float2*>(dst.acc + at + dt * 8) = make_float2(o[dt][2 * i], o[dt][2 * i + 1]);
      }
      if ((lane & 3) == 0) {
        dst.ml[2 * orow[i]] = m[i] * kLn2;
        dst.ml[2 * orow[i] + 1] = l[i];
      }
    }
  }
}

}  // namespace attn
