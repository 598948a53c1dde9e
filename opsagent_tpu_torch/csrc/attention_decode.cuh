// The tensor-core decode routine of the bf16 paged decode kernels
// (decode_kernel in paged_attention.cu, decode_split_kernel in
// paged_attention_grid.cu), for NVIDIA Hopper (sm_90a).
//
// `attend_decode` attends the one query of a sequence, for the heads of one
// kv head's group, over the cache positions [t_begin, t_end) of one split
// of its KV sequence. It computes the function of attend_split at S = 1
// (same contract, same masks, same partials) in a shape made for a decode
// step, where a block has a handful of query rows and many positions:
//
//   - Rows. A block owns one (sequence, kv head, split) and up to 16 query
//     heads of the group (G = 4 and 7 served), held in one m16 fragment with
//     rows G..15 zero; G > 16 takes more tiles on blockIdx.x.
//   - Warps split the positions, not the rows. A stage is 64 positions;
//     warp w takes positions [16w, 16w + 16) of each stage, so all four
//     warps do tensor-core work (attend_mma at S = 1 would leave three of
//     its four warps without a visible row). Each warp computes S = Q K^T
//     on mma.sync m16n8k16 (D / 16 k-steps x 2 n8 tiles), masks positions
//     at or past t_end, runs the online softmax in f32 in base 2, and
//     O += P V with P as hi + lo bf16 halves (attention_mma.cuh says why)
//     and V through ldmatrix.trans. Each warp keeps its own m, l and
//     O [16 x D] in registers; at the end the four states are merged
//     through shared memory, rescaled to the largest max.
//   - Each warp runs its own pipeline and no block barrier is taken before
//     the merge. Its slices are gathered with 16-byte cp.async copies
//     (gather_rows, shared with attend_mma) into a ring of its own, in the
//     pages' storage dtype, 2 slices deep (17 KB a warp at D = 128 for
//     bf16 pages, three blocks an SM; 17 KB for int8, two blocks an SM by
//     registers): the next slice of every warp is in flight while one is
//     multiplied, and the SM's other blocks cover the rest. At the served
//     shapes (scripts/ab_attention.py) 3 or 4 slices were 0-10 % slower:
//     a live block walks at most 4 slices a warp, so occupancy counts for
//     more than depth.
//     Each position's row is looked up through the page table (slot read
//     as max(slot, 0)) once: the slot a slice ahead, into a register, then
//     the row into a 16-entry table of the warp in shared memory that the
//     gather reads. Positions past t_end are zero-filled, so every operand
//     is finite and a masked probability is exactly 0. Shared-memory rows
//     are padded by 16 bytes, so ldmatrix has no bank conflicts.
//   - int8 pages: codes and f32 scales are gathered by cp.async, then each
//     warp dequantizes its slice in shared memory to bf16 (dequantize_rows,
//     shared with attend_mma), code * scale in f32 rounded to bf16, as the
//     plain version reads them.
//   - Numerics. q is loaded unscaled into bf16 A fragments straight from
//     global memory (4 KB a warp, no barrier); D^-1/2 is applied to the
//     f32 scores, as in attend_mma.
//   - Materialized MLA's head dim 24 is padded to the k-step (32) with
//     zeros, as in attend_mma: q's pad registers are zero, and each warp
//     zeroes the pad columns of its ring's K slices once, which no copy
//     writes; P V keeps three n8 tiles.
//   - Output through TileOut: with one split the normalised bf16 rows,
//     otherwise unnormalised partials (max in natural-log units, sum, acc)
//     in the layout combine_kernel reads. A range with nothing visible
//     writes zeros (one split) or nothing (its partials are not read).
//
// What bounds it on the H100: the K/V rows of the split, read once,
// 2 * D * bytes per position (2 * (D + 4) for int8 pages), at 3.35 TB/s;
// the products (6 * D operations per padded row and position with both
// halves of P) are far below the tensor cores' rate. The host splits the
// sequence so that no block walks more than 256 positions
// (ops/paged_attention.py, DECODE_WALK): at a batch of 8 that is ~1000
// blocks, most of which exit at once on short rows.

#pragma once

#include "attention_mma.cuh"

namespace attn {

constexpr int kDecodeWarps = 4;
constexpr int kDecodeThreads = kDecodeWarps * kWarp;
constexpr int kDecodeRows = 16;                            // query heads of a tile
constexpr int kDecodeSlice = 16;                           // a warp's positions of a stage
constexpr int kDecodeStage = kDecodeWarps * kDecodeSlice;  // positions of a stage

constexpr int kDecodeRing = 2;                             // slices in a warp's cp.async ring

// Shared memory of one warp: the row index of each position of a slice
// [16] int32; then for bf16 pages the ring of K and V slices
// [16][mma_ld(D)] bf16; for int8 pages the ring of K and V codes [16][D],
// the ring of their f32 scales [16], and one bf16 K/V pair [16][mma_ld(D)].
// After the walk the same bytes hold the warp's state for the merge:
// m [16], l [16] and o [16][mma_ld(D)] f32.
template <typename PT, int D>
__host__ __device__ constexpr int decode_warp_bytes() {
  constexpr int rows = kDecodeSlice * 4;
  constexpr int pair = 2 * kDecodeSlice * mma_ld(D) * 2;
  if constexpr (std::is_same_v<PT, int8_t>) {
    return rows + kDecodeRing * 2 * kDecodeSlice * (D + 4) + pair;
  } else {
    return rows + kDecodeRing * pair;
  }
}

template <typename PT, int D>
constexpr int decode_smem_bytes() {
  static_assert(decode_warp_bytes<PT, D>() >= 4 * (2 * kDecodeRows + kDecodeRows * mma_ld(D)),
                "the merge state fits in a warp's ring");
  return kDecodeWarps * decode_warp_bytes<PT, D>();
}

// One block of kDecodeThreads threads: the sequence's query `q` [H, D],
// kv head `kh`, query heads [tile * 16, tile * 16 + 16) of its group,
// cache positions [t_begin, t_end) (t_end already clamped to the length and
// to MaxP * P). Pages hold PT: bf16, or int8 with scale planes k_scale /
// v_scale [N, P, K]. Rows go to `dst` at offset h = kh * G + g.
template <typename PT, int D>
__device__ __forceinline__ void attend_decode(
    const __nv_bfloat16* __restrict__ q, const PT* __restrict__ k_pages,
    const PT* __restrict__ v_pages, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ table_row,
    const TileOut& dst, int H, int K, int P, int kh, int tile, int t_begin, int t_end,
    float scale) {
  constexpr bool kInt8 = std::is_same_v<PT, int8_t>;
  constexpr int DK = mma_dk(D);             // contraction width, zero-padded
  constexpr int LD = mma_ld(D);             // padded bf16 row of every smem slice
  constexpr int KQ = DK / 16;               // k-steps of Q K^T
  constexpr int DT = D / 8;                 // 8-column tiles of the output
  constexpr int SLICE = kDecodeSlice * LD;  // bf16 elements of one K or V slice
  constexpr int CODES = kDecodeSlice * D;   // int8 codes of one K or V slice
  using bf16 = __nv_bfloat16;

  const int G = H / K;
  const int tid = threadIdx.x;
  const int lane = tid % kWarp;
  const int warp = tid / kWarp;
  const int g0 = tile * kDecodeRows;
  const int rows = min(kDecodeRows, G - g0);   // real rows of the tile
  const size_t head0 = static_cast<size_t>(kh) * G + g0;

  if (t_begin >= t_end) {
    // Nothing of the range is visible: a normalised output is zeros;
    // partials are not read.
    if (dst.out != nullptr) {
      for (int i = tid; i < rows * (D / 8); i += kDecodeThreads) {
        *reinterpret_cast<uint4*>(dst.out + (head0 + i / (D / 8)) * D + (i % (D / 8)) * 8) =
            make_uint4(0u, 0u, 0u, 0u);
      }
    }
    return;
  }

  extern __shared__ __align__(16) unsigned char decode_smem[];
  unsigned char* own = decode_smem + warp * decode_warp_bytes<PT, D>();
  int* rows_s = reinterpret_cast<int*>(own);
  bf16* ring_s = reinterpret_cast<bf16*>(own + kDecodeSlice * 4);   // bf16 pages
  int8_t* codes = reinterpret_cast<int8_t*>(own + kDecodeSlice * 4);    // int8 pages
  float* scales = reinterpret_cast<float*>(codes + kDecodeRing * 2 * CODES);
  bf16* pair = reinterpret_cast<bf16*>(scales + kDecodeRing * 2 * kDecodeSlice);

  // This thread's rows of every fragment: lane / 4 and lane / 4 + 8.
  // Rows past the group's heads are zero, and never written; so are the
  // pad columns at and past D.
  uint32_t qa[KQ][4];
  {
    const int r0 = lane / 4, c = 2 * (lane & 3);
    const bool live0 = r0 < rows, live1 = r0 + 8 < rows;
    const bf16* q0 = q + (head0 + (live0 ? r0 : 0)) * D + c;
    const bf16* q1 = q + (head0 + (live1 ? r0 + 8 : 0)) * D + c;
#pragma unroll
    for (int kq = 0; kq < KQ; ++kq) {
      const int k = kq * 16;
      const bool lo = k < D, hi = k + 8 < D;   // compile-time once unrolled
      qa[kq][0] = live0 && lo ? __ldg(reinterpret_cast<const unsigned*>(q0 + k)) : 0u;
      qa[kq][1] = live1 && lo ? __ldg(reinterpret_cast<const unsigned*>(q1 + k)) : 0u;
      qa[kq][2] = live0 && hi ? __ldg(reinterpret_cast<const unsigned*>(q0 + k + 8)) : 0u;
      qa[kq][3] = live1 && hi ? __ldg(reinterpret_cast<const unsigned*>(q1 + k + 8)) : 0u;
    }
  }

  // The warp's slices: slice j holds positions [c0(j), c0(j) + 16) with
  // c0(j) = t_begin + j * 64 + warp * 16; `slices` of them reach t_end.
  const int first = t_begin + warp * kDecodeSlice;
  const int slices = first < t_end ? (t_end - first + kDecodeStage - 1) / kDecodeStage : 0;
  const int pos = first + (lane & (kDecodeSlice - 1));   // this lane's position of slice 0
  auto slot_of = [&](int j) {
    const int t = pos + j * kDecodeStage;
    return t < t_end ? __ldg(table_row + t / P) : 0;
  };
  // Slice j's rows into rows_s (-1 past t_end: zero-filled), then its
  // gather into ring stage j % kDecodeRing. Warp-uniform.
  auto issue = [&](int j, int slot) {
    const int t = pos + j * kDecodeStage;
    __syncwarp();   // the previous gather has read rows_s
    if (lane < kDecodeSlice) rows_s[lane] = t < t_end ? (max(slot, 0) * P + t % P) * K + kh : -1;
    __syncwarp();
    const int s = j % kDecodeRing;
    bf16* ks = ring_s + s * 2 * SLICE;
    int8_t* kc = codes + s * 2 * CODES;
    float* ksc = scales + s * 2 * kDecodeSlice;
    gather_rows<PT, D, kDecodeSlice, kWarp>(rows_s, k_pages, v_pages, k_scale, v_scale, ks,
                                            ks + SLICE, kc, kc + CODES, ksc,
                                            ksc + kDecodeSlice, lane);
  };

  if constexpr (DK != D) {
    // The pad columns of the ring's K slices, read by Q K^T (ordered
    // before the reads by the walk's __syncwarp).
    static_assert(!kInt8, "int8 pages take head dims on the k-step");
    constexpr int PV = (DK - D) / 8;
    for (int i = lane; i < kDecodeRing * kDecodeSlice * PV; i += kWarp) {
      const int r = i / PV;   // stage r / kDecodeSlice, row r % kDecodeSlice
      *reinterpret_cast<uint4*>(ring_s + (r / kDecodeSlice) * 2 * SLICE +
                                (r % kDecodeSlice) * LD + D + (i % PV) * 8) =
          make_uint4(0u, 0u, 0u, 0u);
    }
  }

  // Prologue: the first kDecodeRing - 1 slices in flight, their slots read
  // together.
  int slots[kDecodeRing - 1];
#pragma unroll
  for (int j = 0; j < kDecodeRing - 1; ++j) slots[j] = j < slices ? slot_of(j) : 0;
#pragma unroll
  for (int j = 0; j < kDecodeRing - 1; ++j) {
    if (j < slices) issue(j, slots[j]);
    cp_async_commit();
  }
  int slot_next = kDecodeRing - 1 < slices ? slot_of(kDecodeRing - 1) : 0;

  float o[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};   // running max, base-2 units
  float l[2] = {0.f, 0.f};                       // this thread's share of the sum
  const float sl = scale * kLog2e;

  for (int j = 0; j < slices; ++j) {
    // Slice j + kDecodeRing - 1 into the stage that slice j - 1 left; the slot of
    // the slice after it is read now, its latency behind this slice's math.
    const int ahead = j + kDecodeRing - 1;
    if (ahead < slices) {
      issue(ahead, slot_next);
      slot_next = ahead + 1 < slices ? slot_of(ahead + 1) : 0;
    }
    cp_async_commit();
    cp_async_wait<kDecodeRing - 1>();
    __syncwarp();   // slice j landed for every lane

    const bf16* ks;
    const bf16* vs;
    if constexpr (kInt8) {
      const int8_t* kc = codes + (j % kDecodeRing) * 2 * CODES;
      const float* ksc = scales + (j % kDecodeRing) * 2 * kDecodeSlice;
      dequantize_rows<D, kDecodeSlice, kWarp>(kc, kc + CODES, ksc, ksc + kDecodeSlice, pair,
                                              pair + SLICE, lane);
      __syncwarp();
      ks = pair;
      vs = pair + SLICE;
    } else {
      ks = ring_s + (j % kDecodeRing) * 2 * SLICE;
      vs = ks + SLICE;
    }

    // S = Q K^T: sc[nt] holds positions nt * 8 .. nt * 8 + 7 of the slice.
    float sc[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
#pragma unroll
    for (int kq = 0; kq < KQ; ++kq) {
      uint32_t b[4];
      ldmatrix_x4(b, ks + ((lane >> 4) * 8 + (lane & 7)) * LD + kq * 16 + ((lane >> 3) & 1) * 8);
      mma_bf16(sc[0], qa[kq], b[0], b[1]);
      mma_bf16(sc[1], qa[kq], b[2], b[3]);
    }

    // Mask, scale, and the online softmax of the thread's two rows.
    const int c0 = first + j * kDecodeStage;
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = c0 + nt * 8 + 2 * (lane & 3) + (e & 1);
        const float v = t < t_end ? sc[nt][e] * sl : -CUDART_INF_F;
        sc[nt][e] = v;
        mx[e >> 1] = fmaxf(mx[e >> 1], v);
      }
    }
    float alpha[2], base[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);   // finite: position c0 < t_end
      base[i] = m_new;
      alpha[i] = exp2f(m[i] - base[i]);
      m[i] = m_new;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
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

    // O += P V, P as hi + lo bf16 A fragments over the slice's 16 positions.
    uint32_t ph[4], pl[4];
    split_bf16(sc[0][0], sc[0][1], ph[0], pl[0]);
    split_bf16(sc[0][2], sc[0][3], ph[1], pl[1]);
    split_bf16(sc[1][0], sc[1][1], ph[2], pl[2]);
    split_bf16(sc[1][2], sc[1][3], ph[3], pl[3]);
#pragma unroll
    for (int dp = 0; dp < DT / 2; ++dp) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, vs + (lane & 15) * LD + dp * 16 + (lane >> 4) * 8);
      mma_bf16(o[2 * dp], ph, b[0], b[1]);
      mma_bf16(o[2 * dp + 1], ph, b[2], b[3]);
      mma_bf16(o[2 * dp], pl, b[0], b[1]);
      mma_bf16(o[2 * dp + 1], pl, b[2], b[3]);
    }
    if constexpr (DT % 2) {  // the odd n8 tile (D = 24)
      uint32_t b[2];
      ldmatrix_x2_trans(b, vs + (lane & 15) * LD + (DT - 1) * 8);
      mma_bf16(o[DT - 1], ph, b[0], b[1]);
      mma_bf16(o[DT - 1], pl, b[0], b[1]);
    }
    __syncwarp();   // slice j read before its stage is refilled
  }

  // The warp's state into its own bytes (its ring is drained): m and l of
  // each row, then o [16][mma_ld(D)].
  cp_async_wait<0>();
  __syncwarp();
  float* m_s = reinterpret_cast<float*>(own);
  float* l_s = m_s + kDecodeRows;
  float* o_s = l_s + kDecodeRows;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(kFull, l[i], 1);
    l[i] += __shfl_xor_sync(kFull, l[i], 2);
    const int r = lane / 4 + 8 * i;
    if ((lane & 3) == 0) {
      m_s[r] = m[i];
      l_s[r] = l[i];
    }
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      *reinterpret_cast<float2*>(o_s + r * LD + dt * 8 + 2 * (lane & 3)) =
          make_float2(o[dt][2 * i], o[dt][2 * i + 1]);
    }
  }
  __syncthreads();  // every warp's state written

  // Merge: each (row, column pair) over the four warps, rescaled to the
  // largest max (finite: warp 0 saw position t_begin).
  for (int i = tid; i < rows * (D / 2); i += kDecodeThreads) {
    const int r = i / (D / 2), c = 2 * (i % (D / 2));
    float mw[kDecodeWarps];
    float mmax = -CUDART_INF_F;
#pragma unroll
    for (int w = 0; w < kDecodeWarps; ++w) {
      mw[w] = reinterpret_cast<const float*>(decode_smem + w * decode_warp_bytes<PT, D>())[r];
      mmax = fmaxf(mmax, mw[w]);
    }
    float sum = 0.f, o0 = 0.f, o1 = 0.f;
#pragma unroll
    for (int w = 0; w < kDecodeWarps; ++w) {
      const float* st = reinterpret_cast<const float*>(decode_smem + w * decode_warp_bytes<PT, D>());
      const float e = exp2f(mw[w] - mmax);   // 0 for a warp that saw nothing
      sum += st[kDecodeRows + r] * e;
      const float2 ov = *reinterpret_cast<const float2*>(st + 2 * kDecodeRows + r * LD + c);
      o0 += ov.x * e;
      o1 += ov.y * e;
    }
    const size_t h = head0 + r;
    if (dst.out != nullptr) {
      const float inv = 1.f / sum;
      *reinterpret_cast<uint32_t*>(dst.out + h * D + c) = pack_bf16(o0 * inv, o1 * inv);
    } else {
      *reinterpret_cast<float2*>(dst.acc + h * D + c) = make_float2(o0, o1);
      if (c == 0) {
        dst.ml[2 * h] = mmax * kLn2;
        dst.ml[2 * h + 1] = sum;
      }
    }
  }
}

}  // namespace attn
