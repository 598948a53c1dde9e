// The MLA latent instances of the dma paged-attention kernels (the
// *_latent entry points of paged_attention.cu), for NVIDIA Hopper (sm_90a).
//
// Multi-head latent attention (DeepSeek-V2/V3) caches one latent per token,
// [kv_lora_rank 512 | rope key 64] = 576 columns, and attends in the
// weight-absorbed form: every query head dots its 576-column latent query
// with the token's latent, and averages the latents themselves. So the
// function is the paged attention of attend_split at K = 1, D = 576, with
// the one page array read as both keys and values (the JAX model passes
// `kc, kc` to paged_ragged_attention and paged_decode_attention), scale
// D^-1/2, all 576 output columns written, and rows with no visible position
// written as zeros.
//
// Why not an instance of attend_mma / attend_decode at D = 576: those keep
// a query tile's whole output row in registers, D / 8 = 72 n8 tiles a warp,
// 288 f32 accumulators a thread, which spills. Here the four warps of a
// block share a 16-row tile and split the work by phase:
//
//   - A stage is C cache positions (64 for bf16, 32 for f32). Each
//     position's latent row is looked up through the page table (slot read
//     as max(slot, 0)) and gathered once into shared memory ([C][576], rows
//     padded by 16 bytes so ldmatrix has no bank conflicts); it serves as
//     both K and V. Positions past the range are zero-filled.
//   - Scores. bf16: warp w computes S = Q L^T for positions [16w, 16w + 16)
//     of the stage on mma.sync m16n8k16 (36 k-steps x 2 n8 tiles), q from
//     shared memory through ldmatrix. f32: on CUDA cores, lane j takes
//     position j against four rows a warp. D^-1/2 is applied to the f32
//     scores, which go to shared memory masked per row (-inf past the
//     row's limit).
//   - The online softmax of each row in f32, base 2, by eight threads a
//     row over the stage's scores: running max and sum in shared memory, a
//     row that has seen nothing keeps max -inf and probabilities 0.
//   - O += P L. bf16: warp w owns output columns [144w, 144w + 144), 18 n8
//     tiles = 72 f32 accumulators a thread; P as hi + lo bf16 halves
//     (attention_mma.cuh says why), both from shared memory through
//     ldmatrix, L through ldmatrix.trans. f32: thread i owns columns i,
//     i + 128, ... for all 16 rows.
//   - Output: with `out`, the normalised rows in q's dtype (zeros where the
//     sum is 0); otherwise unnormalised partials (max in natural-log units,
//     sum, accumulator) in the layout combine_kernel reads.
//
// The ragged kernel gives one block to each (sequence, tile of 16 (s, h)
// rows) and walks the tile's whole visible range, as the dma ragged kernel
// does; the decode kernel gives one to each (sequence, split, tile of 16
// heads), splits chosen by the host as for the other decode instances,
// and reduces the splits with combine_kernel<T, 576>.
//
// What bounds it on the H100: the latent rows, 576 * bytes per position,
// read once per tile that sees them (the bound counts them once, k and v
// being one array); the products, 4 * 576 operations per (row, position).
// This design is made to be right, not fast: the gather is synchronous
// with the math (no cp.async ring), and every stage takes three block
// barriers.

#pragma once

#include "attention_split.cuh"

namespace attn {

constexpr int kLatentDim = 576;
constexpr int kLatentRows = 16;               // query rows of a tile
constexpr int kLatentLD = kLatentDim + 8;     // padded bf16 row in shared memory

template <typename T>
__host__ __device__ constexpr int latent_chunk() {
  return std::is_same_v<T, __nv_bfloat16> ? 64 : 32;
}

// Dynamic shared memory of one block. bf16: latents [C][LD] bf16, q
// [16][LD] bf16, scores [16][C] f32, P hi and lo [2][16][C + 8] bf16. f32:
// latents [C][D + 1] f32, q [16][D] f32, scores and then P [16][C] f32.
// Both then the rows of the stage [C] int32 and the rows' max, sum and
// rescale [3][16] f32.
template <typename T>
__host__ __device__ constexpr int latent_smem_bytes() {
  constexpr int C = latent_chunk<T>();
  constexpr int D = kLatentDim, R = kLatentRows;
  constexpr int tail = C * 4 + 3 * R * 4;
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    return C * kLatentLD * 2 + R * kLatentLD * 2 + R * C * 4 + 2 * R * (C + 8) * 2 + tail;
  } else {
    return C * (D + 1) * 4 + R * D * 4 + R * C * 4 + tail;
  }
}

// One block of kThreads threads over a tile of up to 16 query rows: row r
// is q[(row0 + r) * D ...] of this sequence's rows `q`, real for r < rows,
// and sees the positions t in [t_begin, min(lim_s[r], t_end)) (lim_s in
// shared memory, written before the call). Normalised rows go to
// out[(row0 + r) * D ...] when `out` is not null; otherwise partials at
// workspace row split * part.rows + row_base + row0 + r.
template <typename T>
__device__ __forceinline__ void attend_latent(
    const T* __restrict__ q, const T* __restrict__ pages, const int* __restrict__ table_row,
    int P, int row0, int rows, const int* lim_s, int t_begin, int t_end, T* __restrict__ out,
    const Partials& part, int split, int row_base, float scale) {
  constexpr bool kBf16 = std::is_same_v<T, __nv_bfloat16>;
  constexpr int D = kLatentDim, R = kLatentRows, C = latent_chunk<T>();
  constexpr int LD = kLatentLD;
  constexpr int LDP = C + 8;                      // padded bf16 row of P
  constexpr int COLS = D / kWarps;                // bf16: a warp's output columns
  constexpr int CT = COLS / 8;                    // ... in n8 tiles
  constexpr int CPT = (D + kThreads - 1) / kThreads;  // f32: a thread's columns
  using bf16 = __nv_bfloat16;
  static_assert(kThreads == R * 8, "eight threads a row in the softmax");
  static_assert(!kBf16 || C == 16 * kWarps, "bf16: one 16-position slice a warp");
  static_assert(kBf16 || C == kWarp, "f32: one position a lane");

  const int tid = threadIdx.x;
  const int lane = tid % kWarp;
  const int warp = tid / kWarp;

  if (t_begin >= t_end) {
    // Nothing of the range is visible: a normalised output is zeros;
    // partials are not read.
    if (out != nullptr) {
      for (int i = tid; i < rows * D; i += kThreads) store(out + static_cast<size_t>(row0) * D + i, 0.f);
    }
    return;
  }

  extern __shared__ __align__(16) unsigned char latent_smem[];
  // bf16 layout
  bf16* lat_h = reinterpret_cast<bf16*>(latent_smem);
  bf16* q_h = lat_h + C * LD;
  float* s_h = reinterpret_cast<float*>(q_h + R * LD);
  bf16* p_hi = reinterpret_cast<bf16*>(s_h + R * C);
  bf16* p_lo = p_hi + R * LDP;
  // f32 layout
  float* lat_f = reinterpret_cast<float*>(latent_smem);
  float* q_f = lat_f + C * (D + 1);
  float* s_f = q_f + R * D;
  unsigned char* tail = kBf16 ? reinterpret_cast<unsigned char*>(p_lo + R * LDP)
                              : reinterpret_cast<unsigned char*>(s_f + R * C);
  int* rows_s = reinterpret_cast<int*>(tail);
  float* m_s = reinterpret_cast<float*>(rows_s + C);
  float* l_s = m_s + R;
  float* a_s = l_s + R;
  float* s_s = kBf16 ? s_h : s_f;

  // The q tile, rows past `rows` zero.
  const T* q0 = q + static_cast<size_t>(row0) * D;
  if constexpr (kBf16) {
    for (int i = tid; i < R * (D / 8); i += kThreads) {
      const int r = i / (D / 8), c = (i % (D / 8)) * 8;
      cp_async16(q_h + r * LD + c, q0 + static_cast<size_t>(min(r, rows - 1)) * D + c, r < rows);
    }
    cp_async_commit();
  } else {
    for (int i = tid; i < R * (D / 4); i += kThreads) {
      const int r = i / (D / 4), c = (i % (D / 4)) * 4;
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (r < rows) load_vec<float, 4>(q0 + static_cast<size_t>(r) * D + c, v);
#pragma unroll
      for (int e = 0; e < 4; ++e) q_f[r * D + c + e] = v[e];
    }
  }
  if (tid < R) {
    m_s[tid] = -CUDART_INF_F;
    l_s[tid] = 0.f;
  }
  const float sl = scale * kLog2e;

  float o[kBf16 ? CT : 1][4];       // bf16: the warp's columns of the m16 tile
  float acc[kBf16 ? 1 : R][CPT];    // f32: the thread's columns of every row
  if constexpr (kBf16) {
#pragma unroll
    for (int ct = 0; ct < CT; ++ct) o[ct][0] = o[ct][1] = o[ct][2] = o[ct][3] = 0.f;
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int i = 0; i < CPT; ++i) acc[r][i] = 0.f;
    }
  }

  for (int c0 = t_begin; c0 < t_end; c0 += C) {
    __syncthreads();  // the previous stage's latents and P consumed
    if (tid < C) {
      const int t = c0 + tid;
      rows_s[tid] = t < t_end ? max(__ldg(table_row + t / P), 0) * P + t % P : -1;
    }
    __syncthreads();
    // The stage's latent rows, once: they are both K and V.
    if constexpr (kBf16) {
      for (int i = tid; i < C * (D / 8); i += kThreads) {
        const int j = i / (D / 8), c = (i % (D / 8)) * 8;
        const int row = rows_s[j];
        cp_async16(lat_h + j * LD + c, pages + static_cast<size_t>(max(row, 0)) * D + c, row >= 0);
      }
      cp_async_commit();
      cp_async_wait<0>();
    } else {
      for (int i = tid; i < C * (D / 4); i += kThreads) {
        const int j = i / (D / 4), c = (i % (D / 4)) * 4;
        const int row = rows_s[j];
        float v[4] = {0.f, 0.f, 0.f, 0.f};
        if (row >= 0) load_vec<float, 4>(pages + static_cast<size_t>(row) * D + c, v);
#pragma unroll
        for (int e = 0; e < 4; ++e) lat_f[j * (D + 1) + c + e] = v[e];
      }
    }
    __syncthreads();

    // Scores, masked per row, in base-2 units.
    if constexpr (kBf16) {
      float sc[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
      const bf16* ks = lat_h + warp * 16 * LD;
#pragma unroll 4
      for (int kq = 0; kq < D / 16; ++kq) {
        uint32_t a[4], b[4];
        ldmatrix_x4(a, q_h + (lane & 15) * LD + kq * 16 + (lane >> 4) * 8);
        ldmatrix_x4(b, ks + ((lane >> 4) * 8 + (lane & 7)) * LD + kq * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(sc[0], a, b[0], b[1]);
        mma_bf16(sc[1], a, b[2], b[3]);
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = lane / 4 + 8 * (e >> 1);
          const int j = warp * 16 + nt * 8 + 2 * (lane & 3) + (e & 1);
          const int t = c0 + j;
          s_s[r * C + j] = t < min(lim_s[r], t_end) ? sc[nt][e] * sl : -CUDART_INF_F;
        }
      }
    } else {
      const int t = c0 + lane;
      const float* kr = lat_f + lane * (D + 1);
#pragma unroll
      for (int rr = 0; rr < R / kWarps; ++rr) {
        const int r = warp * (R / kWarps) + rr;
        const float* qr = q_f + r * D;
        float dot = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) dot += qr[d] * kr[d];
        s_s[r * C + lane] = t < min(lim_s[r], t_end) ? dot * sl : -CUDART_INF_F;
      }
    }
    __syncthreads();

    // Online softmax: eight threads a row, C / 8 positions each.
    {
      constexpr int PER = C / 8;
      const int r = tid / 8, sub = tid % 8;
      float v[PER];
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int e = 0; e < PER; ++e) {
        v[e] = s_s[r * C + sub * PER + e];
        mx = fmaxf(mx, v[e]);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      const bool none = m_new == -CUDART_INF_F;   // the row has seen nothing yet
      const float alpha = none ? 1.f : exp2f(m_old - m_new);
      float sum = 0.f;
#pragma unroll
      for (int e = 0; e < PER; ++e) {
        v[e] = none ? 0.f : exp2f(v[e] - m_new);
        sum += v[e];
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) sum += __shfl_xor_sync(kFull, sum, off);
      if constexpr (kBf16) {
#pragma unroll
        for (int e = 0; e < PER; e += 2) {
          uint32_t hi, lo;
          split_bf16(v[e], v[e + 1], hi, lo);
          *reinterpret_cast<uint32_t*>(p_hi + r * LDP + sub * PER + e) = hi;
          *reinterpret_cast<uint32_t*>(p_lo + r * LDP + sub * PER + e) = lo;
        }
      } else {
#pragma unroll
        for (int e = 0; e < PER; ++e) s_s[r * C + sub * PER + e] = v[e];
      }
      if (sub == 0) {   // after the shuffles: every lane of the row has read m_s[r]
        m_s[r] = m_new;
        l_s[r] = l_s[r] * alpha + sum;
        a_s[r] = alpha;
      }
    }
    __syncthreads();

    // O = O * alpha + P L.
    if constexpr (kBf16) {
      const float al0 = a_s[lane / 4], al1 = a_s[lane / 4 + 8];
#pragma unroll
      for (int ct = 0; ct < CT; ++ct) {
        o[ct][0] *= al0;
        o[ct][1] *= al0;
        o[ct][2] *= al1;
        o[ct][3] *= al1;
      }
      const bf16* vs = lat_h + warp * COLS;
#pragma unroll
      for (int kc = 0; kc < C / 16; ++kc) {
        uint32_t ph[4], pl[4];
        ldmatrix_x4(ph, p_hi + (lane & 15) * LDP + kc * 16 + (lane >> 4) * 8);
        ldmatrix_x4(pl, p_lo + (lane & 15) * LDP + kc * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int dp = 0; dp < CT / 2; ++dp) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, vs + (kc * 16 + (lane & 15)) * LD + dp * 16 + (lane >> 4) * 8);
          mma_bf16(o[2 * dp], ph, b[0], b[1]);
          mma_bf16(o[2 * dp + 1], ph, b[2], b[3]);
          mma_bf16(o[2 * dp], pl, b[0], b[1]);
          mma_bf16(o[2 * dp + 1], pl, b[2], b[3]);
        }
      }
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float al = a_s[r];
#pragma unroll
        for (int i = 0; i < CPT; ++i) acc[r][i] *= al;
      }
      for (int j = 0; j < C; ++j) {
        const float* lr = lat_f + j * (D + 1);
#pragma unroll
        for (int i = 0; i < CPT; ++i) {
          const int c = tid + i * kThreads;
          if (c >= D) break;
          const float lv = lr[c];
#pragma unroll
          for (int r = 0; r < R; ++r) acc[r][i] += s_s[r * C + j] * lv;
        }
      }
    }
  }
  __syncthreads();  // the last stage's max and sum written

  // Output: normalised rows, or partials.
  if constexpr (kBf16) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = lane / 4 + 8 * i;
      if (r >= rows) continue;
      const float l = l_s[r];
      const size_t row = static_cast<size_t>(row0) + r;
      const size_t pr = static_cast<size_t>(split) * part.rows + row_base + row;
#pragma unroll
      for (int ct = 0; ct < CT; ++ct) {
        const int c = warp * COLS + ct * 8 + 2 * (lane & 3);
        const float x = o[ct][2 * i], y = o[ct][2 * i + 1];
        if (out != nullptr) {
          const float inv = l > 0.f ? 1.f / l : 0.f;
          *reinterpret_cast<uint32_t*>(out + row * D + c) = pack_bf16(x * inv, y * inv);
        } else {
          *reinterpret_cast<float2*>(part.acc + pr * D + c) = make_float2(x, y);
        }
      }
      if (out == nullptr && warp == 0 && (lane & 3) == 0) {
        part.ml[2 * pr] = m_s[r] * kLn2;
        part.ml[2 * pr + 1] = l;
      }
    }
  } else {
    for (int r = 0; r < rows; ++r) {
      const float l = l_s[r];
      const size_t row = static_cast<size_t>(row0) + r;
      const size_t pr = static_cast<size_t>(split) * part.rows + row_base + row;
#pragma unroll
      for (int i = 0; i < CPT; ++i) {
        const int c = tid + i * kThreads;
        if (c >= D) break;
        if (out != nullptr) {
          store(out + row * D + c, l > 0.f ? acc[r][i] / l : 0.f);
        } else {
          part.acc[pr * D + c] = acc[r][i];
        }
      }
      if (out == nullptr && tid == 0) {
        part.ml[2 * pr] = m_s[r] * kLn2;
        part.ml[2 * pr + 1] = l;
      }
    }
  }
}

// Ragged rows: one block per (tile of 16 (s, h) rows, sequence). With one
// kv head the (s, h) enumeration is the row index s * H + h itself. Query
// s sees t <= start + s and t < start + q_len, clamped to MaxP * P.
template <typename T>
__global__ void __launch_bounds__(kThreads) latent_ragged_kernel(
    const T* __restrict__ q, const T* __restrict__ pages, const int* __restrict__ table,
    const int* __restrict__ start, const int* __restrict__ q_lens, T* __restrict__ out, int S,
    int H, int P, int max_pages, float scale) {
  __shared__ int lim_s[kLatentRows];
  const int b = blockIdx.y;
  const int first = blockIdx.x * kLatentRows;
  const int rows = min(kLatentRows, S * H - first);
  const int cap = max_pages * P;
  const int st = start[b], ql = q_lens[b];
  if (threadIdx.x < kLatentRows) {
    const int s = (first + threadIdx.x) / H;
    lim_s[threadIdx.x] = (static_cast<int>(threadIdx.x) < rows && s < ql) ? min(st + s + 1, cap) : 0;
  }
  // The tile sees up to its last real, valid row's window.
  const int s_last = min((first + rows - 1) / H, ql - 1);
  const int t_end = s_last >= first / H ? min(st + s_last + 1, cap) : 0;
  __syncthreads();
  const size_t seq = static_cast<size_t>(b) * S * H * kLatentDim;
  attend_latent<T>(q + seq, pages, table + static_cast<size_t>(b) * max_pages, P, first, rows,
                   lim_s, 0, t_end, out + seq, Partials{nullptr, nullptr, 0, cap, 1}, 0, 0,
                   scale);
}

// Decode: one block per (tile of 16 heads, split, sequence); the query
// sees t < lengths[b], clamped to MaxP * P, of its split's positions.
template <typename T>
__global__ void __launch_bounds__(kThreads) latent_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ pages, const int* __restrict__ table,
    const int* __restrict__ lengths, Partials part, T* __restrict__ out, int H, int P,
    int max_pages, float scale) {
  __shared__ int lim_s[kLatentRows];
  const int b = blockIdx.z, split = blockIdx.y;
  const int first = blockIdx.x * kLatentRows;
  const int rows = min(kLatentRows, H - first);
  const int len = min(max(lengths[b], 0), max_pages * P);
  const int t_begin = split * part.span;
  const int t_end = min(t_begin + part.span, len);
  if (threadIdx.x < kLatentRows) lim_s[threadIdx.x] = t_end;
  __syncthreads();
  const size_t seq = static_cast<size_t>(b) * H;
  T* seq_out = part.splits == 1 ? out + seq * kLatentDim : nullptr;
  attend_latent<T>(q + seq * kLatentDim, pages, table + static_cast<size_t>(b) * max_pages, P,
                   first, rows, lim_s, t_begin, t_end, seq_out, part, split,
                   static_cast<int>(seq), scale);
}

}  // namespace attn
