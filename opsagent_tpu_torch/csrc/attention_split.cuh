// The split of the KV sequence that the paged-attention sources share
// (paged_attention.cu, paged_attention_grid.cu), for NVIDIA Hopper
// (sm_90a): the workspace of partials, the CUDA-core split body
// `attend_split` (f32 q), the decode split pass of both forms, and the
// combine pass that reduces the partials.
//
// A split is `span` consecutive cache positions, a whole number of pages;
// a block of a split pass owns (sequence, kv head, tile of query rows,
// split) and writes its rows' running max, sum and accumulator,
// unnormalised, to the workspace (with one split: the normalised rows, and
// no combine runs). The combine gives one warp to each (query row, head):
// it reads the partials of the splits that hold a position the row sees,
// rescales them to their largest max, normalises and writes q's dtype.
//
// `attend_split` walks the positions of its split that its rows can see,
// 32 at a time (one per lane), gathering each position's [D] row of its kv
// head through the page table into shared memory as f32 (int8 pages:
// code * scale in f32 rounded to q's dtype); each warp keeps RPW rows'
// running max, sum and [D] accumulator in registers. Its products run on
// CUDA cores in f32 with synchronous loads: the tensor cores hold no f32
// tolerance of 1e-5, and f32 is on no served path. It is the body of every
// f32 instance of both forms (the dma ragged kernel runs it over one split
// that spans the table). The bf16 instances run `attend_mma` (ragged) and
// `attend_decode` (decode).

#pragma once

#include "attention_decode.cuh"

namespace attn {

constexpr int kWarps = 4;                  // warps per block
constexpr int kThreads = kWarps * kWarp;
constexpr int kChunk = kWarp;              // cache positions per pass: one per lane

template <int D, int RPW>
constexpr int smem_bytes() {
  // q tile [R][D], K chunk [kChunk][D + 1] (padded: lane j reads row j),
  // V chunk [kChunk][D], all f32.
  return (kWarps * RPW * D + kChunk * (D + 1) + kChunk * D) * 4;
}

// The workspace of one call. Row r = (b * S + s) * H + h of split i keeps
// its running max and sum at ml[2 * (i * rows + r)] and [... + 1], and its
// unnormalised accumulator at acc[(i * rows + r) * D ...].
struct Partials {
  float* ml;
  float* acc;
  int rows;     // B * S * H
  int span;     // cache positions per split, a multiple of the page size
  int splits;
};

// Query heads of one decode tile, for both bodies: attend_decode's m16
// fragment, and 4 rows a warp in attend_split. ops/paged_attention.py
// mirrors it (GRID_TILE_ROWS["decode"]).
constexpr int kDecodeRowsPerWarp = kDecodeRows / kWarps;
static_assert(kDecodeThreads == kThreads, "both decode bodies run 4 warps");

// One block of the split pass: sequence rows `q` [S, H, D] (this sequence
// only, whose rows start at workspace row `row_base`), kv head `kh`, query
// rows [tile * R, tile * R + R) of the (s, g) enumeration r = s * G + g,
// cache positions [split * span, split * span + span). With one split
// (`out` not null: this sequence's output rows) it writes the normalised
// rows there instead of partials.
template <typename T, typename PT, int D, int RPW>
__device__ __forceinline__ void attend_split(
    const T* __restrict__ q, const PT* __restrict__ k_pages,
    const PT* __restrict__ v_pages, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ table_row,
    const Partials& part, T* __restrict__ out, int row_base, int S, int H, int K, int P,
    int max_pages, int kh, int tile, int split, int start, int qlen, float scale) {
  constexpr bool kInt8 = std::is_same_v<PT, int8_t>;
  constexpr int R = kWarps * RPW;
  constexpr int DPL = (D + kWarp - 1) / kWarp;   // output dims per lane
  constexpr int VEC = 16 / sizeof(T);
  constexpr int VPR = D / VEC;                   // 16-byte vectors per q row
  constexpr int PVEC = 16 / sizeof(PT);
  constexpr int PVPR = D / PVEC;                 // 16-byte vectors per page row

  const int G = H / K;
  const int cap = max_pages * P;
  const int row0 = tile * R;
  // Positions the tile can see: up to its last valid row's window.
  const int s_first = row0 / G;
  const int s_last = min(min((row0 + R - 1) / G, S - 1), qlen - 1);
  const int tile_limit = s_first <= s_last ? min(start + s_last + 1, cap) : 0;
  const int t_begin = split * part.span;
  const int t_end = min(t_begin + part.span, tile_limit);
  const int tid = threadIdx.x;
  const int lane = tid % kWarp;
  const int warp = tid / kWarp;
  // No position of this split is visible to the tile, so the combine reads
  // none of its partials; a normalised output is zeros.
  if (t_begin >= t_end) {
    if (out == nullptr) return;
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) {
      const int gr = row0 + warp * RPW + rr;
      const int s = gr / G, g = gr % G;
      if (s >= S) continue;
      T* o = out + (static_cast<size_t>(s) * H + kh * G + g) * D;
      for (int d = lane; d < D; d += kWarp) store(o + d, 0.f);
    }
    return;
  }

  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + R * D;
  float* v_s = k_s + kChunk * (D + 1);

  for (int i = tid; i < R * VPR; i += kThreads) {
    const int r = i / VPR, c = (i % VPR) * VEC;
    const int gr = row0 + r, s = gr / G, g = gr % G;
    float vals[VEC];
    if (s < S) {
      load_vec<T, VEC>(q + (static_cast<size_t>(s) * H + kh * G + g) * D + c, vals);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) vals[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) q_s[r * D + c + e] = vals[e] * scale;
  }

  float m[RPW], l[RPW], acc[RPW][DPL];
  int lim[RPW];   // each row sees positions < lim[rr] of this split
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    const int s = (row0 + warp * RPW + rr) / G;
    lim[rr] = (s < S && s < qlen) ? min(start + s + 1, t_end) : 0;
    m[rr] = -CUDART_INF_F;
    l[rr] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[rr][i] = 0.f;
  }

  for (int c0 = t_begin; c0 < t_end; c0 += kChunk) {
    __syncthreads();  // q tile written / previous chunk consumed
    for (int i = tid; i < kChunk * PVPR; i += kThreads) {
      const int j = i / PVPR, c = (i % PVPR) * PVEC;
      const int t = c0 + j;
      float kv[PVEC], vv[PVEC];
      if (t < t_end) {
        const int page = max(table_row[t / P], 0);
        const size_t row = (static_cast<size_t>(page) * P + t % P) * K + kh;
        load_vec<PT, PVEC>(k_pages + row * D + c, kv);
        load_vec<PT, PVEC>(v_pages + row * D + c, vv);
        if constexpr (kInt8) {
          const float ks = __ldg(k_scale + row), vs = __ldg(v_scale + row);
#pragma unroll
          for (int e = 0; e < PVEC; ++e) {
            kv[e] = round_as(kv[e] * ks, q);
            vv[e] = round_as(vv[e] * vs, q);
          }
        }
      } else {
#pragma unroll
        for (int e = 0; e < PVEC; ++e) kv[e] = vv[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < PVEC; ++e) {
        k_s[j * (D + 1) + c + e] = kv[e];
        v_s[j * D + c + e] = vv[e];
      }
    }
    __syncthreads();

#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) {
      if (c0 >= lim[rr]) continue;  // warp-uniform: the row sees nothing here
      const float* qr = q_s + (warp * RPW + rr) * D;
      const float* kr = k_s + lane * (D + 1);
      float score = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) score += qr[d] * kr[d];
      const bool visible = c0 + lane < lim[rr];
      score = visible ? score : -CUDART_INF_F;
      const float m_new = fmaxf(m[rr], warp_max(score));  // finite: lane 0 is visible
      const float alpha = expf(m[rr] - m_new);
      const float p = visible ? expf(score - m_new) : 0.f;
      l[rr] = l[rr] * alpha + warp_sum(p);
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[rr][i] *= alpha;
#pragma unroll 8
      for (int j = 0; j < kChunk; ++j) {
        const float pj = __shfl_sync(kFull, p, j);
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          const int d = lane + i * kWarp;
          if (d < D) acc[rr][i] += pj * v_s[j * D + d];
        }
      }
      m[rr] = m_new;
    }
  }

  // Every real row of the tile writes its partials; the combine reads a
  // row's split only where the row sees a position of it.
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    const int gr = row0 + warp * RPW + rr;
    const int s = gr / G, g = gr % G;
    if (s >= S) continue;
    if (out != nullptr) {
      T* o = out + (static_cast<size_t>(s) * H + kh * G + g) * D;
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + i * kWarp;
        if (d < D) store(o + d, l[rr] > 0.f ? acc[rr][i] / l[rr] : 0.f);
      }
      continue;
    }
    const size_t pr = static_cast<size_t>(split) * part.rows + row_base +
                      static_cast<size_t>(s) * H + kh * G + g;
    float* a = part.acc + pr * D;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + i * kWarp;
      if (d < D) a[d] = acc[rr][i];
    }
    if (lane == 0) {
      part.ml[2 * pr] = m[rr];
      part.ml[2 * pr + 1] = l[rr];
    }
  }
}

// One warp per row r = (b * S + s) * H + h. The row sees positions < lim;
// the splits holding one of them are the first cdiv(lim, span), and their
// partials are rescaled to the largest max. `lengths` is given for decode
// (S = 1), `start` and `q_lens` for ragged rows.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) combine_kernel(
    Partials part, const int* __restrict__ start, const int* __restrict__ q_lens,
    const int* __restrict__ lengths, T* __restrict__ out, int S, int H, int cap) {
  constexpr int DPL = (D + kWarp - 1) / kWarp;
  const int r = blockIdx.x * kWarps + threadIdx.x / kWarp;
  if (r >= part.rows) return;
  const int lane = threadIdx.x % kWarp;
  const int b = r / (S * H), s = (r / H) % S;
  const int lim = lengths != nullptr
                      ? min(max(lengths[b], 0), cap)
                      : (s < q_lens[b] ? min(start[b] + s + 1, cap) : 0);
  const int live = min(part.splits, (lim + part.span - 1) / part.span);
  float mx = -CUDART_INF_F;
  for (int i = 0; i < live; ++i) {
    mx = fmaxf(mx, part.ml[2 * (static_cast<size_t>(i) * part.rows + r)]);
  }
  float sum = 0.f;
  float o[DPL];
#pragma unroll
  for (int j = 0; j < DPL; ++j) o[j] = 0.f;
  for (int i = 0; i < live; ++i) {
    const size_t pr = static_cast<size_t>(i) * part.rows + r;
    const float w = expf(part.ml[2 * pr] - mx);
    sum += part.ml[2 * pr + 1] * w;
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      const int d = lane + j * kWarp;
      if (d < D) o[j] += part.acc[pr * D + d] * w;
    }
  }
  T* dst = out + static_cast<size_t>(r) * D;
#pragma unroll
  for (int j = 0; j < DPL; ++j) {
    const int d = lane + j * kWarp;
    if (d < D) store(dst + d, sum > 0.f ? o[j] / sum : 0.f);
  }
}

template <typename T, int D>
cudaError_t launch_combine(const Partials& part, const int* start, const int* q_lens,
                           const int* lengths, T* out, int S, int H, int cap,
                           cudaStream_t stream) {
  const int blocks = (part.rows + kWarps - 1) / kWarps;
  combine_kernel<T, D><<<blocks, kThreads, 0, stream>>>(part, start, q_lens, lengths, out,
                                                        S, H, cap);
  return cudaGetLastError();
}

// The workspace of `splits` splits over `rows` query rows: the max/sum
// pairs first, then the accumulators; splits * rows * (D + 2) floats. One
// split needs none (`workspace` may be null).
inline Partials partials(void* workspace, int rows, int splits, int span) {
  float* ws = static_cast<float*>(workspace);
  if (splits == 1) return Partials{nullptr, nullptr, rows, span, splits};
  return Partials{ws, ws + 2 * static_cast<size_t>(splits) * rows, rows, span, splits};
}

// One block of a decode split pass: sequence blockIdx.z, kv head and split
// blockIdx.y (kv head fastest), tile of kDecodeRows query heads blockIdx.x.
// The sequence's one query sits at position lengths[b] - 1 and sees
// t < lengths[b], clamped to MaxP * P. bf16 q runs the tensor-core routine,
// f32 q the CUDA-core body.
template <typename T, typename PT, int D>
__device__ __forceinline__ void decode_split(
    const T* __restrict__ q, const PT* __restrict__ k_pages,
    const PT* __restrict__ v_pages, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ table,
    const int* __restrict__ lengths, const Partials& part, T* __restrict__ out, int H,
    int K, int P, int max_pages, float scale) {
  const int b = blockIdx.z;
  const int kh = blockIdx.y % K, split = blockIdx.y / K;
  const int len = max(lengths[b], 0);
  const size_t seq = static_cast<size_t>(b) * H;
  const int* table_row = table + static_cast<size_t>(b) * max_pages;
  T* seq_out = part.splits == 1 ? out + seq * D : nullptr;
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    const size_t pr = static_cast<size_t>(split) * part.rows + seq;
    const TileOut dst = seq_out != nullptr ? TileOut{seq_out, nullptr, nullptr}
                                           : TileOut{nullptr, part.ml + 2 * pr, part.acc + pr * D};
    const int t_begin = split * part.span;
    const int t_end = min(t_begin + part.span, min(len, max_pages * P));
    attend_decode<PT, D>(q + seq * D, k_pages, v_pages, k_scale, v_scale, table_row, dst, H,
                         K, P, kh, blockIdx.x, t_begin, t_end, scale);
  } else {
    attend_split<T, PT, D, kDecodeRowsPerWarp>(
        q + seq * D, k_pages, v_pages, k_scale, v_scale, table_row, part, seq_out,
        static_cast<int>(seq), 1, H, K, P, max_pages, kh, blockIdx.x, split,
        max(len - 1, 0), len > 0 ? 1 : 0, scale);
  }
}

// The decode split pass's dynamic shared memory and grid.
template <typename T, typename PT, int D>
constexpr int decode_smem() {
  return std::is_same_v<T, __nv_bfloat16> ? decode_smem_bytes<PT, D>()
                                          : smem_bytes<D, kDecodeRowsPerWarp>();
}

inline dim3 decode_grid(int H, int K, int splits, int B) {
  return dim3((H / K + kDecodeRows - 1) / kDecodeRows, K * splits, B);
}

}  // namespace attn
