// Paged GQA attention split over the KV sequence, for NVIDIA Hopper (sm_90a).
//
// Two entry points, each a split pass on the caller's stream and, when the
// call has more than one split, a combine pass after it:
//
//   opsagent_paged_ragged_attention_grid  replaces  paged_ragged_attention_pallas
//       (opsagent_tpu/ops/paged_attention_pallas.py: body _kernel_ragged, page
//       map _page_index_ragged, the int8 operands of its QuantizedPages branch):
//       ragged query rows (decode rows at q_len 1 beside prefill chunks) over
//       paged KV, causal inside the chunk;
//   opsagent_paged_decode_attention_grid  replaces  paged_decode_attention_pallas
//       (same file: body _kernel, page maps _page_index and _scale_index): one
//       query per sequence over its `lengths[b]` cached tokens.
//
// Contract: the same function as paged_attention.cu (the TPU grid and DMA
// kernels compute one function, and both ports share one plain PyTorch
// version in opsagent_tpu_torch/ops/attention.py): pages [N, P, K, D]
// contiguous, in q's dtype, or int8 with f32 scale planes [N, P, K]; page
// table [B, MaxP] int32 read as max(slot, 0); query s of row b sees cache
// positions t <= start[b] + s and t < start[b] + q_lens[b], clamped to
// MaxP * P, so lengths past the table are tolerated; scale D^-1/2; online
// softmax in f32; output in q's dtype; rows with no visible position are
// exact zeros (the TPU grid kernel leaves finite garbage there).
//
// Design. The TPU grid is (sequence, page slot) with the page axis innermost
// and sequential: one page per grid step, the softmax state carried in VMEM
// scratch from one page to the next. On Hopper blocks run in parallel and in
// no order, so the page-slot axis becomes a split of the KV sequence
// (flash-decoding). A block of the split pass owns (sequence, kv head, tile
// of query rows, split); a split is `span` consecutive cache positions, a
// whole number of pages, and the host picks how many from MaxP and the row
// count so that the workspace stays bounded and, for ragged rows, so that
// no block walks much more than 1024 positions. The rows of a tile are (s, g)
// pairs of one kv head's group of G = H / K query heads, so every K/V row
// the block loads serves all G heads of a position (any G: 7 for Qwen2.5).
// The block walks the positions of its split that its rows can see, 32 at a
// time (one per lane), gathering each position's [D] row of its kv head
// through the page table into shared memory as f32; each warp keeps RPW
// rows' running max, sum and [D] accumulator in registers, and at the end
// writes them, unnormalised, to the workspace. A split that starts past the
// last position its tile can see exits at once: the counterpart of the
// clamped index maps, under which the TPU pipeline skips the page refetch.
// The combine pass gives one warp to each (query row, head): it reads the
// partials of the splits that hold a position the row sees, rescales them
// to their largest max, normalises and writes q's dtype.
//
// int8 pages are dequantized as they are gathered, code * scale of that
// token and kv head in f32 rounded to q's dtype, as the plain version reads
// them (paged_attention.cu says why not in score space as the TPU kernel).
//
// What bounds it on the H100: reading the K/V rows each sequence can see,
// 2 * K * D * bytes per position (2 * K * (D + 4) for int8 pages), at
// 3.35 TB/s; the partials add 4 * (D + 2) bytes per (split, query row, head)
// written and read once. A long prefill chunk also does 4 * D f32
// operations per (query head, visible position).
//
// The bf16 instances of the ragged split pass (pages in bf16 or int8) run
// the tensor-core tile routine `attend_mma` (attention_mma.cuh) over their
// split: both products on mma.sync, the pages gathered with a
// double-buffered cp.async pipeline. The f32 instances and the decode
// split pass keep `attend_split` below, whose products run on CUDA cores
// in f32 with synchronous loads. With one split the split pass normalises
// and writes q's dtype itself and the combine is not launched, so nothing
// goes through the workspace.

#include "attention_mma.cuh"

namespace {

using namespace attn;

constexpr int kWarps = 4;                  // warps per block
constexpr int kThreads = kWarps * kWarp;
constexpr int kChunk = kWarp;              // cache positions per pass: one per lane
// Query rows per tile: warps * rows per warp. ops/paged_attention.py mirrors
// these (GRID_TILE_ROWS) to size the split pass on the host.
constexpr int kRaggedRowsPerWarp = 16;     // 64 rows per ragged tile
constexpr int kDecodeRowsPerWarp = 2;      // 8 rows: a group of up to 8 heads per decode tile

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

template <typename T, typename PT, int D, int RPW>
__global__ void __launch_bounds__(kThreads) ragged_split_kernel(
    const T* __restrict__ q, const PT* __restrict__ k_pages,
    const PT* __restrict__ v_pages, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ table,
    const int* __restrict__ start, const int* __restrict__ q_lens, Partials part,
    T* __restrict__ out, int S, int H, int K, int P, int max_pages, float scale) {
  const int b = blockIdx.z;
  const int kh = blockIdx.y % K, split = blockIdx.y / K;
  const size_t seq = static_cast<size_t>(b) * S * H;
  const int* table_row = table + static_cast<size_t>(b) * max_pages;
  T* seq_out = part.splits == 1 ? out + seq * D : nullptr;
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    const size_t pr = static_cast<size_t>(split) * part.rows + seq;
    const TileOut dst = seq_out != nullptr ? TileOut{seq_out, nullptr, nullptr}
                                           : TileOut{nullptr, part.ml + 2 * pr, part.acc + pr * D};
    attend_mma<PT, D>(q + seq * D, k_pages, v_pages, k_scale, v_scale, table_row, dst, S, H, K, P,
                      max_pages, kh, blockIdx.x, start[b], q_lens[b], split * part.span,
                      split * part.span + part.span, scale);
  } else {
    attend_split<T, PT, D, RPW>(q + seq * D, k_pages, v_pages, k_scale, v_scale, table_row,
                                part, seq_out, static_cast<int>(seq), S, H, K, P, max_pages,
                                kh, blockIdx.x, split, start[b], q_lens[b], scale);
  }
}

template <typename T, typename PT, int D, int RPW>
__global__ void __launch_bounds__(kThreads) decode_split_kernel(
    const T* __restrict__ q, const PT* __restrict__ k_pages,
    const PT* __restrict__ v_pages, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ table,
    const int* __restrict__ lengths, Partials part, T* __restrict__ out, int H, int K,
    int P, int max_pages, float scale) {
  const int b = blockIdx.z;
  const int kh = blockIdx.y % K, split = blockIdx.y / K;
  const int len = lengths[b];
  const size_t seq = static_cast<size_t>(b) * H;
  // One query at position len - 1: it sees t < len.
  attend_split<T, PT, D, RPW>(
      q + seq * D, k_pages, v_pages, k_scale, v_scale,
      table + static_cast<size_t>(b) * max_pages, part,
      part.splits == 1 ? out + seq * D : nullptr, static_cast<int>(seq), 1, H, K, P,
      max_pages, kh, blockIdx.x, split, max(len - 1, 0), len > 0 ? 1 : 0, scale);
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

// The arguments every launch shares: pages and scale planes (null unless
// the pages are int8), page table, output, workspace and shapes.
struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* k_scale;
  const float* v_scale;
  const int* table;
  void* out;
  Partials part;
  int B, H, K, P, max_pages;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D>
cudaError_t launch_combine(const Args& a, const int* start, const int* q_lens,
                           const int* lengths, int S) {
  const int blocks = (a.part.rows + kWarps - 1) / kWarps;
  combine_kernel<T, D><<<blocks, kThreads, 0, a.stream>>>(
      a.part, start, q_lens, lengths, static_cast<T*>(a.out), S, a.H, a.max_pages * a.P);
  return cudaGetLastError();
}

template <typename T, typename PT, int D>
cudaError_t launch_ragged(const Args& a, const int* start, const int* q_lens, int S) {
  constexpr int RPW = kRaggedRowsPerWarp;
  static_assert(kWarps * RPW == kMmaRows && kThreads == kMmaThreads,
                "both bodies tile the rows alike");
  constexpr int bytes = std::is_same_v<T, __nv_bfloat16> ? mma_smem_bytes<PT, D>()
                                                         : smem_bytes<D, RPW>();
  auto kernel = ragged_split_kernel<T, PT, D, RPW>;
  cudaError_t err = prepare(kernel, bytes);
  if (err != cudaSuccess) return err;
  const int rows = S * (a.H / a.K);
  const dim3 grid((rows + kWarps * RPW - 1) / (kWarps * RPW), a.K * a.part.splits, a.B);
  kernel<<<grid, kThreads, bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const PT*>(a.k), static_cast<const PT*>(a.v),
      a.k_scale, a.v_scale, a.table, start, q_lens, a.part, static_cast<T*>(a.out), S, a.H,
      a.K, a.P, a.max_pages, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.part.splits == 1) return err;
  return launch_combine<T, D>(a, start, q_lens, nullptr, S);
}

template <typename T, typename PT, int D>
cudaError_t launch_decode(const Args& a, const int* lengths) {
  constexpr int RPW = kDecodeRowsPerWarp;
  constexpr int bytes = smem_bytes<D, RPW>();
  auto kernel = decode_split_kernel<T, PT, D, RPW>;
  cudaError_t err = prepare(kernel, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.H / a.K + kWarps * RPW - 1) / (kWarps * RPW), a.K * a.part.splits, a.B);
  kernel<<<grid, kThreads, bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const PT*>(a.k), static_cast<const PT*>(a.v),
      a.k_scale, a.v_scale, a.table, lengths, a.part, static_cast<T*>(a.out), a.H, a.K, a.P,
      a.max_pages, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.part.splits == 1) return err;
  return launch_combine<T, D>(a, nullptr, nullptr, lengths, 1);
}

struct Ragged {
  const Args& a;
  const int* start;
  const int* q_lens;
  int S;
  template <typename T, typename PT, int D>
  cudaError_t run() const { return launch_ragged<T, PT, D>(a, start, q_lens, S); }
};

struct Decode {
  const Args& a;
  const int* lengths;
  template <typename T, typename PT, int D>
  cudaError_t run() const { return launch_decode<T, PT, D>(a, lengths); }
};

// The workspace of `splits` splits over `rows` query rows: the max/sum
// pairs first, then the accumulators; splits * rows * (D + 2) floats. One
// split needs none (`workspace` may be null).
Partials partials(void* workspace, int rows, int splits, int span) {
  float* ws = static_cast<float*>(workspace);
  if (splits == 1) return Partials{nullptr, nullptr, rows, span, splits};
  return Partials{ws, ws + 2 * static_cast<size_t>(splits) * rows, rows, span, splits};
}

}  // namespace

// Plain C interface, bound with ctypes. Every call launches the split pass
// and, with more than one split, the combine on `stream`, does not
// synchronise, and returns cudaGetLastError() (0 = launched). `dtype` is
// q's (0 = f32, 1 = bf16); pages are in q's dtype when `k_scale` and
// `v_scale` are null, else int8 with those f32 scale planes [N, P, K].
// `workspace` holds splits * B * S * H * (D + 2) floats (S = 1 for decode;
// null with one split); `span` is the cache positions of one split, a
// positive multiple of P, and splits * span covers MaxP * P.
extern "C" int opsagent_paged_ragged_attention_grid(
    const void* q, const void* k_pages, const void* v_pages, const void* k_scale,
    const void* v_scale, const void* table, const void* start, const void* q_lens,
    void* workspace, void* out, int B, int S, int H, int K, int D, int P, int max_pages,
    int splits, int span, float scale, int dtype, void* stream) {
  if (B == 0 || S == 0) return cudaSuccess;
  if (splits < 1 || span < 1) return cudaErrorInvalidValue;
  if (splits > 1 && workspace == nullptr) return cudaErrorInvalidValue;
  const Args a{q, k_pages, v_pages, static_cast<const float*>(k_scale),
               static_cast<const float*>(v_scale), static_cast<const int*>(table), out,
               partials(workspace, B * S * H, splits, span), B, H, K, P, max_pages,
               scale, static_cast<cudaStream_t>(stream)};
  const auto* st = static_cast<const int*>(start);
  const auto* ql = static_cast<const int*>(q_lens);
  return dispatch(dtype, D, k_scale != nullptr, Ragged{a, st, ql, S});
}

extern "C" int opsagent_paged_decode_attention_grid(
    const void* q, const void* k_pages, const void* v_pages, const void* k_scale,
    const void* v_scale, const void* table, const void* lengths, void* workspace, void* out,
    int B, int H, int K, int D, int P, int max_pages, int splits, int span, float scale,
    int dtype, void* stream) {
  if (B == 0) return cudaSuccess;
  if (splits < 1 || span < 1) return cudaErrorInvalidValue;
  if (splits > 1 && workspace == nullptr) return cudaErrorInvalidValue;
  const Args a{q, k_pages, v_pages, static_cast<const float*>(k_scale),
               static_cast<const float*>(v_scale), static_cast<const int*>(table), out,
               partials(workspace, B * H, splits, span), B, H, K, P, max_pages, scale,
               static_cast<cudaStream_t>(stream)};
  const auto* ln = static_cast<const int*>(lengths);
  return dispatch(dtype, D, k_scale != nullptr, Decode{a, ln});
}
