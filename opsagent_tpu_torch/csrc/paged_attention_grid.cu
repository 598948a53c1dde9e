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
// (flash-decoding; attention_split.cuh holds the partials, the combine and
// the CUDA-core split body). A block of the split pass owns (sequence, kv
// head, tile of query rows, split); a split is `span` consecutive cache
// positions, a whole number of pages, and the host picks how many from MaxP
// and the row count so that the workspace stays bounded and no block walks
// much more than 1024 (ragged) or 256 (decode) positions. The rows of a
// tile are (s, g) pairs of one kv head's group of G = H / K query heads, so
// every K/V row the block loads serves all G heads of a position (any G: 7
// for Qwen2.5). A split that starts past the last position its tile can
// see exits at once: the counterpart of the clamped index maps, under which
// the TPU pipeline skips the page refetch.
//
// int8 pages are dequantized as they are gathered, code * scale of that
// token and kv head in f32 rounded to q's dtype, as the plain version reads
// them (paged_attention.cu says why not in score space as the TPU kernel).
//
// What bounds it on the H100: reading the K/V rows each sequence can see,
// 2 * K * D * bytes per position (2 * K * (D + 4) for int8 pages), at
// 3.35 TB/s; the partials add 4 * (D + 2) bytes per (split, query row, head)
// written and read once. A long prefill chunk also does 4 * D operations
// per (query head, visible position).
//
// The bf16 instances (pages in bf16 or int8) run tensor-core routines over
// their split: the ragged pass `attend_mma` (attention_mma.cuh), the decode
// pass `attend_decode` (attention_decode.cuh, through decode_split, which
// the dma form's decode kernel shares). The f32 instances keep the
// CUDA-core `attend_split`. With one split the split pass normalises and
// writes q's dtype itself and the combine is not launched, so nothing goes
// through the workspace.

#include "attention_split.cuh"

namespace {

using namespace attn;

// Query rows per ragged tile: warps * rows per warp. ops/paged_attention.py
// mirrors it (GRID_TILE_ROWS) to size the split pass on the host.
constexpr int kRaggedRowsPerWarp = 16;     // 64 rows per ragged tile

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

template <typename T, typename PT, int D>
__global__ void __launch_bounds__(kThreads) decode_split_kernel(
    const T* __restrict__ q, const PT* __restrict__ k_pages,
    const PT* __restrict__ v_pages, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ table,
    const int* __restrict__ lengths, Partials part, T* __restrict__ out, int H, int K,
    int P, int max_pages, float scale) {
  decode_split<T, PT, D>(q, k_pages, v_pages, k_scale, v_scale, table, lengths, part, out, H,
                         K, P, max_pages, scale);
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

template <typename T, typename PT, int D>
cudaError_t launch_ragged(const Args& a, const int* start, const int* q_lens, int S) {
  constexpr int RPW = kRaggedRowsPerWarp;
  static_assert(kWarps * RPW == kMmaRows && kThreads == kMmaThreads,
                "both bodies tile the rows alike");
  constexpr int bytes = std::is_same_v<T, __nv_bfloat16> ? mma_smem_bytes<PT, D>()
                                                         : smem_bytes<D, RPW>();
  auto kernel = ragged_split_kernel<T, PT, D, RPW>;
  static const cudaError_t prepared = prepare(kernel, bytes);  // once per instance
  if (prepared != cudaSuccess) return prepared;
  const int rows = S * (a.H / a.K);
  const dim3 grid((rows + kWarps * RPW - 1) / (kWarps * RPW), a.K * a.part.splits, a.B);
  kernel<<<grid, kThreads, bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const PT*>(a.k), static_cast<const PT*>(a.v),
      a.k_scale, a.v_scale, a.table, start, q_lens, a.part, static_cast<T*>(a.out), S, a.H,
      a.K, a.P, a.max_pages, a.scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.part.splits == 1) return err;
  return launch_combine<T, D>(a.part, start, q_lens, nullptr, static_cast<T*>(a.out), S, a.H,
                              a.max_pages * a.P, a.stream);
}

template <typename T, typename PT, int D>
cudaError_t launch_decode(const Args& a, const int* lengths) {
  constexpr int bytes = decode_smem<T, PT, D>();
  auto kernel = decode_split_kernel<T, PT, D>;
  static const cudaError_t prepared = prepare(kernel, bytes);  // once per instance
  if (prepared != cudaSuccess) return prepared;
  kernel<<<decode_grid(a.H, a.K, a.part.splits, a.B), kThreads, bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const PT*>(a.k), static_cast<const PT*>(a.v),
      a.k_scale, a.v_scale, a.table, lengths, a.part, static_cast<T*>(a.out), a.H, a.K, a.P,
      a.max_pages, a.scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.part.splits == 1) return err;
  return launch_combine<T, D>(a.part, nullptr, nullptr, lengths, static_cast<T*>(a.out), 1, a.H,
                              a.max_pages * a.P, a.stream);
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
