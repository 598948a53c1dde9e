// Paged GQA attention over a paged KV cache, for NVIDIA Hopper (sm_90a).
//
// Two entry points:
//
//   opsagent_paged_ragged_attention  replaces  paged_ragged_attention_pallas_dma
//       (opsagent_tpu/ops/paged_attention_pallas.py, body _kernel_ragged_dma):
//       ragged query rows (decode rows at q_len 1 beside prefill chunks) over
//       paged KV, causal inside the chunk. One launch per layer per mixed tick.
//   opsagent_paged_decode_attention  replaces  paged_decode_attention_pallas_dma
//       (same file, body _kernel_dma): one query per sequence over its
//       `lengths[b]` cached tokens. One launch per layer per decode step.
//
//   opsagent_paged_ragged_attention_latent and
//   opsagent_paged_decode_attention_latent  compute the same two functions
//       at the MLA latent shape (K = 1, D = 576, one page array read as
//       both K and V), the path on which the JAX model calls
//       paged_ragged_attention and paged_decode_attention
//       (opsagent_tpu/ops/attention.py) with `kc, kc`; its Pallas dma
//       kernels compute the same in interpret mode. Design in
//       attention_latent.cuh.
//   opsagent_paged_ragged_attention_mla  computes the ragged function at
//       the materialized-MLA shape in bf16 (D = 192, pages in q's dtype):
//       DeepSeek-V2/V3 with latent_cache off. Design in attention_mla.cuh.
//
// Contract (identical to the TPU kernels and to the plain PyTorch versions
// in opsagent_tpu_torch/ops/attention.py): pages [N, P, K, D] contiguous,
// in q's dtype, or int8 with f32 scale planes [N, P, K] (the TPU kernels'
// QuantizedPages branch: one scale per token and kv head);
// page_table [B, MaxP] int32 with -1 = unassigned (read as page 0); query
// s of row b sees cache positions t <= start[b] + s and t < start[b] +
// q_lens[b], clamped to MaxP * P. Softmax is online in f32 (in attend_split
// q is cast to f32 and scaled by D^-1/2 before the product, probabilities
// stay f32 for the product with V; the tensor-core routines' numbers are
// in their own headers), and the output is written in q's dtype. Rows with
// no visible position (s >= q_len, q_len 0, length 0) are written as exact
// zeros.
//
// Ragged design. The TPU kernels dot every query head against all K kv
// heads of a page and mask the wrong groups away; here each thread block
// owns one (sequence, kv head, tile of query rows), so no product is
// wasted, and walks the whole sequence. The rows of a tile are (s, g) pairs
// of that kv head's group of G = H / K query heads: the G heads of one
// position share every K/V row the block loads. The bf16 instances (pages
// in bf16 or int8) run the tensor-core tile routine `attend_mma`
// (attention_mma.cuh), except at D = 192, whose bf16 call is the warpgroup
// kernel of attention_mla.cuh. The f32 instances run the CUDA-core body
// `attend_split` (attention_split.cuh) over one split that spans the
// table: the tensor cores hold no f32 tolerance of 1e-5, and f32 is on no
// served path.
//
// Decode design. The decode kernel splits each sequence's KV positions
// over blocks (flash-decoding; attention_split.cuh), as the grid form
// does: a block owns (sequence, kv head, split, tile of 16 query heads),
// the host picks the splits from shapes so that no block walks more than
// 256 positions, and with more than one split a combine pass reduces the
// partials. bf16 q runs the tensor-core decode routine `attend_decode`
// (attention_decode.cuh), f32 q the CUDA-core `attend_split`. Both forms'
// decode kernels share this body; each keeps its own entry point and name.
//
// int8 pages are dequantized as they are gathered: code * scale of that
// token and kv head in f32, rounded to q's dtype, which is how the plain
// version (and the JAX package's gather reader) dequantizes them. The TPU
// kernel instead scales in score space, s = (q . k_int8) * k_scale and
// acc += (p * v_scale) . v_int8, all in f32: the same numbers in f32, and
// in bf16 they differ by the rounding of K and V to bf16, which moves a
// bf16 output by an ulp (0.0156 at |out| >= 2) where the kernel and the
// plain version must agree to 1e-2.
//
// What bounds it on the H100: reading the K/V rows, 2 * K * D * bytes per
// cached position per sequence (2 * K * (D + 4) with int8 pages), at
// 3.35 TB/s; the decode's partials add 4 * (D + 2) bytes per (split, head)
// written and read once. Decode is that and nothing else. A long prefill
// chunk also does 4 * D operations per (query head, visible position).
// What the ragged kernel leaves on the table: prefill tiles of 64 rows
// each re-read their sequence's K/V (through L2) once per tile, and the
// block holding the longest row walks it alone.

#include "attention_latent.cuh"
#include "attention_mla.cuh"

namespace {

using namespace attn;

constexpr int kRaggedRowsPerWarp = 16;     // 64 query rows per prefill tile

template <typename T, typename PT, int D, int RPW>
__global__ void __launch_bounds__(kThreads) ragged_kernel(
    const T* __restrict__ q, const PT* __restrict__ k_pages,
    const PT* __restrict__ v_pages, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ table,
    const int* __restrict__ start, const int* __restrict__ q_lens,
    T* __restrict__ out, int S, int H, int K, int P, int max_pages, float scale) {
  const int b = blockIdx.z;
  const size_t seq = static_cast<size_t>(b) * S * H * D;
  const int* table_row = table + static_cast<size_t>(b) * max_pages;
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    attend_mma<PT, D>(q + seq, k_pages, v_pages, k_scale, v_scale, table_row,
                      TileOut{out + seq, nullptr, nullptr}, S, H, K, P, max_pages,
                      blockIdx.y, blockIdx.x, start[b], q_lens[b], 0, max_pages * P, scale);
  } else {
    // The CUDA-core split body over one split that spans the table.
    attend_split<T, PT, D, RPW>(q + seq, k_pages, v_pages, k_scale, v_scale, table_row,
                                Partials{nullptr, nullptr, 0, max_pages * P, 1}, out + seq, 0,
                                S, H, K, P, max_pages, blockIdx.y, blockIdx.x, 0, start[b],
                                q_lens[b], scale);
  }
}

template <typename T, typename PT, int D>
__global__ void __launch_bounds__(kThreads) decode_kernel(
    const T* __restrict__ q, const PT* __restrict__ k_pages,
    const PT* __restrict__ v_pages, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ table,
    const int* __restrict__ lengths, Partials part, T* __restrict__ out, int H, int K,
    int P, int max_pages, float scale) {
  decode_split<T, PT, D>(q, k_pages, v_pages, k_scale, v_scale, table, lengths, part, out, H,
                         K, P, max_pages, scale);
}

// The arguments every launch shares: pages and scale planes (null unless
// the pages are int8), page table, output and shapes.
struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* k_scale;
  const float* v_scale;
  const int* table;
  void* out;
  int B, H, K, P, max_pages;
  float scale;
  cudaStream_t stream;
};

template <typename T, typename PT, int D>
cudaError_t launch_ragged(const Args& a, const int* start, const int* q_lens, int S) {
  if constexpr (std::is_same_v<T, __nv_bfloat16> && D == kMlaDim) {
    return cudaErrorInvalidValue;   // opsagent_paged_ragged_attention_mla's
  } else {
  constexpr int RPW = kRaggedRowsPerWarp;
  static_assert(kWarps * RPW == kMmaRows && kThreads == kMmaThreads,
                "both bodies tile the rows alike");
  constexpr int bytes = std::is_same_v<T, __nv_bfloat16> ? mma_smem_bytes<PT, D>()
                                                         : smem_bytes<D, RPW>();
  auto kernel = ragged_kernel<T, PT, D, RPW>;
  static const cudaError_t prepared = prepare(kernel, bytes);  // once per instance
  if (prepared != cudaSuccess) return prepared;
  const int rows = S * (a.H / a.K);
  const dim3 grid((rows + kWarps * RPW - 1) / (kWarps * RPW), a.K, a.B);
  kernel<<<grid, kThreads, bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const PT*>(a.k), static_cast<const PT*>(a.v),
      a.k_scale, a.v_scale, a.table, start, q_lens, static_cast<T*>(a.out), S, a.H, a.K,
      a.P, a.max_pages, a.scale);
  return cudaGetLastError();
  }
}

template <typename T, typename PT, int D>
cudaError_t launch_decode(const Args& a, const int* lengths, const Partials& part) {
  constexpr int bytes = decode_smem<T, PT, D>();
  auto kernel = decode_kernel<T, PT, D>;
  static const cudaError_t prepared = prepare(kernel, bytes);  // once per instance
  if (prepared != cudaSuccess) return prepared;
  kernel<<<decode_grid(a.H, a.K, part.splits, a.B), kThreads, bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const PT*>(a.k), static_cast<const PT*>(a.v),
      a.k_scale, a.v_scale, a.table, lengths, part, static_cast<T*>(a.out), a.H, a.K, a.P,
      a.max_pages, a.scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || part.splits == 1) return err;
  return launch_combine<T, D>(part, nullptr, nullptr, lengths, static_cast<T*>(a.out), 1, a.H,
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
  Partials part;
  template <typename T, typename PT, int D>
  cudaError_t run() const { return launch_decode<T, PT, D>(a, lengths, part); }
};

// f32 latent calls: the CUDA-core kernels, the decode split as planned by
// the host and reduced by combine_kernel<float, 576>.
cudaError_t launch_latent_ragged_f32(const void* q, const void* pages, const int* table,
                                     const int* start, const int* q_lens, void* out, int B,
                                     int S, int H, int P, int max_pages, float scale,
                                     cudaStream_t stream) {
  constexpr int bytes = latent_f32_smem_bytes();
  static const cudaError_t prepared = prepare(latent_ragged_kernel, bytes);
  if (prepared != cudaSuccess) return prepared;
  const dim3 grid((S * H + kLatentRows - 1) / kLatentRows, B);
  latent_ragged_kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(pages), table, start, q_lens,
      static_cast<float*>(out), S, H, P, max_pages, scale);
  return cudaGetLastError();
}

cudaError_t launch_latent_decode_f32(const void* q, const void* pages, const int* table,
                                     const int* lengths, const Partials& part, void* out, int B,
                                     int H, int P, int max_pages, float scale,
                                     cudaStream_t stream) {
  constexpr int bytes = latent_f32_smem_bytes();
  static const cudaError_t prepared = prepare(latent_decode_kernel, bytes);
  if (prepared != cudaSuccess) return prepared;
  const dim3 grid((H + kLatentRows - 1) / kLatentRows, part.splits, B);
  latent_decode_kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(pages), table, lengths, part,
      static_cast<float*>(out), H, P, max_pages, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || part.splits == 1) return err;
  return launch_combine<float, kLatentDim>(part, nullptr, nullptr, lengths,
                                           static_cast<float*>(out), 1, H, max_pages * P, stream);
}

}  // namespace

// Plain C interface, bound with ctypes. Every call launches on `stream`, does
// not synchronise, and returns cudaGetLastError() (0 = launched). `dtype` is
// q's (0 = f32, 1 = bf16); pages are in q's dtype when `k_scale` and
// `v_scale` are null, else int8 with those f32 scale planes [N, P, K].
// The decode call launches the split pass and, with more than one split,
// the combine; `workspace` holds splits * B * H * (D + 2) floats (null
// with one split) and `span` is the cache positions of one split, a
// positive multiple of P, with splits * span covering MaxP * P.
extern "C" int opsagent_paged_ragged_attention(
    const void* q, const void* k_pages, const void* v_pages, const void* k_scale,
    const void* v_scale, const void* table, const void* start, const void* q_lens,
    void* out, int B, int S, int H, int K, int D, int P, int max_pages, float scale,
    int dtype, void* stream) {
  if (B == 0 || S == 0) return cudaSuccess;
  const Args a{q, k_pages, v_pages, static_cast<const float*>(k_scale),
               static_cast<const float*>(v_scale), static_cast<const int*>(table), out,
               B, H, K, P, max_pages, scale, static_cast<cudaStream_t>(stream)};
  const auto* st = static_cast<const int*>(start);
  const auto* ql = static_cast<const int*>(q_lens);
  return dispatch<true>(dtype, D, k_scale != nullptr, Ragged{a, st, ql, S});
}

// The bf16 materialized-MLA ragged call: q [B, S, H, 192] and pages [N, P,
// K, 192] in bf16; the rest as opsagent_paged_ragged_attention, over
// `blocks` blocks (two an SM) with `workspace` holding 2 * blocks * 64 *
// 194 + 4 * blocks floats.
extern "C" int opsagent_paged_ragged_attention_mla(
    const void* q, const void* k_pages, const void* v_pages, const void* table,
    const void* start, const void* q_lens, void* workspace, void* out, int B, int S, int H,
    int K, int P, int max_pages, int blocks, float scale, void* stream) {
  if (B == 0 || S == 0) return cudaSuccess;
  if (blocks < 1 || workspace == nullptr || K < 1 || H % K != 0) return cudaErrorInvalidValue;
  return launch_mla_wg(q, k_pages, v_pages, static_cast<const int*>(table),
                       static_cast<const int*>(start), static_cast<const int*>(q_lens),
                       static_cast<float*>(workspace), out, B, S, H, K, P, max_pages, blocks,
                       scale, static_cast<cudaStream_t>(stream));
}

extern "C" int opsagent_paged_decode_attention(
    const void* q, const void* k_pages, const void* v_pages, const void* k_scale,
    const void* v_scale, const void* table, const void* lengths, void* workspace, void* out,
    int B, int H, int K, int D, int P, int max_pages, int splits, int span, float scale,
    int dtype, void* stream) {
  if (B == 0) return cudaSuccess;
  if (splits < 1 || span < 1) return cudaErrorInvalidValue;
  if (splits > 1 && workspace == nullptr) return cudaErrorInvalidValue;
  const Args a{q, k_pages, v_pages, static_cast<const float*>(k_scale),
               static_cast<const float*>(v_scale), static_cast<const int*>(table), out,
               B, H, K, P, max_pages, scale, static_cast<cudaStream_t>(stream)};
  const auto* ln = static_cast<const int*>(lengths);
  return dispatch<true>(dtype, D, k_scale != nullptr,
                        Decode{a, ln, partials(workspace, B * H, splits, span)});
}

// The latent instances: q [B, S, H, 576] (decode [B, H, 576]) and pages
// [N, P, 1, 576] in q's dtype, the one page array serving as K and V; the
// rest as above. bf16 runs the warpgroup kernels over `blocks` blocks (one
// an SM) with `workspace` holding 2 * blocks * 64 * 578 floats, both calls;
// f32 ragged takes neither, f32 decode takes `splits` and `span` as above
// (`workspace`: splits * B * H * 578 floats with more than one split).
extern "C" int opsagent_paged_ragged_attention_latent(
    const void* q, const void* pages, const void* table, const void* start,
    const void* q_lens, void* workspace, void* out, int B, int S, int H, int P, int max_pages,
    int blocks, float scale, int dtype, void* stream) {
  if (B == 0 || S == 0) return cudaSuccess;
  const auto* tb = static_cast<const int*>(table);
  const auto* st = static_cast<const int*>(start);
  const auto* ql = static_cast<const int*>(q_lens);
  auto* s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) {
    return launch_latent_ragged_f32(q, pages, tb, st, ql, out, B, S, H, P, max_pages, scale, s);
  }
  if (dtype == kBFloat16) {
    if (blocks < 1 || workspace == nullptr) return cudaErrorInvalidValue;
    return launch_latent_wg<false>(q, pages, tb, st, ql, static_cast<float*>(workspace), out, B,
                                   S, H, P, max_pages, blocks, scale, s);
  }
  return cudaErrorInvalidValue;
}

extern "C" int opsagent_paged_decode_attention_latent(
    const void* q, const void* pages, const void* table, const void* lengths, void* workspace,
    void* out, int B, int H, int P, int max_pages, int splits, int span, int blocks, float scale,
    int dtype, void* stream) {
  if (B == 0) return cudaSuccess;
  const auto* tb = static_cast<const int*>(table);
  const auto* ln = static_cast<const int*>(lengths);
  auto* s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) {
    if (splits < 1 || span < 1) return cudaErrorInvalidValue;
    if (splits > 1 && workspace == nullptr) return cudaErrorInvalidValue;
    return launch_latent_decode_f32(q, pages, tb, ln, partials(workspace, B * H, splits, span),
                                    out, B, H, P, max_pages, scale, s);
  }
  if (dtype == kBFloat16) {
    if (blocks < 1 || workspace == nullptr) return cudaErrorInvalidValue;
    return launch_latent_wg<true>(q, pages, tb, ln, nullptr, static_cast<float*>(workspace), out,
                                  B, 1, H, P, max_pages, blocks, scale, s);
  }
  return cudaErrorInvalidValue;
}
