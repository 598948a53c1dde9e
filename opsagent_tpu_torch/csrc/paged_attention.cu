// Paged GQA attention over a paged KV cache, for NVIDIA Hopper (sm_90a).
//
// Two entry points share one device function, `attend_tile`:
//
//   opsagent_paged_ragged_attention  replaces  paged_ragged_attention_pallas_dma
//       (opsagent_tpu/ops/paged_attention_pallas.py, body _kernel_ragged_dma):
//       ragged query rows (decode rows at q_len 1 beside prefill chunks) over
//       paged KV, causal inside the chunk. One launch per layer per mixed tick.
//   opsagent_paged_decode_attention  replaces  paged_decode_attention_pallas_dma
//       (same file, body _kernel_dma): one query per sequence over its
//       `lengths[b]` cached tokens. One launch per layer per decode step.
//
// Contract (identical to the TPU kernels and to the plain PyTorch versions
// in opsagent_tpu_torch/ops/attention.py): pages [N, P, K, D] contiguous,
// in q's dtype, or int8 with f32 scale planes [N, P, K] (the TPU kernels'
// QuantizedPages branch: one scale per token and kv head);
// page_table [B, MaxP] int32 with -1 = unassigned (read as page 0); query
// s of row b sees cache positions t <= start[b] + s and t < start[b] +
// q_lens[b], clamped to MaxP * P. Softmax is online in f32 (in attend_tile
// q is cast to f32 and scaled by D^-1/2 before the product, probabilities
// stay f32 for the product with V; attend_mma's numbers are in its own
// header), and the output is written in q's dtype. Rows with
// no visible position (s >= q_len, q_len 0, length 0) are written as exact
// zeros.
//
// Design. The TPU kernels dot every query head against all K kv heads of a
// page and mask the wrong groups away; here each thread block owns one
// (sequence, kv head, tile of query rows), so no product is wasted. The
// rows of a tile are (s, g) pairs of that kv head's group of G = H / K query
// heads: the G heads of one position share every K/V row the block loads.
// The block walks only the positions its rows can see, 32 at a time (one
// per lane), gathering each position's [D] row of this kv head through the
// page table into shared memory as f32. Each warp owns RPW rows and keeps
// their running max, sum and [D] accumulator in registers: lane j scores
// position j against the row's query, the warp reduces max and sum with
// shuffles, and every lane then accumulates its D/32 output dims over the
// 32 positions. int8 pages are dequantized as they are gathered: code *
// scale of that token and kv head in f32, rounded to q's dtype, which is
// how the plain version (and the JAX package's gather reader) dequantizes
// them. The TPU kernel instead scales in score space, s = (q . k_int8) *
// k_scale and acc += (p * v_scale) . v_int8, all in f32: the same numbers
// in f32, and in bf16 they differ by the rounding of K and V to bf16,
// which moves a bf16 output by an ulp (0.0156 at |out| >= 2) where the
// kernel and the plain version must agree to 1e-2.
//
// What bounds it on the H100: reading the K/V rows, 2 * K * D * bytes per
// cached position per sequence (2 * K * (D + 4) with int8 pages), at
// 3.35 TB/s. Decode is that and nothing
// else. A long prefill chunk also does 4 * D f32 operations per (query
// head, visible position), which at 64 query rows per tile is far below
// the tensor cores' rate.
//
// The bf16 instances of the ragged kernel (pages in bf16 or int8) run the
// tensor-core tile routine `attend_mma` (attention_mma.cuh) over the same
// blocks and rows: both products on mma.sync, the pages gathered with a
// double-buffered cp.async pipeline. The f32 instances and the decode
// kernel keep `attend_tile` below. What `attend_tile` leaves on the table,
// for later work:
//   - the products run on CUDA cores in f32, not on tensor cores;
//   - loads are synchronous (load, barrier, compute): no TMA or cp.async
//     pipeline overlaps the next chunk's gather with this chunk's math;
//   - one block per (sequence, kv head) in decode: with B * K blocks a
//     small batch leaves most SMs idle on long contexts, where a split over
//     pages (flash-decoding, the natural form of the TPU grid kernels, as
//     paged_attention_grid.cu does it) would fill them;
//   - prefill tiles of 64 rows each re-read their sequence's K/V (through
//     L2) once per tile.

#include "attention_mma.cuh"

namespace {

using namespace attn;

constexpr int kWarps = 4;                  // warps per block
constexpr int kThreads = kWarps * kWarp;
constexpr int kChunk = kWarp;              // cache positions per pass: one per lane
constexpr int kRaggedRowsPerWarp = 16;     // 64 query rows per prefill tile
constexpr int kDecodeRowsPerWarp = 1;      // G query heads per decode block

template <int D, int RPW>
constexpr int smem_bytes() {
  // q tile [R][D], K chunk [kChunk][D + 1] (padded: lane j reads row j),
  // V chunk [kChunk][D], all f32.
  return (kWarps * RPW * D + kChunk * (D + 1) + kChunk * D) * 4;
}

// One block: sequence rows `q` [S, H, D] (this sequence only), kv head `kh`,
// query rows [tile * R, tile * R + R) of the (s, g) enumeration r = s * G + g.
// Pages hold PT: T itself, or int8 with scale planes k_scale / v_scale.
template <typename T, typename PT, int D, int RPW>
__device__ __forceinline__ void attend_tile(
    const T* __restrict__ q, const PT* __restrict__ k_pages,
    const PT* __restrict__ v_pages, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ table_row,
    T* __restrict__ out, int S, int H, int K, int P, int max_pages, int kh,
    int tile, int start, int qlen, float scale) {
  constexpr bool kInt8 = std::is_same_v<PT, int8_t>;
  constexpr int R = kWarps * RPW;
  constexpr int DPL = (D + kWarp - 1) / kWarp;   // output dims per lane
  constexpr int VEC = 16 / sizeof(T);
  constexpr int VPR = D / VEC;                   // 16-byte vectors per q row
  constexpr int PVEC = 16 / sizeof(PT);
  constexpr int PVPR = D / PVEC;                 // 16-byte vectors per page row
  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + R * D;
  float* v_s = k_s + kChunk * (D + 1);

  const int G = H / K;
  const int tid = threadIdx.x;
  const int lane = tid % kWarp;
  const int warp = tid / kWarp;
  const int cap = max_pages * P;
  const int row0 = tile * R;

  // Positions the tile must read: up to the last valid row's window.
  const int s_first = row0 / G;
  const int s_last = min(min((row0 + R - 1) / G, S - 1), qlen - 1);
  const int tile_limit = s_first <= s_last ? min(start + s_last + 1, cap) : 0;

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
  int lim[RPW];
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    const int s = (row0 + warp * RPW + rr) / G;
    lim[rr] = (s < S && s < qlen) ? min(start + s + 1, cap) : 0;
    m[rr] = -CUDART_INF_F;
    l[rr] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[rr][i] = 0.f;
  }

  for (int c0 = 0; c0 < tile_limit; c0 += kChunk) {
    __syncthreads();  // q tile written / previous chunk consumed
    for (int i = tid; i < kChunk * PVPR; i += kThreads) {
      const int j = i / PVPR, c = (i % PVPR) * PVEC;
      const int t = c0 + j;
      float kv[PVEC], vv[PVEC];
      if (t < tile_limit) {
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

#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    const int gr = row0 + warp * RPW + rr;
    const int s = gr / G, g = gr % G;
    if (s >= S) continue;
    T* o = out + (static_cast<size_t>(s) * H + kh * G + g) * D;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + i * kWarp;
      if (d < D) store(o + d, l[rr] > 0.f ? acc[rr][i] / l[rr] : 0.f);
    }
  }
}

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
    attend_tile<T, PT, D, RPW>(q + seq, k_pages, v_pages, k_scale, v_scale, table_row,
                               out + seq, S, H, K, P, max_pages, blockIdx.y, blockIdx.x,
                               start[b], q_lens[b], scale);
  }
}

template <typename T, typename PT, int D, int RPW>
__global__ void __launch_bounds__(kThreads) decode_kernel(
    const T* __restrict__ q, const PT* __restrict__ k_pages,
    const PT* __restrict__ v_pages, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ table,
    const int* __restrict__ lengths, T* __restrict__ out, int H, int K, int P,
    int max_pages, float scale) {
  const int b = blockIdx.z;
  const int len = lengths[b];
  const size_t seq = static_cast<size_t>(b) * H * D;
  // One query at position len - 1: it sees t < len.
  attend_tile<T, PT, D, RPW>(q + seq, k_pages, v_pages, k_scale, v_scale,
                         table + static_cast<size_t>(b) * max_pages, out + seq,
                         1, H, K, P, max_pages, blockIdx.y, blockIdx.x,
                         max(len - 1, 0), len > 0 ? 1 : 0, scale);
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
  constexpr int RPW = kRaggedRowsPerWarp;
  static_assert(kWarps * RPW == kMmaRows && kThreads == kMmaThreads,
                "both bodies tile the rows alike");
  constexpr int bytes = std::is_same_v<T, __nv_bfloat16> ? mma_smem_bytes<PT, D>()
                                                         : smem_bytes<D, RPW>();
  auto kernel = ragged_kernel<T, PT, D, RPW>;
  const cudaError_t err = prepare(kernel, bytes);
  if (err != cudaSuccess) return err;
  const int rows = S * (a.H / a.K);
  const dim3 grid((rows + kWarps * RPW - 1) / (kWarps * RPW), a.K, a.B);
  kernel<<<grid, kThreads, bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const PT*>(a.k), static_cast<const PT*>(a.v),
      a.k_scale, a.v_scale, a.table, start, q_lens, static_cast<T*>(a.out), S, a.H, a.K,
      a.P, a.max_pages, a.scale);
  return cudaGetLastError();
}

template <typename T, typename PT, int D>
cudaError_t launch_decode(const Args& a, const int* lengths) {
  constexpr int RPW = kDecodeRowsPerWarp;
  constexpr int bytes = smem_bytes<D, RPW>();
  auto kernel = decode_kernel<T, PT, D, RPW>;
  const cudaError_t err = prepare(kernel, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.H / a.K + kWarps * RPW - 1) / (kWarps * RPW), a.K, a.B);
  kernel<<<grid, kThreads, bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const PT*>(a.k), static_cast<const PT*>(a.v),
      a.k_scale, a.v_scale, a.table, lengths, static_cast<T*>(a.out), a.H, a.K, a.P,
      a.max_pages, a.scale);
  return cudaGetLastError();
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

// Plain C interface, bound with ctypes. Every call launches on `stream`, does
// not synchronise, and returns cudaGetLastError() (0 = launched). `dtype` is
// q's (0 = f32, 1 = bf16); pages are in q's dtype when `k_scale` and
// `v_scale` are null, else int8 with those f32 scale planes [N, P, K].
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
  return dispatch(dtype, D, k_scale != nullptr, Ragged{a, st, ql, S});
}

extern "C" int opsagent_paged_decode_attention(
    const void* q, const void* k_pages, const void* v_pages, const void* k_scale,
    const void* v_scale, const void* table, const void* lengths, void* out, int B, int H,
    int K, int D, int P, int max_pages, float scale, int dtype, void* stream) {
  if (B == 0) return cudaSuccess;
  const Args a{q, k_pages, v_pages, static_cast<const float*>(k_scale),
               static_cast<const float*>(v_scale), static_cast<const int*>(table), out,
               B, H, K, P, max_pages, scale, static_cast<cudaStream_t>(stream)};
  const auto* ln = static_cast<const int*>(lengths);
  return dispatch(dtype, D, k_scale != nullptr, Decode{a, ln});
}
