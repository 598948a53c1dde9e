// The MLA latent instances of the dma paged-attention kernels (the
// *_latent entry points of paged_attention.cu), for NVIDIA Hopper (sm_90a).
//
// What they replace. Multi-head latent attention (DeepSeek-V2/V3) caches
// one latent per token, [kv_lora_rank 512 | rope key 64] = 576 columns, and
// attends in the weight-absorbed form: the JAX model calls
// paged_ragged_attention and paged_decode_attention
// (opsagent_tpu/ops/attention.py) with `kc, kc`, and on the TPU their
// Pallas dma kernels (paged_*_attention_pallas_dma) compute it. So the
// function is paged attention at K = 1, D = 576, with one page array read
// as both keys and values, scale D^-1/2, all 576 output columns written,
// and rows with no visible position written as zeros.
//
// What bounds it on the H100. Ragged (a prefill chunk beside decode rows):
// the products, 4 * 576 operations per (query row, visible position), at
// the bf16 tensor-core rate. Decode at 16 heads: the latent rows, 1152
// bytes per cached position, read once at 3.35 TB/s. Two things stand in
// the way: a latent row is 1152 bytes that every query row of a sequence
// needs, and a tile's output row is 576 f32 accumulators, which no single
// warp can keep in registers.
//
// bf16: one kernel body serves both functions (decode is the ragged form at
// S = 1 whose rows all see `lengths[b]` positions).
//
//   - Tiles. A tile is 64 consecutive (s, h) query rows of one sequence (r
//     = s * H + h): 4 query positions at V2-Lite's H = 16, 64 heads of one
//     position at V3's 128; each row keeps its own causal limit. A gathered
//     latent row serves 64 query rows. Decode at
//     H = 16 fills 16 of the 64 rows; the other 48 cost tensor-core time
//     that a memory-bound call has to spare.
//   - Plan (attention_plan.cuh): the call's tiles on one axis, each
//     costing its visible positions plus a fixed cost, cut into equal runs
//     of a fixed grid (one block an SM, from the host's shapes); every
//     block finds its run on the device. A tile cut between blocks leaves
//     partials (max, sum, 576 accumulators of each row), and the merge
//     kernel reduces each cut tile once (grid: blocks x 9 column blocks):
//     at most 2 * blocks tiles of 64 * 578 floats.
//   - Block. 384 threads: two consumer warpgroups and one producer
//     warpgroup (setmaxnreg moves registers to the consumers: 224 a thread
//     there, 56 in the producer). The producer walks the same units, loads
//     each tile's q (64 x 576 bf16, 72 KB) once, then gathers the latent
//     rows through the page table (slots looked up a stage ahead, one lane
//     a position) into a ring of kLatRing stages of kLatStage positions
//     (36 KB each) with 16-byte cp.async copies; positions past the piece
//     are zero-filled. Each stage's landing is signalled on an mbarrier by
//     cp.async.mbarrier.arrive; consumers release a stage (and q, after the
//     unit's last scores) on others. No block-wide barrier runs after the
//     plan.
//   - Consumers. Each warpgroup computes half of the stage's scores S = Q
//     L^T (18 of the 36 k-steps, wgmma m64n32k16, Q and L in shared memory,
//     K-major); the halves are swapped through shared memory and added, so
//     both hold the same scores (a + b == b + a). Then the online softmax
//     in f32 (base 2, each row across the four lanes that hold it; the
//     accumulators are rescaled only when a warp's max moved), and O += P L
//     for its own columns, with P from registers (the score accumulators
//     re-packed as A fragments, hi + lo bf16 halves as in
//     attention_mma.cuh: one bf16 P misses the 1e-2 tolerance) and the same
//     L tile read MN-major (transposed B): warpgroup 0 columns [0, 320) on
//     m64n256k16 + m64n64k16, 160 f32 accumulators a thread, warpgroup 1
//     columns [320, 576) on m64n256k16. The 576 columns split at 64-column
//     blocks because an MN-major operand starts on a swizzle atom.
//     Splitting the columns over two warpgroups is how DeepSeek's FlashMLA
//     divides the same latent on Hopper. Everything that steers a loop is
//     warp-uniform (broadcast from lane 0), and rows past a tile's end are
//     stored under predicates: a lane-dependent branch in this function
//     makes ptxas serialize every wgmma chain in it.
//   - Shared memory, 1024-byte aligned, every tile in the 128-byte swizzled
//     layout wgmma reads: a tile of R rows is 9 column blocks of [R][64]
//     bf16, 16-byte chunk c of row r at c ^ (r % 8). q 73,728 bytes, the
//     ring 3 x 36,864, the score halves 2 x 2 x 8,192, barriers and plan
//     scratch: 218.3 KB, one block an SM.
//   - What still bounds it (measured by ablation on the H100, PERF.md):
//     a stage is a chain of dependent steps (wait, 18 wgmma, swap, softmax,
//     8 wgmma) that the two warpgroups run in step, about 2 us at the timed
//     ragged shape against 0.2 us of pipeline overhead, and the gather is
//     not fully hidden behind it; every tile the plan gives a block costs
//     its q load and output store (kPlanCost); the merge is a second launch.
//
// f32 (on no served path): PR 15's CUDA-core body, one block per (tile of
// 16 rows, sequence) or (tile, split, sequence) with the decode's splits
// chosen by the host and reduced by combine_kernel<float, 576>.

#pragma once

#include "attention_plan.cuh"
#include "attention_split.cuh"

namespace attn {

constexpr int kLatentDim = 576;

// -- f32: CUDA cores ----------------------------------------------------------

constexpr int kLatentRows = 16;     // query rows of an f32 tile
constexpr int kLatentChunk = 32;    // cache positions of an f32 stage: one a lane

// Latents [C][D + 1], q [16][D], scores and then P [16][C], the stage's
// rows [C] int32 and the rows' max, sum and rescale [3][16], all f32.
constexpr int latent_f32_smem_bytes() {
  constexpr int C = kLatentChunk, D = kLatentDim, R = kLatentRows;
  return C * (D + 1) * 4 + R * D * 4 + R * C * 4 + C * 4 + 3 * R * 4;
}

// One block of kThreads threads over a tile of up to 16 query rows: row r
// is q[(row0 + r) * D ...], real for r < rows, and sees the positions t in
// [t_begin, min(lim_s[r], t_end)) (lim_s in shared memory, written before
// the call). Normalised rows go to out[(row0 + r) * D ...] when `out` is
// not null; otherwise partials at workspace row split * part.rows +
// row_base + row0 + r.
__device__ __forceinline__ void attend_latent_f32(
    const float* __restrict__ q, const float* __restrict__ pages,
    const int* __restrict__ table_row, int P, int row0, int rows, const int* lim_s, int t_begin,
    int t_end, float* __restrict__ out, const Partials& part, int split, int row_base,
    float scale) {
  constexpr int D = kLatentDim, R = kLatentRows, C = kLatentChunk;
  constexpr int CPT = (D + kThreads - 1) / kThreads;  // a thread's columns
  static_assert(kThreads == R * 8, "eight threads a row in the softmax");
  static_assert(C == kWarp, "one position a lane");

  const int tid = threadIdx.x;
  const int lane = tid % kWarp;
  const int warp = tid / kWarp;

  if (t_begin >= t_end) {
    // Nothing of the range is visible: a normalised output is zeros;
    // partials are not read.
    if (out != nullptr) {
      for (int i = tid; i < rows * D; i += kThreads) out[static_cast<size_t>(row0) * D + i] = 0.f;
    }
    return;
  }

  extern __shared__ __align__(16) unsigned char latent_smem[];
  float* lat = reinterpret_cast<float*>(latent_smem);
  float* q_s = lat + C * (D + 1);
  float* s_s = q_s + R * D;
  int* rows_s = reinterpret_cast<int*>(s_s + R * C);
  float* m_s = reinterpret_cast<float*>(rows_s + C);
  float* l_s = m_s + R;
  float* a_s = l_s + R;

  // The q tile, rows past `rows` zero.
  const float* q0 = q + static_cast<size_t>(row0) * D;
  for (int i = tid; i < R * (D / 4); i += kThreads) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    if (r < rows) load_vec<float, 4>(q0 + static_cast<size_t>(r) * D + c, v);
#pragma unroll
    for (int e = 0; e < 4; ++e) q_s[r * D + c + e] = v[e];
  }
  if (tid < R) {
    m_s[tid] = -CUDART_INF_F;
    l_s[tid] = 0.f;
  }
  const float sl = scale * kLog2e;

  float acc[R][CPT];
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int i = 0; i < CPT; ++i) acc[r][i] = 0.f;
  }

  for (int c0 = t_begin; c0 < t_end; c0 += C) {
    __syncthreads();  // the previous stage's latents and P consumed
    if (tid < C) {
      const int t = c0 + tid;
      rows_s[tid] = t < t_end ? max(__ldg(table_row + t / P), 0) * P + t % P : -1;
    }
    __syncthreads();
    // The stage's latent rows, once: they are both K and V.
    for (int i = tid; i < C * (D / 4); i += kThreads) {
      const int j = i / (D / 4), c = (i % (D / 4)) * 4;
      const int row = rows_s[j];
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (row >= 0) load_vec<float, 4>(pages + static_cast<size_t>(row) * D + c, v);
#pragma unroll
      for (int e = 0; e < 4; ++e) lat[j * (D + 1) + c + e] = v[e];
    }
    __syncthreads();

    // Scores, masked per row, in base-2 units: lane j takes position j
    // against four rows a warp.
    {
      const int t = c0 + lane;
      const float* kr = lat + lane * (D + 1);
#pragma unroll
      for (int rr = 0; rr < R / kWarps; ++rr) {
        const int r = warp * (R / kWarps) + rr;
        const float* qr = q_s + r * D;
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
#pragma unroll
      for (int e = 0; e < PER; ++e) s_s[r * C + sub * PER + e] = v[e];
      if (sub == 0) {   // after the shuffles: every lane of the row has read m_s[r]
        m_s[r] = m_new;
        l_s[r] = l_s[r] * alpha + sum;
        a_s[r] = alpha;
      }
    }
    __syncthreads();

    // O = O * alpha + P L: thread i owns columns i, i + 128, ... of all rows.
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float al = a_s[r];
#pragma unroll
      for (int i = 0; i < CPT; ++i) acc[r][i] *= al;
    }
    for (int j = 0; j < C; ++j) {
      const float* lr = lat + j * (D + 1);
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
  __syncthreads();  // the last stage's max and sum written

  // Output: normalised rows, or partials.
  for (int r = 0; r < rows; ++r) {
    const float l = l_s[r];
    const size_t row = static_cast<size_t>(row0) + r;
    const size_t pr = static_cast<size_t>(split) * part.rows + row_base + row;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int c = tid + i * kThreads;
      if (c >= D) break;
      if (out != nullptr) {
        out[row * D + c] = l > 0.f ? acc[r][i] / l : 0.f;
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

// Ragged rows: one block per (tile of 16 (s, h) rows, sequence). With one
// kv head the (s, h) enumeration is the row index s * H + h itself. Query
// s sees t <= start + s and t < start + q_len, clamped to MaxP * P.
__global__ void __launch_bounds__(kThreads) latent_ragged_kernel(
    const float* __restrict__ q, const float* __restrict__ pages, const int* __restrict__ table,
    const int* __restrict__ start, const int* __restrict__ q_lens, float* __restrict__ out,
    int S, int H, int P, int max_pages, float scale) {
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
  attend_latent_f32(q + seq, pages, table + static_cast<size_t>(b) * max_pages, P, first, rows,
                    lim_s, 0, t_end, out + seq, Partials{nullptr, nullptr, 0, cap, 1}, 0, 0,
                    scale);
}

// Decode: one block per (tile of 16 heads, split, sequence); the query
// sees t < lengths[b], clamped to MaxP * P, of its split's positions.
__global__ void __launch_bounds__(kThreads) latent_decode_kernel(
    const float* __restrict__ q, const float* __restrict__ pages, const int* __restrict__ table,
    const int* __restrict__ lengths, Partials part, float* __restrict__ out, int H, int P,
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
  float* seq_out = part.splits == 1 ? out + seq * kLatentDim : nullptr;
  attend_latent_f32(q + seq * kLatentDim, pages, table + static_cast<size_t>(b) * max_pages, P,
                    first, rows, lim_s, t_begin, t_end, seq_out, part, split,
                    static_cast<int>(seq), scale);
}

// -- bf16: warpgroups -----------------------------------------------------------
// ops/paged_attention.py sizes the workspace (latent_workspace_bytes).

constexpr int kLatTile = kPlanTile;   // query rows of a tile: wgmma's m64
constexpr int kLatStage = 32;         // cache positions of a ring stage
constexpr int kLatRing = 3;           // stages in the ring
constexpr int kLatThreads = 384;      // consumer warpgroups 0 and 1, producer warpgroup 2
constexpr int kLatProducerRegs = 56;  // setmaxnreg: 128 * 56 + 256 * 224 = 384 * 168
constexpr int kLatConsumerRegs = 224;
constexpr int kLatSplitCols = 320;    // warpgroup 0's columns; warpgroup 1 the rest
constexpr int kLatSwap = 1;           // named barrier: both warpgroups' score halves written
constexpr int kLatChunks = kLatentDim / 8;                   // 16-byte chunks of a row
constexpr int kLatQBytes = kLatTile * kLatentDim * 2;        // 73,728
constexpr int kLatStageBytes = kLatStage * kLatentDim * 2;   // 36,864
constexpr int kLatSwapBytes = 2 * 2 * kLatTile * kLatStage * 4;   // [parity][warpgroup] halves
constexpr int kLatSmemBytes = 1024 + kLatQBytes + kLatRing * kLatStageBytes + kLatSwapBytes +
                              (2 * kLatRing + 2) * 8 + 16 * 8;
static_assert(kLatSmemBytes <= 232448, "one block an SM");
static_assert(kLatStage == 32 && kLatSplitCols % 64 == 0, "wgmma tiles: m64n32k16 scores");

// A call's shapes, the plan's job (attention_plan.cuh). Ragged: `start`
// and `q_lens`; decode: `start` holds lengths and q_lens is null (S = 1).
// Tile `item` is tile item % tiles of sequence item / tiles, rows r = s * H
// + h.
struct LatentJob {
  const int* start;
  const int* q_lens;
  int S, H;
  int tiles;   // tiles of a sequence: cdiv(S * H, 64)
  int items;   // B * tiles
  int cap;     // MaxP * P

  // The positions the rows of tile `item` see: up to its last real, valid
  // row's window.
  __device__ __forceinline__ int len(int item) const {
    const int b = item / tiles, first = (item % tiles) * kLatTile;
    if (q_lens == nullptr) return min(max(__ldg(start + b), 0), cap);
    const int n = min(kLatTile, S * H - first);
    const int s_last = min((first + n - 1) / H, __ldg(q_lens + b) - 1);
    return s_last >= first / H ? min(__ldg(start + b) + s_last + 1, cap) : 0;
  }
  __device__ __forceinline__ int rows(int item) const {
    return min(kLatTile, S * H - (item % tiles) * kLatTile);
  }
  __device__ __forceinline__ size_t out_row(int item, int r) const {
    return static_cast<size_t>(item / tiles) * S * H + (item % tiles) * kLatTile + r;
  }
};

// The producer warpgroup: each unit's q tile, then its latent rows into
// the ring; warp w copies rows w, w + 4, ... of q and positions [8w, 8w +
// 8) of each stage, every lane arriving on the stage's barrier.
__device__ __forceinline__ void latent_produce(
    const bf16* __restrict__ q, const bf16* __restrict__ pages, const int* __restrict__ table,
    const LatentJob& job, const PlanRun& run, int P, int max_pages, unsigned char* q_s,
    unsigned char* ring, uint64_t* full, uint64_t* empty, uint64_t* q_full, uint64_t* q_empty,
    int4* tasks) {
  constexpr int PW = kLatStage / 4;   // positions of a stage a warp copies
  const int lane = threadIdx.x % kWarp, w = (threadIdx.x / kWarp) % 4;
  int item = run.item, it = 0, qn = 0;
  long long pre = run.pre;
  PlanUnit u;
  int4 task = make_int4(-1, 0, 0, 1);   // the merge's: a cut tile that starts in the run
  while (plan_next(job, run, blockIdx.x, item, pre, u)) {
    if (u.cut && u.pre >= run.begin) {
      task = make_int4(u.item, static_cast<int>(u.pre - run.begin), u.len,
                       static_cast<int>(run.per));
    }
    if (u.lo >= u.hi) continue;   // an empty tile: zeros, no loads
    const int b = u.item / job.tiles, first = (u.item % job.tiles) * kLatTile;
    const int rows = min(kLatTile, job.S * job.H - first);
    // q's rows past `rows` are not loaded: their outputs are not written.
    mbar_wait(q_empty, (qn & 1) ^ 1);
    const bf16* q0 = q + (static_cast<size_t>(b) * job.S * job.H + first) * kLatentDim;
    for (int r = w; r < rows; r += 4) {
      for (int c = lane; c < kLatChunks; c += kWarp) {
        cp_async16(q_s + swz128(kLatTile, r, c), q0 + static_cast<size_t>(r) * kLatentDim + c * 8,
                   true);
      }
    }
    cp_async_mbar_arrive(q_full);
    ++qn;
    const int* trow = table + static_cast<size_t>(b) * max_pages;
    const int hi = u.hi;
    auto row_of = [&](int t) { return t < hi ? max(__ldg(trow + t / P), 0) * P + t % P : -1; };
    const int mine = PW * w + lane % PW;   // the position this lane looks up
    int next = row_of(u.lo + mine);
    for (int c0 = u.lo; c0 < hi; c0 += kLatStage, ++it) {
      const int s = it % kLatRing;
      const int cur = next;
      if (c0 + kLatStage < hi) next = row_of(c0 + kLatStage + mine);   // a stage ahead
      mbar_wait(empty + s, ((it / kLatRing) & 1) ^ 1);
      unsigned char* dst = ring + s * kLatStageBytes;
#pragma unroll 2
      for (int p = PW * w, i = 0; i < PW; ++p, ++i) {
        const int row = __shfl_sync(kFull, cur, i);
        const bf16* src = pages + static_cast<size_t>(max(row, 0)) * kLatentDim;
        for (int c = lane; c < kLatChunks; c += kWarp) {
          cp_async16(dst + swz128(kLatStage, p, c), src + c * 8, row >= 0);
        }
      }
      cp_async_mbar_arrive(full + s);
    }
  }
  if (threadIdx.x == 256) tasks[blockIdx.x] = task;
  cp_async_wait<0>();
}

// A consumer warpgroup: columns [64 * CB0, 64 * (CB0 + NB)) of every unit.
template <int NB, int CB0, bool kDecode>
__device__ __forceinline__ void latent_consume(
    const LatentJob& job, const PlanRun& run, float* __restrict__ ws, bf16* __restrict__ out,
    const unsigned char* q_s, const unsigned char* ring, float* swap, uint64_t* full,
    uint64_t* empty, uint64_t* q_full, uint64_t* q_empty, float scale) {
  constexpr int NO = NB * 32;            // accumulators a thread: 64 rows x 64 NB columns / 128
  constexpr int C = kLatStage;
  constexpr int NS = C / 2;              // score accumulators a thread
  constexpr int KS = kLatentDim / 16;    // k-steps of the scores
  static_assert(NB == 4 || NB == 5, "n256, and n64 for a fifth column block");
  constexpr int CW = CB0 == 0 ? 0 : 1;   // this warpgroup
  const int lane = threadIdx.x % kWarp, wt = threadIdx.x % 128;
  const int r0 = 16 * (wt / kWarp) + lane / 4;   // rows r0 and r0 + 8
  const float sl = scale * kLog2e;
  const uint32_t q_addr = smem_u32(q_s), ring_addr = smem_u32(ring);
  float* ml = ws + 2 * static_cast<size_t>(gridDim.x) * kLatTile * kLatentDim;
  int item = run.item, it = 0, qn = 0;
  long long pre = run.pre;
  PlanUnit u;
  float o[NO];
  // Everything that steers the loops is broadcast from lane 0, so that
  // the compiler sees it warp-uniform and keeps the wgmma chains whole.
  while (__shfl_sync(kFull, plan_next(job, run, blockIdx.x, item, pre, u), 0)) {
    u.lo = __shfl_sync(kFull, u.lo, 0);
    u.hi = __shfl_sync(kFull, u.hi, 0);
    u.cut = __shfl_sync(kFull, u.cut, 0);
    u.len = __shfl_sync(kFull, u.len, 0);
    const int b = u.item / job.tiles, first = (u.item % job.tiles) * kLatTile;
    const int rows = min(kLatTile, job.S * job.H - first);
    const int st = __ldg(job.start + b), ql = kDecode ? 0 : __ldg(job.q_lens + b);
    int lim[2];   // each row's visible positions, within the piece
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + 8 * i, s = (first + r) / job.H;
      const int seen = kDecode ? u.len : (s < ql ? min(st + s + 1, job.cap) : 0);
      lim[i] = min(r < rows ? seen : 0, u.hi);
    }
    float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int k = 0; k < NO; ++k) o[k] = 0.f;
    if (u.lo < u.hi) mbar_wait(q_full, qn++ & 1);
    for (int c0 = u.lo; c0 < u.hi; c0 += C, ++it) {
      const int s = it % kLatRing;
      const uint32_t st = ring_addr + s * kLatStageBytes;
      mbar_wait(full + s, (it / kLatRing) & 1);
      fence_proxy_async();

      // S = Q L^T, K-major both: this warpgroup takes half of the 576
      // columns (18 k-steps), the halves are swapped through shared memory
      // and added, so both hold the same scores (a + b == b + a) for half
      // the products and half the length of a wgmma chain.
      float sc[NS];
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < KS / 2; ++ks) {
        const int kg = CW * (KS / 2) + ks;
        const uint32_t qa = q_addr + (kg >> 2) * (kLatTile * 128) + (kg & 3) * 32;
        const uint32_t ka = st + (kg >> 2) * (C * 128) + (kg & 3) * 32;
        wgmma_ss_n32(sc, wgmma_desc(qa, 16, 1024), wgmma_desc(ka, 16, 1024), ks > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int k = 0; k < NS; ++k) fence_operand(sc[k]);
      __syncwarp();
      if (c0 + C >= u.hi) mbar_arrive_lane0(q_empty);   // the unit's last read of q
      float* half = swap + (it & 1) * (2 * NS * 128);  // [parity][warpgroup][k][128 threads]
#pragma unroll
      for (int k = 0; k < NS; ++k) half[(CW * NS + k) * 128 + wt] = sc[k];
      named_sync(kLatSwap, 256);
#pragma unroll
      for (int k = 0; k < NS; ++k) sc[k] += half[((1 - CW) * NS + k) * 128 + wt];

      // Masked scores in base-2 units; the online softmax of rows r0, r0 + 8
      // over the four lanes that hold each.
      float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
      for (int k = 0; k < NS; ++k) {
        const int i = (k >> 1) & 1;
        const int t = c0 + 8 * (k >> 2) + 2 * (lane & 3) + (k & 1);
        sc[k] = t < lim[i] ? sc[k] * sl : -CUDART_INF_F;
        mx[i] = fmaxf(mx[i], sc[k]);
      }
      float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 2));
        const float mn = fmaxf(m[i], mx[i]);
        alpha[i] = mn == -CUDART_INF_F ? 1.f : fast_exp2(m[i] - mn);
        m[i] = mn;
      }
#pragma unroll
      for (int k = 0; k < NS; ++k) {
        const int i = (k >> 1) & 1;
        sc[k] = m[i] == -CUDART_INF_F ? 0.f : fast_exp2(sc[k] - m[i]);
        sum[i] += sc[k];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        sum[i] += __shfl_xor_sync(kFull, sum[i], 1);
        sum[i] += __shfl_xor_sync(kFull, sum[i], 2);
        l[i] = l[i] * alpha[i] + sum[i];
      }
      // Once a row's max settles, alpha is 1: skip the rescale when it is
      // for the whole warp (a warp-uniform branch).
      if (!__all_sync(kFull, alpha[0] == 1.f && alpha[1] == 1.f)) {
#pragma unroll
        for (int k = 0; k < NO; ++k) o[k] *= alpha[(k >> 1) & 1];
      }

      // P as A fragments (hi + lo), O += P L with L MN-major.
      uint32_t ph[C / 16][4], pl[C / 16][4];
#pragma unroll
      for (int kk = 0; kk < C / 16; ++kk) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          split_bf16(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1], ph[kk][e], pl[kk][e]);
        }
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < C / 16; ++kk) {
        const uint32_t va = st + CB0 * (C * 128) + kk * 16 * 128;
        const uint64_t vd = wgmma_desc(va, C * 128, 1024);
        wgmma_rs_n256(o, ph[kk], vd);
        wgmma_rs_n256(o, pl[kk], vd);
        if constexpr (NB == 5) {
          const uint64_t vd4 = wgmma_desc(va + 4 * (C * 128), C * 128, 1024);
          wgmma_rs_n64(o + 128, ph[kk], vd4);
          wgmma_rs_n64(o + 128, pl[kk], vd4);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int k = 0; k < NO; ++k) fence_operand(o[k]);
#pragma unroll
      for (int kk = 0; kk < C / 16; ++kk) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          fence_operand(ph[kk][e]);
          fence_operand(pl[kk][e]);
        }
      }
      __syncwarp();
      mbar_arrive_lane0(empty + s);
    }

    // The rows: normalised, or the partials of a cut tile. A warp with no
    // row of the tile skips; rows past the tile's end are predicated off
    // store by store (a lane-dependent branch here would make ptxas
    // serialize the wgmma chains above).
    const size_t seq_row = static_cast<size_t>(b) * job.S * job.H + first;
    const int j = lane & 3;
    if (u.len == 0) {
      // An empty tile: zeros, row-major, 16 bytes a thread.
      constexpr int CH = NO / 4;   // this warpgroup's 16-byte chunks of a row
#pragma unroll 4
      for (int k = threadIdx.x % 128; k < kLatTile * CH; k += 128) {
        const int r = k / CH;
        st_if(out + (seq_row + r) * kLatentDim + CB0 * 64 + 8 * (k % CH), make_uint4(0, 0, 0, 0),
              r < rows);
      }
    } else if (__any_sync(kFull, r0 < rows)) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = r0 + 8 * i;
        const bool real = r < rows;
        if (u.cut) {
          const size_t pr = static_cast<size_t>(u.slot) * kLatTile + r;
          float* acc = ws + pr * kLatentDim + CB0 * 64;
#pragma unroll
          for (int g = 0; g < NO / 16; ++g) {
            float2 w[4];
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              w[k] = make_float2(o[16 * g + 4 * k + 2 * i], o[16 * g + 4 * k + 2 * i + 1]);
            }
#pragma unroll
            for (int k = 0; k < 4; ++k) st_if(acc + 8 * (4 * g + k) + 2 * j, w[k].x, w[k].y, real);
          }
          // The row's four lanes write the same (max, sum).
          if constexpr (CB0 == 0) st_if(ml + 2 * pr, m[i], l[i], real);
        } else {
          const float inv = l[i] > 0.f ? __fdividef(1.f, l[i]) : 0.f;
          bf16* dst = out + (seq_row + r) * kLatentDim + CB0 * 64;
#pragma unroll
          for (int g = 0; g < NO / 16; ++g) {
            uint32_t w[4];
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              w[k] = pack_bf16(o[16 * g + 4 * k + 2 * i] * inv,
                               o[16 * g + 4 * k + 2 * i + 1] * inv);
            }
#pragma unroll
            for (int k = 0; k < 4; ++k) st_if(dst + 8 * (4 * g + k) + 2 * j, w[k], real);
          }
        }
      }
    }
  }
}

template <bool kDecode>
__device__ __forceinline__ void latent_wg(const bf16* __restrict__ q,
                                          const bf16* __restrict__ pages,
                                          const int* __restrict__ table, const LatentJob& job,
                                          float* __restrict__ ws, bf16* __restrict__ out, int P,
                                          int max_pages, float scale) {
  extern __shared__ __align__(16) unsigned char lat_raw[];
  unsigned char* q_s = lat_raw + ((1024 - (smem_u32(lat_raw) & 1023)) & 1023);
  unsigned char* ring = q_s + kLatQBytes;
  float* swap = reinterpret_cast<float*>(ring + kLatRing * kLatStageBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kLatRing * kLatStageBytes + kLatSwapBytes);
  uint64_t* empty = full + kLatRing;
  uint64_t* q_full = empty + kLatRing;
  uint64_t* q_empty = q_full + 1;
  long long* red = reinterpret_cast<long long*>(q_empty + 1);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kLatRing; ++s) {
      mbar_init(full + s, 128);     // the producer's threads, as their copies land
      mbar_init(empty + s, 8);      // the consumers' warps
    }
    mbar_init(q_full, 128);
    mbar_init(q_empty, 8);
    mbar_init_fence();
  }
  __syncthreads();
  const PlanRun run = plan_run<LatentJob, kLatThreads>(job, blockIdx.x, gridDim.x, red);
  if (__shfl_sync(kFull, run.item, 0) < 0) {
    if (threadIdx.x == 0) {
      plan_tasks<kLatentDim>(ws, gridDim.x)[blockIdx.x] = make_int4(-1, 0, 0, 1);
    }
    return;
  }
  const int wg = __shfl_sync(kFull, threadIdx.x / 128, 0);   // warp-uniform
  if (wg == 2) {
    setmaxnreg_dec<kLatProducerRegs>();
    latent_produce(q, pages, table, job, run, P, max_pages, q_s, ring, full, empty, q_full,
                   q_empty, plan_tasks<kLatentDim>(ws, gridDim.x));
  } else if (wg == 0) {
    setmaxnreg_inc<kLatConsumerRegs>();
    latent_consume<kLatSplitCols / 64, 0, kDecode>(job, run, ws, out, q_s, ring, swap, full,
                                                   empty, q_full, q_empty, scale);
  } else {
    setmaxnreg_inc<kLatConsumerRegs>();
    latent_consume<(kLatentDim - kLatSplitCols) / 64, kLatSplitCols / 64, kDecode>(
        job, run, ws, out, q_s, ring, swap, full, empty, q_full, q_empty, scale);
  }
}

// Two names for each kernel, so a profile tells the ragged call from the
// decode call.
__global__ void __launch_bounds__(kLatThreads, 1) latent_ragged_wg_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ pages, const int* __restrict__ table,
    LatentJob job, float* __restrict__ ws, bf16* __restrict__ out, int P, int max_pages,
    float scale) {
  latent_wg<false>(q, pages, table, job, ws, out, P, max_pages, scale);
}

__global__ void __launch_bounds__(kLatThreads, 1) latent_decode_wg_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ pages, const int* __restrict__ table,
    LatentJob job, float* __restrict__ ws, bf16* __restrict__ out, int P, int max_pages,
    float scale) {
  latent_wg<true>(q, pages, table, job, ws, out, P, max_pages, scale);
}

__global__ void __launch_bounds__(kPlanMergeThreads) latent_ragged_merge_kernel(
    float* __restrict__ ws, bf16* __restrict__ out, LatentJob job, int blocks) {
  plan_merge<kLatentDim>(ws, out, job, blocks);
}

__global__ void __launch_bounds__(kPlanMergeThreads) latent_decode_merge_kernel(
    float* __restrict__ ws, bf16* __restrict__ out, LatentJob job, int blocks) {
  plan_merge<kLatentDim>(ws, out, job, blocks);
}

// Both passes of a bf16 call over `blocks` blocks; `ws` holds 2 * blocks *
// 64 * 578 + 4 * blocks floats. Decode: `start` holds lengths, q_lens is
// null, S = 1.
template <bool kDecode>
cudaError_t launch_latent_wg(const void* q, const void* pages, const int* table,
                             const int* start, const int* q_lens, float* ws, void* out, int B,
                             int S, int H, int P, int max_pages, int blocks, float scale,
                             cudaStream_t stream) {
  auto kernel = kDecode ? latent_decode_wg_kernel : latent_ragged_wg_kernel;
  auto merge = kDecode ? latent_decode_merge_kernel : latent_ragged_merge_kernel;
  static const cudaError_t prepared = prepare(kernel, kLatSmemBytes);  // once per instance
  if (prepared != cudaSuccess) return prepared;
  const int tiles = (S * H + kLatTile - 1) / kLatTile;
  const LatentJob job{start, q_lens, S, H, tiles, B * tiles, max_pages * P};
  kernel<<<blocks, kLatThreads, kLatSmemBytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(pages), table, job, ws,
      static_cast<bf16*>(out), P, max_pages, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  merge<<<dim3(blocks, kLatentDim / 64), kPlanMergeThreads, 0, stream>>>(
      ws, static_cast<bf16*>(out), job, blocks);
  return cudaGetLastError();
}

}  // namespace attn
