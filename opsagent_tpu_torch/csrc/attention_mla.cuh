// The materialized-MLA ragged kernel in bf16 (the bf16 instance of
// opsagent_paged_ragged_attention at head dim 192 in paged_attention.cu's
// dma form), for NVIDIA Hopper (sm_90a).
//
// What it replaces. DeepSeek-V2/V3 with a materialized cache (MLAConfig
// latent_cache off) caches per-head k and v of the qk head dim 192 (128 +
// 64 rope; v zero past v_head_dim 128, as the model pads it), a kv head per
// query head, and the JAX model calls paged_ragged_attention on it, whose
// Pallas dma kernel (paged_ragged_attention_pallas_dma,
// opsagent_tpu/ops/paged_attention_pallas.py, body _kernel_ragged_dma)
// computes it on the TPU. The contract is that kernel's: q [B, S, H, 192],
// pages [N, P, K, 192] in q's dtype, a -1 page-table slot read as page 0,
// query s of row b sees t <= start[b] + s and t < start[b] + q_lens[b]
// (clamped to MaxP * P), an f32 online softmax, the output in bf16, and
// rows with no visible position written as exact zeros.
//
// What bounds it on the H100: the K/V rows each sequence can see, 768 bytes
// per (position, kv head), read once at 3.35 TB/s; at a long prefill chunk
// the products, 4 * 192 operations per (query row, visible position), at
// the bf16 tensor-core rate. The tensor-core tile routine attend_mma
// (attention_mma.cuh) gave each (sequence, kv head, 64-row tile) one block
// that walked its whole context: at G = H / K = 1 a tile holds 64
// positions of one head, so the blocks of the longest row walked up to
// 4096 positions alone while most finished within a few chunks, and the
// body spilled at 255 registers (PERF.md's kernel table).
//
// Design, after the latent kernels (attention_latent.cuh):
//
//   - Tiles and plan. A tile is 64 consecutive query rows of one (sequence,
//     kv head), rows r = s * G + g; tile `item` = ((b * K) + kh) * tiles +
//     tile. The split-KV plan of attention_plan.cuh lays the call's tiles
//     on one axis and cuts it into equal runs, one a block, over a fixed
//     grid of two blocks an SM (`blocks` from the host's shapes); a tile cut
//     between blocks leaves partials, and the merge kernel reduces them. So
//     the longest row's walk is spread over as many blocks as its positions
//     need, and the grid and the workspace depend on shapes alone: the call
//     replays in a CUDA graph.
//   - Block. 256 threads: one consumer warpgroup and one producer
//     warpgroup (setmaxnreg: 200 registers a thread in the consumer, 56 in
//     the producer, two blocks an SM). The producer walks the block's units,
//     loads each tile's q (64 x 192 bf16, 24 KB) once, then gathers the K
//     and V rows through the page table (one lane looks up each position's
//     row, a stage ahead) into a ring of kMlaRing stages of kMlaStage
//     positions (K then V, 24 KB a stage) with 16-byte cp.async copies;
//     positions past the piece are zero-filled. Rows are arbitrary pages,
//     so a TMA tile load does not apply. Each stage's landing is signalled
//     on an mbarrier by cp.async.mbarrier.arrive; the consumer releases a
//     stage (and q, after the unit's last scores) on others.
//   - Consumer. S = Q K^T on wgmma m64n32k16 over 12 k-steps, Q and K in
//     shared memory (K-major); the online softmax in f32 (base 2, each row
//     across the four lanes that hold it; the accumulators are rescaled
//     only when the warp's max moved); O += P V on m64n192k16 with P from
//     registers as hi + lo bf16 halves (one bf16 P misses the 1e-2
//     tolerance, attention_mma.cuh) and V read MN-major. O is 64 x 192 f32,
//     96 registers a thread. Everything that steers a loop is warp-uniform
//     (broadcast from lane 0), and stores are predicated: a lane-dependent
//     branch makes ptxas serialize the wgmma chains.
//   - Shared memory, 1024-byte aligned, every tile in the 128-byte
//     swizzled layout (swz128): q 24,576 bytes, the ring 3 x 24,576,
//     barriers and plan scratch: 99.5 KB, two blocks an SM.
//   - V is read in all 192 columns: the kernel is not told where the
//     model's padding starts.

#pragma once

#include "attention_plan.cuh"

namespace attn {

constexpr int kMlaDim = 192;           // qk head dim: 128 + 64 rope
constexpr int kMlaStage = 32;          // cache positions of a ring stage
constexpr int kMlaRing = 3;            // stages in the ring
constexpr int kMlaThreads = 256;       // consumer warpgroup 0, producer warpgroup 1
constexpr int kMlaBlocksPerSm = 2;
constexpr int kMlaProducerRegs = 56;   // setmaxnreg: 128 * 56 + 128 * 200 = 256 * 128
constexpr int kMlaConsumerRegs = 200;
constexpr int kMlaChunks = kMlaDim / 8;                      // 16-byte chunks of a row
constexpr int kMlaQBytes = kPlanTile * kMlaDim * 2;          // 24,576
constexpr int kMlaHalfBytes = kMlaStage * kMlaDim * 2;       // K (or V) of a stage
constexpr int kMlaStageBytes = 2 * kMlaHalfBytes;            // 24,576
constexpr int kMlaSmemBytes = 1024 + kMlaQBytes + kMlaRing * kMlaStageBytes +
                              (2 * kMlaRing + 2) * 8 + (kMlaThreads / kWarp + 2) * 8;
static_assert(kMlaBlocksPerSm * (kMlaSmemBytes + 1024) <= 233472, "two blocks an SM");
static_assert(kMlaProducerRegs + kMlaConsumerRegs == 2 * 65536 / (kMlaBlocksPerSm * kMlaThreads),
              "the register file split between two blocks");
static_assert(kMlaStage == 32 && kMlaDim % 64 == 0, "wgmma tiles: m64n32k16 scores");

// A call's shapes, the plan's job (attention_plan.cuh).
struct MlaJob {
  const int* start;
  const int* q_lens;
  int S, H, K, G;   // G = H / K query heads a kv head
  int tiles;        // tiles of a (sequence, kv head): cdiv(S * G, 64)
  int items;        // B * K * tiles
  int cap;          // MaxP * P

  // The positions the rows of tile `item` see: up to its last real, valid
  // row's window.
  __device__ __forceinline__ int len(int item) const {
    const int b = item / (K * tiles), first = (item % tiles) * kPlanTile;
    const int n = min(kPlanTile, S * G - first);
    const int s_last = min((first + n - 1) / G, __ldg(q_lens + b) - 1);
    return s_last >= first / G ? min(__ldg(start + b) + s_last + 1, cap) : 0;
  }
  __device__ __forceinline__ int rows(int item) const {
    return min(kPlanTile, S * G - (item % tiles) * kPlanTile);
  }
  // Row r of tile `item` in the [B * S * H] rows of q and the output.
  __device__ __forceinline__ size_t out_row(int item, int r) const {
    const int bk = item / tiles, gr = (item % tiles) * kPlanTile + r;
    return (static_cast<size_t>(bk / K) * S + gr / G) * H + (bk % K) * G + gr % G;
  }
};

// The producer warpgroup: each unit's q tile, then its K and V rows into
// the ring; warp w copies positions [8w, 8w + 8) of each stage, each lane
// 12 of their 384 16-byte chunks, every lane arriving on the stage's barrier.
__device__ __forceinline__ void mla_produce(
    const bf16* __restrict__ q, const bf16* __restrict__ k_pages,
    const bf16* __restrict__ v_pages, const int* __restrict__ table, const MlaJob& job,
    const PlanRun& run, int P, int max_pages, unsigned char* q_s, unsigned char* ring,
    uint64_t* full, uint64_t* empty, uint64_t* q_full, uint64_t* q_empty, int4* tasks) {
  constexpr int PW = kMlaStage / 4;    // positions of a stage a warp copies
  constexpr int CP = 2 * kMlaChunks;   // chunks of a position: K's, then V's
  const int lane = threadIdx.x % kWarp, w = (threadIdx.x / kWarp) % 4;
  const int t = threadIdx.x % 128;
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
    const int bk = u.item / job.tiles, b = bk / job.K, kh = bk % job.K;
    const int rows = job.rows(u.item);
    // q's rows past `rows` are not loaded: their outputs are not written.
    mbar_wait(q_empty, (qn & 1) ^ 1);
    for (int i = t; i < rows * kMlaChunks; i += 128) {
      const int r = i / kMlaChunks, c = i % kMlaChunks;
      cp_async16(q_s + swz128(kPlanTile, r, c), q + job.out_row(u.item, r) * kMlaDim + c * 8,
                 true);
    }
    cp_async_mbar_arrive(q_full);
    ++qn;
    const int* trow = table + static_cast<size_t>(b) * max_pages;
    const int hi = u.hi;
    auto row_of = [&](int p) {
      return p < hi ? (max(__ldg(trow + p / P), 0) * P + p % P) * job.K + kh : -1;
    };
    const int mine = PW * w + lane % PW;   // the position this lane looks up
    int next = row_of(u.lo + mine);
    for (int c0 = u.lo; c0 < hi; c0 += kMlaStage, ++it) {
      const int s = it % kMlaRing;
      const int cur = next;
      if (c0 + kMlaStage < hi) next = row_of(c0 + kMlaStage + mine);   // a stage ahead
      mbar_wait(empty + s, ((it / kMlaRing) & 1) ^ 1);
      unsigned char* dst = ring + s * kMlaStageBytes;
      // Not unrolled: twelve copies' addresses at once spill at 56
      // registers (340 bytes under ptxas for sm_90a), which doubled the
      // call's time on the H100.
#pragma unroll 1
      for (int n = 0; n < PW * CP / kWarp; ++n) {
        const int i = n * kWarp + lane, p = i / CP, c = i % CP;
        const int row = __shfl_sync(kFull, cur, p);
        const bool is_v = c >= kMlaChunks;
        const int cc = is_v ? c - kMlaChunks : c;
        const bf16* src = (is_v ? v_pages : k_pages) + static_cast<size_t>(max(row, 0)) * kMlaDim;
        cp_async16(dst + (is_v ? kMlaHalfBytes : 0) + swz128(kMlaStage, PW * w + p, cc),
                   src + cc * 8, row >= 0);
      }
      cp_async_mbar_arrive(full + s);
    }
  }
  if (threadIdx.x == 128) tasks[blockIdx.x] = task;
  cp_async_wait<0>();
}

// The consumer warpgroup: every unit of the run, all 192 columns.
__device__ __forceinline__ void mla_consume(
    const MlaJob& job, const PlanRun& run, float* __restrict__ ws, bf16* __restrict__ out,
    const unsigned char* q_s, const unsigned char* ring, uint64_t* full, uint64_t* empty,
    uint64_t* q_full, uint64_t* q_empty, float scale) {
  constexpr int D = kMlaDim, C = kMlaStage;
  constexpr int NO = D / 2;     // accumulators a thread: 64 rows x 192 columns / 128
  constexpr int NS = C / 2;     // score accumulators a thread
  constexpr int KS = D / 16;    // k-steps of the scores
  const int lane = threadIdx.x % kWarp, wt = threadIdx.x % 128;
  const int r0 = 16 * (wt / kWarp) + lane / 4;   // rows r0 and r0 + 8
  const float sl = scale * kLog2e;
  const uint32_t q_addr = smem_u32(q_s), ring_addr = smem_u32(ring);
  float* ml = ws + 2 * static_cast<size_t>(gridDim.x) * kPlanTile * D;
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
    const int b = u.item / (job.K * job.tiles), first = (u.item % job.tiles) * kPlanTile;
    const int rows = job.rows(u.item);
    const int st = __ldg(job.start + b), ql = __ldg(job.q_lens + b);
    int lim[2];   // each row's visible positions, within the piece
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + 8 * i, s = (first + r) / job.G;
      const int seen = s < ql ? min(st + s + 1, job.cap) : 0;
      lim[i] = min(r < rows ? seen : 0, u.hi);
    }
    float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int k = 0; k < NO; ++k) o[k] = 0.f;
    if (u.lo < u.hi) mbar_wait(q_full, qn++ & 1);
    for (int c0 = u.lo; c0 < u.hi; c0 += C, ++it) {
      const int s = it % kMlaRing;
      const uint32_t k_addr = ring_addr + s * kMlaStageBytes, v_addr = k_addr + kMlaHalfBytes;
      mbar_wait(full + s, (it / kMlaRing) & 1);
      fence_proxy_async();

      // S = Q K^T, K-major both.
      float sc[NS];
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const uint32_t qa = q_addr + (ks >> 2) * (kPlanTile * 128) + (ks & 3) * 32;
        const uint32_t ka = k_addr + (ks >> 2) * (C * 128) + (ks & 3) * 32;
        wgmma_ss_n32(sc, wgmma_desc(qa, 16, 1024), wgmma_desc(ka, 16, 1024), ks > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int k = 0; k < NS; ++k) fence_operand(sc[k]);
      __syncwarp();
      if (c0 + C >= u.hi) mbar_arrive_lane0(q_empty);   // the unit's last read of q

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

      // P as A fragments (hi + lo), O += P V with V MN-major.
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
        const uint64_t vd = wgmma_desc(v_addr + kk * 16 * 128, C * 128, 1024);
        wgmma_rs_n192(o, ph[kk], vd);
        wgmma_rs_n192(o, pl[kk], vd);
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
    // store by store.
    const int j = lane & 3;
    if (u.len == 0) {
      // An empty tile: zeros, 16 bytes a thread at a time.
#pragma unroll 4
      for (int n = 0; n < kPlanTile * kMlaChunks / 128; ++n) {
        const int k = n * 128 + wt, r = k / kMlaChunks;
        st_if(out + job.out_row(u.item, min(r, rows - 1)) * D + 8 * (k % kMlaChunks),
              make_uint4(0, 0, 0, 0), r < rows);
      }
    } else if (__any_sync(kFull, r0 < rows)) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = r0 + 8 * i;
        const bool real = r < rows;
        if (u.cut) {
          const size_t pr = static_cast<size_t>(u.slot) * kPlanTile + r;
          float* acc = ws + pr * D;
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
          st_if(ml + 2 * pr, m[i], l[i], real);
        } else {
          const float inv = l[i] > 0.f ? __fdividef(1.f, l[i]) : 0.f;
          bf16* dst = out + job.out_row(u.item, real ? r : 0) * D;
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

__global__ void __launch_bounds__(kMlaThreads, kMlaBlocksPerSm) mla_ragged_wg_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k_pages,
    const bf16* __restrict__ v_pages, const int* __restrict__ table, MlaJob job,
    float* __restrict__ ws, bf16* __restrict__ out, int P, int max_pages, float scale) {
  extern __shared__ __align__(16) unsigned char mla_raw[];
  unsigned char* q_s = mla_raw + ((1024 - (smem_u32(mla_raw) & 1023)) & 1023);
  unsigned char* ring = q_s + kMlaQBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kMlaRing * kMlaStageBytes);
  uint64_t* empty = full + kMlaRing;
  uint64_t* q_full = empty + kMlaRing;
  uint64_t* q_empty = q_full + 1;
  long long* red = reinterpret_cast<long long*>(q_empty + 1);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kMlaRing; ++s) {
      mbar_init(full + s, 128);     // the producer's threads, as their copies land
      mbar_init(empty + s, 4);      // the consumer's warps
    }
    mbar_init(q_full, 128);
    mbar_init(q_empty, 4);
    mbar_init_fence();
  }
  __syncthreads();
  const PlanRun run = plan_run<MlaJob, kMlaThreads>(job, blockIdx.x, gridDim.x, red);
  if (__shfl_sync(kFull, run.item, 0) < 0) {
    if (threadIdx.x == 0) plan_tasks<kMlaDim>(ws, gridDim.x)[blockIdx.x] = make_int4(-1, 0, 0, 1);
    return;
  }
  if (__shfl_sync(kFull, threadIdx.x / 128, 0) == 1) {   // warp-uniform
    setmaxnreg_dec<kMlaProducerRegs>();
    mla_produce(q, k_pages, v_pages, table, job, run, P, max_pages, q_s, ring, full, empty,
                q_full, q_empty, plan_tasks<kMlaDim>(ws, gridDim.x));
  } else {
    setmaxnreg_inc<kMlaConsumerRegs>();
    mla_consume(job, run, ws, out, q_s, ring, full, empty, q_full, q_empty, scale);
  }
}

__global__ void __launch_bounds__(kPlanMergeThreads) mla_ragged_merge_kernel(
    float* __restrict__ ws, bf16* __restrict__ out, MlaJob job, int blocks) {
  plan_merge<kMlaDim>(ws, out, job, blocks);
}

// Both passes of a call over `blocks` blocks; `ws` holds 2 * blocks * 64 *
// 194 + 4 * blocks floats.
inline cudaError_t launch_mla_wg(const void* q, const void* k_pages, const void* v_pages,
                                 const int* table, const int* start, const int* q_lens,
                                 float* ws, void* out, int B, int S, int H, int K, int P,
                                 int max_pages, int blocks, float scale, cudaStream_t stream) {
  static const cudaError_t prepared = [] {
    const cudaError_t err = prepare(mla_ragged_wg_kernel, kMlaSmemBytes);
    // Two blocks an SM need the largest shared-memory carveout.
    return err != cudaSuccess ? err
                              : cudaFuncSetAttribute(mla_ragged_wg_kernel,
                                                     cudaFuncAttributePreferredSharedMemoryCarveout,
                                                     cudaSharedmemCarveoutMaxShared);
  }();
  if (prepared != cudaSuccess) return prepared;
  const int G = H / K;
  const int tiles = (S * G + kPlanTile - 1) / kPlanTile;
  const MlaJob job{start, q_lens, S, H, K, G, tiles, B * K * tiles, max_pages * P};
  mla_ragged_wg_kernel<<<blocks, kMlaThreads, kMlaSmemBytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k_pages),
      static_cast<const bf16*>(v_pages), table, job, ws, static_cast<bf16*>(out), P, max_pages,
      scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  mla_ragged_merge_kernel<<<dim3(blocks, kMlaDim / 64), kPlanMergeThreads, 0, stream>>>(
      ws, static_cast<bf16*>(out), job, blocks);
  return cudaGetLastError();
}

}  // namespace attn
