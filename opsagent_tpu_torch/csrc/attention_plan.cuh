// The split-KV plan of the warpgroup attention kernels (the MLA latent
// kernels of attention_latent.cuh and the materialized-MLA ragged kernel of
// attention_mla.cuh), for NVIDIA Hopper (sm_90a).
//
// The work of a call is laid out on one axis, tile after tile, each tile
// (64 query rows: wgmma's m64) costing its visible positions plus kPlanCost
// (its q load and output; kPlanEmptyCost for a tile that only writes
// zeros). Block k of a fixed grid (its size from the host's shapes) takes
// the run [k * per, (k + 1) * per), per = max(cdiv(total, blocks),
// kPlanMinRun). Every block finds its run from the call's start / q_lens
// (lengths) on the device, so the grid and workspace depend on shapes alone
// and the call replays in a CUDA graph. A tile that a block holds whole is
// written normalised; a tile cut between blocks leaves a partial (max, sum
// and the f32 accumulators of each row) in slot 2k (the block's first tile)
// or 2k + 1 (its last), and the block where the tile starts leaves a task
// for the merge kernel, which reduces each cut tile once. So long walks are
// split, and partials are written only where a run is cut: at most 2 *
// blocks tiles of 64 * (D + 2) floats.
//
// A job type describes the tiles of a call: `items` tiles, `len(item)` the
// positions its rows see, `rows(item)` its real rows and `out_row(item, r)`
// the output row (of D elements) of its row r. ops/paged_attention.py
// mirrors the constants (LATENT_*) and the plan (latent_plan).

#pragma once

#include "attention_mma.cuh"
#include "wgmma_ptx.cuh"

namespace attn {

using bf16 = __nv_bfloat16;

constexpr int kPlanTile = 64;          // query rows of a tile: wgmma's m64
constexpr int kPlanCost = 128;         // a tile's fixed cost in the plan, in positions
constexpr int kPlanEmptyCost = 32;     // ... a tile that sees nothing: zeros, no q load
constexpr int kPlanMinRun = 128;       // least positions of a block's run
constexpr int kPlanMergeThreads = 256; // a merge block: (row, 4 columns) items of a cut tile
static_assert(kPlanCost >= 1 && kPlanEmptyCost >= 1,
              "a tile ends before its run's end when the run ends the call");

// A tile's cost on the plan's axis.
__device__ __forceinline__ long long plan_cost(int len) {
  return len + (len > 0 ? kPlanCost : kPlanEmptyCost);
}

// Byte offset of 16-byte chunk c of row r in a tile of `rows` rows in the
// 128-byte swizzled layout wgmma reads: column blocks of [rows][64] bf16,
// chunk c of row r at c ^ (r % 8).
__device__ __forceinline__ int swz128(int rows, int r, int c) {
  return (c >> 3) * rows * 128 + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// A block's run on the plan's axis, [begin, end); `item` is the first tile
// that reaches into it (-1: the block has no run) and `pre` its offset.
struct PlanRun {
  long long per, begin, end, pre;
  int item;
};

// All NT threads of the block: the total cost, then the tile holding the
// run's first position (two block scans over the tiles). `red` holds NT /
// 32 + 2 values in shared memory.
template <class Job, int NT>
__device__ PlanRun plan_run(const Job& j, int block, int blocks, long long* red) {
  constexpr int W = NT / kWarp;
  const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
  long long sum = 0;
  for (int i = tid; i < j.items; i += NT) sum += plan_cost(j.len(i));
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) sum += __shfl_xor_sync(kFull, sum, o);
  if (lane == 0) red[warp] = sum;
  __syncthreads();
  long long total = 0;
#pragma unroll
  for (int w = 0; w < W; ++w) total += red[w];
  PlanRun run;
  run.per = max((total + blocks - 1) / blocks, static_cast<long long>(kPlanMinRun));
  run.begin = block * run.per;
  run.end = min(run.begin + run.per, total);
  run.item = -1;
  run.pre = 0;
  if (run.begin >= total) return run;
  long long carry = 0;
  for (int base = 0; base < j.items; base += NT) {
    __syncthreads();  // red read by every thread
    const int i = base + tid;
    const long long c = i < j.items ? plan_cost(j.len(i)) : 0;
    long long x = c;   // inclusive scan in the warp
#pragma unroll
    for (int o = 1; o < kWarp; o <<= 1) {
      const long long y = __shfl_up_sync(kFull, x, o);
      if (lane >= o) x += y;
    }
    if (lane == kWarp - 1) red[warp] = x;
    if (tid == 0) red[W] = -1;
    __syncthreads();
    long long before = carry + x - c, chunk = 0;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      if (w < warp) before += red[w];
      chunk += red[w];
    }
    __syncthreads();
    if (c > 0 && before <= run.begin && run.begin < before + c) {
      red[W] = i;
      red[W + 1] = before;
    }
    __syncthreads();
    if (red[W] >= 0) {
      run.item = static_cast<int>(red[W]);
      run.pre = red[W + 1];
      return run;
    }
    carry += chunk;
  }
  return run;  // not reached: begin < total lies in some tile
}

// A tile's piece in a block's run.
struct PlanUnit {
  long long pre;   // the tile's offset on the plan's axis
  int item, len;   // the tile and the positions its rows see
  int lo, hi;      // the piece's positions
  int slot;        // its partials' slot, when cut
  bool cut;        // the tile's positions are split over blocks
};

// The block's next unit (a piece with positions, or an empty tile that
// starts in the run, whose zeros it writes); advances (item, pre).
template <class Job>
__device__ __forceinline__ bool plan_next(const Job& j, const PlanRun& run, int block, int& item,
                                          long long& pre, PlanUnit& u) {
  while (item < j.items && pre < run.end) {
    const int len = j.len(item);
    const long long lo = max(run.begin - pre, 0LL);
    const long long hi = min(run.end - pre, static_cast<long long>(len));
    const bool take = lo < hi || (len == 0 && pre >= run.begin);
    if (take) {
      u.pre = pre;
      u.item = item;
      u.len = len;
      u.lo = static_cast<int>(lo);
      u.hi = static_cast<int>(max(hi, lo));
      // Cut: the tile reaches past the run on either side (no 64-bit
      // division here: it would branch inside the consumers' loop).
      u.cut = pre < run.begin || pre + max(len, 1) > run.end;
      u.slot = 2 * block + (pre < run.begin ? 0 : 1);
    }
    pre += plan_cost(len);
    ++item;
    if (take) return true;
  }
  return false;
}

// The workspace of a call over `blocks` blocks at head dim D: partial
// accumulators [2 * blocks][64][D], their (max, sum) pairs [2 * blocks][64]
// [2], then each block's merge task (the tile cut at the end of its run if
// the tile starts in the run: its item, or -1 for none; its offset in the
// run; its positions; the plan's per).
template <int D>
__device__ __forceinline__ int4* plan_tasks(float* ws, int blocks) {
  return reinterpret_cast<int4*>(ws + 2 * static_cast<size_t>(blocks) * kPlanTile * (D + 2));
}

// Block (x, y): block x's merge task, columns [64 y, 64 y + 64) of its
// rows, each (row, 4 columns) folded over the pieces as the main kernel
// folds positions (running max, rescaled sums).
template <int D, class Job>
__device__ __forceinline__ void plan_merge(float* __restrict__ ws, bf16* __restrict__ out,
                                           const Job& job, int blocks) {
  constexpr int QC = 16;   // float4 chunks of 64 columns
  const int k0 = blockIdx.x;
  const int4 task = plan_tasks<D>(ws, blocks)[k0];
  if (task.x < 0) return;
  // The blocks from k0 on that hold the tile's positions.
  const int pieces = static_cast<int>((static_cast<long long>(task.y) + task.z - 1) / task.w) + 1;
  const int rows = job.rows(task.x);
  const float* ml = ws + 2 * static_cast<size_t>(blocks) * kPlanTile * D;
  for (int i = threadIdx.x; i < rows * QC; i += kPlanMergeThreads) {
    const int r = i / QC, c = (blockIdx.y * QC + i % QC) * 4;
    // Piece j's row: block k0's slot 2 k0 + 1, then block k0 + j's slot 2 (k0 + j).
    const float* m0 = ml + 2 * ((2 * k0 + 1) * kPlanTile + r);
    const float* a0 = ws + ((2 * k0 + 1) * kPlanTile + r) * static_cast<size_t>(D) + c;
    constexpr int SLOT2 = 2 * kPlanTile;   // rows from slot 2k to slot 2(k + 1)
    // Folded online (running max, rescaled sums): no load waits on another.
    float mx = -CUDART_INF_F, den = 0.f;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 16
    for (int j = 0; j < pieces; ++j) {
      const int d = j == 0 ? 0 : j * SLOT2 - kPlanTile;   // rows past piece 0's
      const float2 p = __ldg(reinterpret_cast<const float2*>(m0 + 2 * d));
      const float4 v = __ldg(reinterpret_cast<const float4*>(a0 + static_cast<size_t>(d) * D));
      const float mn = fmaxf(mx, p.x);
      const bool none = mn == -CUDART_INF_F;   // nothing seen yet
      const float keep = none ? 1.f : exp2f(mx - mn), w = none ? 0.f : exp2f(p.x - mn);
      mx = mn;
      den = den * keep + w * p.y;
      a.x = a.x * keep + w * v.x;
      a.y = a.y * keep + w * v.y;
      a.z = a.z * keep + w * v.z;
      a.w = a.w * keep + w * v.w;
    }
    const float inv = den > 0.f ? 1.f / den : 0.f;
    *reinterpret_cast<uint2*>(out + job.out_row(task.x, r) * D + c) =
        make_uint2(pack_bf16(a.x * inv, a.y * inv), pack_bf16(a.z * inv, a.w * inv));
  }
}

}  // namespace attn
