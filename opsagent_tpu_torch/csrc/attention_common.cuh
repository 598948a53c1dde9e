// Helpers shared by the paged-attention sources (paged_attention.cu,
// paged_attention_grid.cu): element conversions, warp reductions, 16-byte
// row loads, the shared-memory opt-in and the dispatch of a launch over q's
// dtype, the page type and the head dim. ops/cuda_build.py hashes this file
// into the name of every library built from csrc/.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>
#include <type_traits>

namespace attn {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }
// x rounded to T and read back as f32.
__device__ __forceinline__ float round_as(float x, const float*) { return x; }
__device__ __forceinline__ float round_as(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// Load VEC consecutive elements (16 bytes) starting at `src` as f32.
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* __restrict__ src, float (&dst)[VEC]) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(src));
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < VEC; ++i) dst[i] = to_f32(e[i]);
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, int bytes) {
  // Above 48 KB a block's dynamic shared memory needs an explicit opt-in.
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

enum DType { kFloat32 = 0, kBFloat16 = 1 };

// Calls fn.run<T, PT, D>() for the runtime head dim and page type (PT = T,
// or int8_t for int8 pages), or returns cudaErrorInvalidValue. kMla adds
// the materialized-MLA head dims, 24 (tiny-mla) and 192 (DeepSeek-V2/V3's
// 128 + 64), for pages in q's dtype only: both packages refuse an int8 KV
// cache for MLA. Only the dma source instantiates them.
template <typename T, bool kMla, typename Fn>
cudaError_t by_head_dim(int D, bool int8_pages, const Fn& fn) {
  switch (D) {
    case 16: return int8_pages ? fn.template run<T, int8_t, 16>() : fn.template run<T, T, 16>();
    case 32: return int8_pages ? fn.template run<T, int8_t, 32>() : fn.template run<T, T, 32>();
    case 64: return int8_pages ? fn.template run<T, int8_t, 64>() : fn.template run<T, T, 64>();
    case 128: return int8_pages ? fn.template run<T, int8_t, 128>() : fn.template run<T, T, 128>();
    default: break;
  }
  if constexpr (kMla) {
    if (!int8_pages && D == 24) return fn.template run<T, T, 24>();
    if (!int8_pages && D == 192) return fn.template run<T, T, 192>();
  }
  return cudaErrorInvalidValue;
}

// The same over q's dtype code (kFloat32 or kBFloat16).
template <bool kMla = false, typename Fn>
cudaError_t dispatch(int dtype, int D, bool int8_pages, const Fn& fn) {
  if (dtype == kFloat32) return by_head_dim<float, kMla>(D, int8_pages, fn);
  if (dtype == kBFloat16) return by_head_dim<__nv_bfloat16, kMla>(D, int8_pages, fn);
  return cudaErrorInvalidValue;
}

}  // namespace attn
