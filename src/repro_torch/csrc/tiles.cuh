// Staging and register-tile helpers of the tiled kernels (flash_bwd.cu,
// selection_fwd.cu, selection_bwd.cu): row tiles copied into shared memory
// by cp.async, paired stores, and the float4 steps of the FMA micro-tiles.
#pragma once

#include "common.cuh"
#include "mma.cuh"

namespace rt {

// n rows of D elements (global row stride D) into a shared tile of `rows`
// rows with row stride LD; rows n.. are zero.  cp.async, 16 bytes a copy.
template <typename T, int D, int LD>
__device__ __forceinline__ void stage_rows(T* dst, const T* src, int n, int rows,
                                           int nthreads) {
  constexpr int CH = 16 / sizeof(T);
  constexpr int PER_ROW = D / CH;
  for (int c = threadIdx.x; c < rows * PER_ROW; c += nthreads) {
    const int r = c / PER_ROW, e = (c % PER_ROW) * CH;
    T* d = dst + r * LD + e;
    if (r < n)
      cp_async16(d, src + (size_t)r * D + e);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// n fp32 values into `rows` shared slots, the rest set to `fill`.
__device__ __forceinline__ void stage_vals(float* dst, const float* src, int n, int rows,
                                           float fill, int nthreads) {
  for (int i = threadIdx.x; i < rows; i += nthreads) {
    if (i < n)
      cp_async4(dst + i, src + i);
    else
      dst[i] = fill;
  }
}

template <typename T>
__device__ __forceinline__ void store2(T* p, float a, float b);
template <>
__device__ __forceinline__ void store2<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <>
__device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ float lane_of(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// N consecutive floats of shared memory (N in {1, 2, 4, 8, ...}).
template <int N>
__device__ __forceinline__ void load_vec(float (&x)[N], const float* p) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int c = 0; c < N / 4; ++c) {
      const float4 v = reinterpret_cast<const float4*>(p)[c];
      x[4 * c] = v.x, x[4 * c + 1] = v.y, x[4 * c + 2] = v.z, x[4 * c + 3] = v.w;
    }
  } else if constexpr (N == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    x[0] = v.x, x[1] = v.y;
  } else {
#pragma unroll
    for (int c = 0; c < N; ++c) x[c] = p[c];
  }
}

// n rows that attend nothing: zeros and LSE_EMPTY (o, lse at the first row).
template <typename T, int D>
__device__ __forceinline__ void write_empty_tile(T* o, float* lse, int n) {
  store_zeros(o, n * D);
  for (int i = threadIdx.x; i < n; i += blockDim.x) lse[i] = LSE_EMPTY;
}

// Allow a kernel `bytes` of dynamic shared memory (above 48 KB it must ask).
template <typename K>
int set_smem(K kern, size_t bytes) {
  return (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

}  // namespace rt
