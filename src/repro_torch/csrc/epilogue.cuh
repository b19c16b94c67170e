// Shared device code of the gated-combine epilogue kernels
// (epilogue_fwd.cu, epilogue_bwd.cu): the 16-byte vector of a row and the
// row-to-lane rule of their `vec` kernels.
//
// Rule (kernels/epilogue.py::epilogue_plan, one for both kernels): a row
// of D elements lies on L lanes (D/4 in fp32, D/8 in bf16, a power of two up
// to 32), so a warp holds 32/L rows; thread t of the grid takes row t / L
// and lane t % L, whose vectors are sub, sub + L, ...  Blocks of kThreads
// threads, R*L/kThreads of them: no grid-stride loop.
#pragma once

#include "common.cuh"

namespace rt {

constexpr int kEpilogueThreads = 256;

// One 16-byte vector as fp32 and back (4 fp32 or 8 bf16 elements).
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float (&x)[N]) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
  }
  __device__ __forceinline__ static void store(float* p, const float (&x)[N]) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float (&x)[N]) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[k]));
      x[2 * k] = f.x, x[2 * k + 1] = f.y;
    }
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p, const float (&x)[N]) {
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(x[2 * k], x[2 * k + 1]);
      w[k] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// The row and lane of this thread under the rule above (row >= R: none).
template <int L>
struct RowLane {
  size_t row;
  int sub;
  __device__ __forceinline__ RowLane()
      : row(((size_t)blockIdx.x * kEpilogueThreads + threadIdx.x) / L),
        sub(threadIdx.x % L) {}
};

// Blocks of the vec kernels for R rows on L lanes.
inline unsigned epilogue_vec_blocks(int R, int L) {
  return (unsigned)(((size_t)R * L + kEpilogueThreads - 1) / kEpilogueThreads);
}

}  // namespace rt
