// Backward of the fused gated-combine epilogue over row-flattened branch
// outputs:  d o_b = g_b * m * dO,   d g_b = sum_D(m * dO * o_b)   (fp32).
//
// Replaces repro/kernels/epilogue.py::_bwd_kernel (Pallas, TPU).
//
// Layout: o1..o3 and dO (R, D) in the compute dtype, g1..g3 and m (R,) fp32
// -> do1..do3 (R, D) in the dtype of o1, dg1..dg3 (R,) fp32.
//
// Design.  One warp owns one row at a time (grid-stride over rows): lanes
// walk the row's D elements side by side, so every load and store is
// coalesced, and the three sums over D for dg are warp reductions, written
// by lane 0.  Bound on the H100: memory -- seven tensors of R*D elements
// move for ten FLOP per element; the per-row gates and mask hit L1.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;   // rows in flight per block

template <typename T>
__global__ void __launch_bounds__(32 * kWarps)
epilogue_bwd_kernel(const T* __restrict__ o1, const T* __restrict__ o2,
                    const T* __restrict__ o3, const float* __restrict__ g1,
                    const float* __restrict__ g2, const float* __restrict__ g3,
                    const float* __restrict__ m, const T* __restrict__ dout,
                    T* __restrict__ do1, T* __restrict__ do2, T* __restrict__ do3,
                    float* __restrict__ dg1, float* __restrict__ dg2,
                    float* __restrict__ dg3, int R, int D) {
  const int lane = threadIdx.x % 32;
  const int warps = gridDim.x * kWarps;
  for (int r = blockIdx.x * kWarps + threadIdx.x / 32; r < R; r += warps) {
    const float mr = m[r], a1 = g1[r], a2 = g2[r], a3 = g3[r];
    float s1 = 0.f, s2 = 0.f, s3 = 0.f;
    for (int d = lane; d < D; d += 32) {
      const size_t i = (size_t)r * D + d;
      const float g = rt::to_f(dout[i]) * mr;   // masked cotangent
      do1[i] = rt::from_f<T>(a1 * g);
      do2[i] = rt::from_f<T>(a2 * g);
      do3[i] = rt::from_f<T>(a3 * g);
      s1 = fmaf(g, rt::to_f(o1[i]), s1);
      s2 = fmaf(g, rt::to_f(o2[i]), s2);
      s3 = fmaf(g, rt::to_f(o3[i]), s3);
    }
    s1 = rt::group_sum<32>(s1);
    s2 = rt::group_sum<32>(s2);
    s3 = rt::group_sum<32>(s3);
    if (lane == 0) {
      dg1[r] = s1;
      dg2[r] = s2;
      dg3[r] = s3;
    }
  }
}

template <typename T>
int launch(const void* o1, const void* o2, const void* o3, const void* g1,
           const void* g2, const void* g3, const void* m, const void* dout,
           void* do1, void* do2, void* do3, void* dg1, void* dg2, void* dg3,
           int R, int D, cudaStream_t stream) {
  if (R == 0) return 0;
  const int want = (R + kWarps - 1) / kWarps;
  const int blocks = want < 132 * 8 ? want : 132 * 8;    // 8 per SM
  epilogue_bwd_kernel<T><<<blocks, 32 * kWarps, 0, stream>>>(
      static_cast<const T*>(o1), static_cast<const T*>(o2), static_cast<const T*>(o3),
      static_cast<const float*>(g1), static_cast<const float*>(g2),
      static_cast<const float*>(g3), static_cast<const float*>(m),
      static_cast<const T*>(dout), static_cast<T*>(do1), static_cast<T*>(do2),
      static_cast<T*>(do3), static_cast<float*>(dg1), static_cast<float*>(dg2),
      static_cast<float*>(dg3), R, D);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int epilogue_bwd(const void* o1, const void* o2, const void* o3,
                            const void* g1, const void* g2, const void* g3,
                            const void* m, const void* dout, void* do1, void* do2,
                            void* do3, void* dg1, void* dg2, void* dg3, int R, int D,
                            int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(o1, o2, o3, g1, g2, g3, m, dout, do1, do2, do3,
                                      dg1, dg2, dg3, R, D, s)
              : launch<float>(o1, o2, o3, g1, g2, g3, m, dout, do1, do2, do3, dg1,
                              dg2, dg3, R, D, s);
}
