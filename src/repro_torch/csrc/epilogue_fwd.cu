// Fused gated-combine epilogue forward over row-flattened branch outputs:
//   out = (g1*o1 + g2*o2 + g3*o3) * m,   accumulated in fp32.
//
// Replaces repro/kernels/epilogue.py::_fwd_kernel (Pallas, TPU).
//
// Layout: o1..o3 (R, D) in the compute dtype, g1..g3 (R,) fp32 per-row gate
// values, m (R,) fp32 query validity (1 real / 0 padded) -> out (R, D) in
// the dtype of o1.  R = B*N*H.
//
// Design.  A purely elementwise pass: a grid-stride loop in which
// neighbouring threads touch neighbouring elements, so every load and store
// is coalesced.  Bound on the H100: memory (4 tensors of R*D elements move
// for 6 FLOP per element); the per-row gate and mask loads hit L1.
#include "common.cuh"

namespace {

template <typename T>
__global__ void epilogue_fwd_kernel(const T* __restrict__ o1, const T* __restrict__ o2,
                                    const T* __restrict__ o3,
                                    const float* __restrict__ g1,
                                    const float* __restrict__ g2,
                                    const float* __restrict__ g3,
                                    const float* __restrict__ m, T* __restrict__ out,
                                    size_t total, int D) {
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    const size_t r = i / D;
    const float acc = g1[r] * rt::to_f(o1[i]) + g2[r] * rt::to_f(o2[i]) +
                      g3[r] * rt::to_f(o3[i]);
    out[i] = rt::from_f<T>(acc * m[r]);
  }
}

template <typename T>
int launch(const void* o1, const void* o2, const void* o3, const void* g1,
           const void* g2, const void* g3, const void* m, void* out, int R, int D,
           cudaStream_t stream) {
  const size_t total = (size_t)R * D;
  const int threads = 256;
  const size_t want = (total + threads - 1) / threads;
  const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);   // 16 per SM
  if (blocks == 0) return 0;
  epilogue_fwd_kernel<T><<<blocks, threads, 0, stream>>>(
      static_cast<const T*>(o1), static_cast<const T*>(o2), static_cast<const T*>(o3),
      static_cast<const float*>(g1), static_cast<const float*>(g2),
      static_cast<const float*>(g3), static_cast<const float*>(m),
      static_cast<T*>(out), total, D);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int epilogue_fwd(const void* o1, const void* o2, const void* o3,
                            const void* g1, const void* g2, const void* g3,
                            const void* m, void* out, int R, int D, int bf16,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(o1, o2, o3, g1, g2, g3, m, out, R, D, s)
              : launch<float>(o1, o2, o3, g1, g2, g3, m, out, R, D, s);
}
