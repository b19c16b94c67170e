// Backward of the fused gated-combine epilogue over row-flattened branch
// outputs:  d o_b = g_b * m * dO,   d g_b = sum_D(m * dO * o_b)   (fp32).
//
// Replaces repro/kernels/epilogue.py::_bwd_kernel (Pallas, TPU).
//
// Layout: o1..o3 and dO (R, D) in the compute dtype, g1..g3 and m (R,) fp32
// -> do1..do3 (R, D) in the dtype of o1, dg1..dg3 (R,) fp32.
//
// Bound on the H100: memory -- seven tensors of R*D elements and seven of R
// move for ten FLOP per element.  Two kernels, chosen by
// kernels/epilogue.py::epilogue_plan (the wrapper passes `lanes`):
//   vec   D a multiple of one 16-byte vector (4 fp32, 8 bf16) and every
//         (R, D) tensor 16-byte aligned.  A row lies on L lanes by the rule
//         of epilogue.cuh (shared with epilogue_fwd.cu); each lane loads its
//         row's gates and mask, then 16-byte vectors of o1..o3 and dO
//         (vectors sub, sub + L, ...), stores 16-byte vectors
//         of do1..do3, and the three sums over D run over the row's L lanes
//         by a butterfly (xor 1, 2, ..., L/2): a fixed order, so two calls
//         give the same bits.  Lane k < 3 of a row stores dg_k: the warp's
//         rows land side by side.  One row group a thread, no grid-stride
//         loop: R*L/256 blocks keep every SM's loads in flight.
//   warp  any other D or alignment: one warp a row (grid-stride over rows),
//         lanes walk the row's elements side by side, warp reductions for
//         dg, written by lane 0.
#include "epilogue.cuh"

namespace {

constexpr int kWarps = 8;   // rows in flight per block (warp kernel)
constexpr int kThreads = rt::kEpilogueThreads;
using rt::Vec;

template <typename T>
__global__ void __launch_bounds__(32 * kWarps)
epilogue_bwd_warp(const T* __restrict__ o1, const T* __restrict__ o2,
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

template <typename T, int L>
__global__ void __launch_bounds__(kThreads)
epilogue_bwd_vec(const T* __restrict__ o1, const T* __restrict__ o2,
                 const T* __restrict__ o3, const float* __restrict__ g1,
                 const float* __restrict__ g2, const float* __restrict__ g3,
                 const float* __restrict__ m, const T* __restrict__ dout,
                 T* __restrict__ do1, T* __restrict__ do2, T* __restrict__ do3,
                 float* __restrict__ dg1, float* __restrict__ dg2,
                 float* __restrict__ dg3, int R, int D) {
  using V = Vec<T>;
  constexpr int N = V::N;
  const rt::RowLane<L> at;
  const size_t r = at.row;
  const int sub = at.sub;
  const bool live = r < (size_t)R;
  float mr = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
  if (live) mr = m[r], a1 = g1[r], a2 = g2[r], a3 = g3[r];
  float s1 = 0.f, s2 = 0.f, s3 = 0.f;
  if (live) {
    for (int c = sub * N; c < D; c += L * N) {
      const size_t i = r * D + c;
      float g[N], x1[N], x2[N], x3[N], y[N];
      V::load(dout + i, g);
      V::load(o1 + i, x1);
      V::load(o2 + i, x2);
      V::load(o3 + i, x3);
#pragma unroll
      for (int e = 0; e < N; ++e) {
        g[e] *= mr;                              // masked cotangent
        s1 = fmaf(g[e], x1[e], s1);
        s2 = fmaf(g[e], x2[e], s2);
        s3 = fmaf(g[e], x3[e], s3);
      }
#pragma unroll
      for (int e = 0; e < N; ++e) y[e] = a1 * g[e];
      V::store(do1 + i, y);
#pragma unroll
      for (int e = 0; e < N; ++e) y[e] = a2 * g[e];
      V::store(do2 + i, y);
#pragma unroll
      for (int e = 0; e < N; ++e) y[e] = a3 * g[e];
      V::store(do3 + i, y);
    }
  }
  s1 = rt::group_sum<L>(s1);
  s2 = rt::group_sum<L>(s2);
  s3 = rt::group_sum<L>(s3);
  if (live) {
    for (int k = sub; k < 3; k += L) {
      float* dst = k == 0 ? dg1 : k == 1 ? dg2 : dg3;
      dst[r] = k == 0 ? s1 : k == 1 ? s2 : s3;
    }
  }
}

template <typename T>
int launch_warp(const void* o1, const void* o2, const void* o3, const void* g1,
                const void* g2, const void* g3, const void* m, const void* dout,
                void* do1, void* do2, void* do3, void* dg1, void* dg2, void* dg3,
                int R, int D, cudaStream_t stream) {
  const int want = (R + kWarps - 1) / kWarps;
  const int blocks = want < 132 * 8 ? want : 132 * 8;    // 8 per SM
  epilogue_bwd_warp<T><<<blocks, 32 * kWarps, 0, stream>>>(
      static_cast<const T*>(o1), static_cast<const T*>(o2), static_cast<const T*>(o3),
      static_cast<const float*>(g1), static_cast<const float*>(g2),
      static_cast<const float*>(g3), static_cast<const float*>(m),
      static_cast<const T*>(dout), static_cast<T*>(do1), static_cast<T*>(do2),
      static_cast<T*>(do3), static_cast<float*>(dg1), static_cast<float*>(dg2),
      static_cast<float*>(dg3), R, D);
  return (int)cudaGetLastError();
}

template <typename T, int L>
int launch_vec(const void* o1, const void* o2, const void* o3, const void* g1,
               const void* g2, const void* g3, const void* m, const void* dout,
               void* do1, void* do2, void* do3, void* dg1, void* dg2, void* dg3,
               int R, int D, cudaStream_t stream) {
  if (D % Vec<T>::N) return (int)cudaErrorInvalidValue;
  epilogue_bwd_vec<T, L><<<rt::epilogue_vec_blocks(R, L), kThreads, 0, stream>>>(
      static_cast<const T*>(o1), static_cast<const T*>(o2), static_cast<const T*>(o3),
      static_cast<const float*>(g1), static_cast<const float*>(g2),
      static_cast<const float*>(g3), static_cast<const float*>(m),
      static_cast<const T*>(dout), static_cast<T*>(do1), static_cast<T*>(do2),
      static_cast<T*>(do3), static_cast<float*>(dg1), static_cast<float*>(dg2),
      static_cast<float*>(dg3), R, D);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* o1, const void* o2, const void* o3, const void* g1,
           const void* g2, const void* g3, const void* m, const void* dout,
           void* do1, void* do2, void* do3, void* dg1, void* dg2, void* dg3,
           int R, int D, int lanes, cudaStream_t stream) {
  if (R == 0) return 0;
#define EPI_ARGS o1, o2, o3, g1, g2, g3, m, dout, do1, do2, do3, dg1, dg2, dg3, R, D, stream
  switch (lanes) {
    case 0: return launch_warp<T>(EPI_ARGS);
    case 1: return launch_vec<T, 1>(EPI_ARGS);
    case 2: return launch_vec<T, 2>(EPI_ARGS);
    case 4: return launch_vec<T, 4>(EPI_ARGS);
    case 8: return launch_vec<T, 8>(EPI_ARGS);
    case 16: return launch_vec<T, 16>(EPI_ARGS);
    case 32: return launch_vec<T, 32>(EPI_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef EPI_ARGS
}

}  // namespace

// lanes: 0 = the warp kernel, else the vec kernel with `lanes` lanes a row
// (kernels/epilogue.py::epilogue_plan)
extern "C" int epilogue_bwd(const void* o1, const void* o2, const void* o3,
                            const void* g1, const void* g2, const void* g3,
                            const void* m, const void* dout, void* do1, void* do2,
                            void* do3, void* dg1, void* dg2, void* dg3, int R, int D,
                            int bf16, int lanes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(o1, o2, o3, g1, g2, g3, m, dout, do1, do2, do3,
                                      dg1, dg2, dg3, R, D, lanes, s)
              : launch<float>(o1, o2, o3, g1, g2, g3, m, dout, do1, do2, do3, dg1,
                              dg2, dg3, R, D, lanes, s);
}
