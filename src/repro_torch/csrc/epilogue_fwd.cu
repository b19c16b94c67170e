// Fused gated-combine epilogue forward over row-flattened branch outputs:
//   out = (g1*o1 + g2*o2 + g3*o3) * m,   accumulated in fp32.
//
// Replaces repro/kernels/epilogue.py::_fwd_kernel (Pallas, TPU), which
// takes a tile of rows a grid step with per-row gate and mask columns.
//
// Layout: o1..o3 (R, D) in the compute dtype, R = B*N*H rows (token-major,
// head-minor) -> out (R, D) in the dtype of o1.  The gates and the mask are
// read where the layer keeps them, never expanded to R rows first:
//   gate k of row r   g_k[(r / H) * gs_k + r % H]   fp32; gs_k = 0 for one
//                     gate a head (gate_mode "scalar", g_k (H,)), else the
//                     stride between tokens of a per-row gate (gate_mode
//                     "token": H for an (R,) gate, 3H for the (B*N, 3H)
//                     projection's slice that the layer hands over as is);
//   mask of row r     m[r / H], one byte a token (bool), or none (m null).
//
// Bound on the H100: memory -- three (R, D) tensors read and one written
// for six FLOP an element; the gates and the mask are a few bytes a row.
// The first version ran a grid-stride loop over R*D scalars with a 64-bit
// division a element, 2- or 4-byte accesses and a grid capped at 132 x 16
// blocks, and reached 62-67% of the bound on the LM shapes; the caller
// also expanded the gates and the mask to four (R,) fp32 copies, four more
// launches a layer.  Two kernels, chosen by kernels/epilogue.py::epilogue_plan
// (the wrapper passes `lanes`):
//   vec   D a multiple of one 16-byte vector and every (R, D) tensor 16-byte
//         aligned: a row on L lanes by epilogue.cuh's rule, shared with
//         epilogue_bwd_vec (L = D/4 fp32, D/8 bf16, up to 32).  Each lane
//         reads its row's three gates and mask once (one division by H a
//         thread), then 16-byte vectors of o1..o3 and stores 16-byte
//         vectors of out.  One row group a thread: R*L/256 blocks, no cap,
//         so every SM keeps many 16-byte loads in flight.
//   warp  any other D or alignment: one warp a row, lanes on neighbouring
//         elements; eight rows a block, R/8 blocks.
// Both keep the first version's expression, g1*o1 + g2*o2 + g3*o3 in fp32
// and then times the mask (1 where m is null), so the outputs keep its bits.
#include "epilogue.cuh"

namespace {

constexpr int kThreads = rt::kEpilogueThreads;
constexpr int kWarps = kThreads / 32;   // rows a block (warp kernel)

struct Gates {
  const float* g1;
  const float* g2;
  const float* g3;
  const uint8_t* m;
  int H, gs1, gs2, gs3;
};

// The gates and the mask of row r.
struct RowGates {
  float a1, a2, a3, mr;
  __device__ __forceinline__ RowGates(const Gates& G, size_t r) {
    const unsigned tok = (unsigned)r / (unsigned)G.H;
    const unsigned h = (unsigned)r - tok * (unsigned)G.H;
    a1 = G.g1[(size_t)tok * G.gs1 + h];
    a2 = G.g2[(size_t)tok * G.gs2 + h];
    a3 = G.g3[(size_t)tok * G.gs3 + h];
    mr = G.m ? (float)G.m[tok] : 1.f;
  }
  __device__ __forceinline__ float apply(float x1, float x2, float x3) const {
    const float acc = a1 * x1 + a2 * x2 + a3 * x3;
    return acc * mr;
  }
};

template <typename T, int L>
__global__ void __launch_bounds__(kThreads)
epilogue_fwd_vec(const T* __restrict__ o1, const T* __restrict__ o2,
                 const T* __restrict__ o3, const Gates G, T* __restrict__ out, int R,
                 int D) {
  using V = rt::Vec<T>;
  constexpr int N = V::N;
  const rt::RowLane<L> at;
  if (at.row >= (size_t)R) return;
  const RowGates g(G, at.row);
  for (int c = at.sub * N; c < D; c += L * N) {
    const size_t i = at.row * D + c;
    float x1[N], x2[N], x3[N], y[N];
    V::load(o1 + i, x1);
    V::load(o2 + i, x2);
    V::load(o3 + i, x3);
#pragma unroll
    for (int e = 0; e < N; ++e) y[e] = g.apply(x1[e], x2[e], x3[e]);
    V::store(out + i, y);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
epilogue_fwd_warp(const T* __restrict__ o1, const T* __restrict__ o2,
                  const T* __restrict__ o3, const Gates G, T* __restrict__ out, int R,
                  int D) {
  const size_t r = (size_t)blockIdx.x * kWarps + threadIdx.x / 32;
  if (r >= (size_t)R) return;
  const RowGates g(G, r);
  for (int d = threadIdx.x % 32; d < D; d += 32) {
    const size_t i = r * D + d;
    out[i] = rt::from_f<T>(g.apply(rt::to_f(o1[i]), rt::to_f(o2[i]), rt::to_f(o3[i])));
  }
}

template <typename T>
int launch(const void* o1, const void* o2, const void* o3, const Gates& G, void* out,
           int R, int D, int lanes, cudaStream_t stream) {
  if (R == 0) return 0;
  if (G.H <= 0) return (int)cudaErrorInvalidValue;
  const T* a = static_cast<const T*>(o1);
  const T* b = static_cast<const T*>(o2);
  const T* c = static_cast<const T*>(o3);
  T* y = static_cast<T*>(out);
  if (lanes == 0) {
    epilogue_fwd_warp<T><<<(unsigned)((R + kWarps - 1) / kWarps), kThreads, 0, stream>>>(
        a, b, c, G, y, R, D);
    return (int)cudaGetLastError();
  }
  if (D % rt::Vec<T>::N) return (int)cudaErrorInvalidValue;
  switch (lanes) {
#define EPI_VEC(L)                                                                    \
  case L:                                                                             \
    epilogue_fwd_vec<T, L><<<rt::epilogue_vec_blocks(R, L), kThreads, 0, stream>>>( \
        a, b, c, G, y, R, D);                                                         \
    break;
    EPI_VEC(1) EPI_VEC(2) EPI_VEC(4) EPI_VEC(8) EPI_VEC(16) EPI_VEC(32)
#undef EPI_VEC
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// g1..g3: fp32 gates, gate k of row r at g_k[(r / H) * gs_k + r % H];
// m: one byte a token (r / H) or null; lanes: 0 = the warp kernel, else the
// vec kernel with `lanes` lanes a row (kernels/epilogue.py::epilogue_plan)
extern "C" int epilogue_fwd(const void* o1, const void* o2, const void* o3,
                            const void* g1, const void* g2, const void* g3,
                            const void* m, void* out, int R, int D, int H, int gs1,
                            int gs2, int gs3, int bf16, int lanes, void* stream) {
  const Gates G{static_cast<const float*>(g1), static_cast<const float*>(g2),
                static_cast<const float*>(g3), static_cast<const uint8_t*>(m), H, gs1,
                gs2, gs3};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(o1, o2, o3, G, out, R, D, lanes, s)
              : launch<float>(o1, o2, o3, G, out, R, D, lanes, s);
}
