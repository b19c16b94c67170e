// Shared device code of the port's forward attention kernels (sm_90a).
//
// Masking follows repro_torch/numerics.py: a masked key carries an additive
// fp32 bias of NEG_INF (-1e30), statistics guard at NEG_INF/2, a row with no
// valid key gives exact zeros and lse = LSE_EMPTY.  No -inf anywhere, so an
// all-masked row never produces NaN.
//
// Precision contract (kernels/common.py::resolve_compute_dtype): bf16 inputs
// are widened to fp32 on load, so QK^T products are exact and accumulate in
// fp32; the probabilities are rounded to bf16 before PV, as a bf16 tensor-core
// operand would be; every softmax statistic is fp32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rt {

constexpr float NEG_INF = -1e30f;
constexpr float NEG_HALF = -5e29f;      // NEG_INF / 2
constexpr float LSE_EMPTY = 1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// the PV operand: p as the compute dtype would hold it
template <typename T> __device__ __forceinline__ float pv_operand(float p) {
  return to_f(from_f<T>(p));
}

// Online-softmax state of one query row, kept in registers by one thread.
template <int D>
struct Row {
  float m;               // running max of the logits seen
  float l;               // running sum of exp(s - m_safe)
  float acc[D];          // running sum of p * v
  __device__ __forceinline__ Row() : m(NEG_INF), l(0.f) {
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] = 0.f;
  }
};

// Fold n keys (K, V rows of D floats and their additive bias, all in shared
// memory) into the row state.  `visible(j)` applies an index mask on top of
// the bias (the flash kernel's causal modes); a masked key's logit is set to
// NEG_INF, as repro/kernels/flash.py::_mask_logits does.  Keys go in chunks
// of CH so that one rescale of the accumulator serves CH keys.
template <typename T, int D, typename Visible>
__device__ __forceinline__ void fold_keys(const float (&q)[D], const float* Ks,
                                          const float* Vs, const float* bias, int n,
                                          float scale, Visible visible, Row<D>& r) {
  constexpr int CH = 16;
  for (int j0 = 0; j0 < n; j0 += CH) {
    float s[CH];
    float cmax = NEG_INF;
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int j = j0 + c;
      float v = NEG_INF;
      if (j < n) {
        const float4* kr = reinterpret_cast<const float4*>(Ks + j * D);
        float dot = 0.f;
#pragma unroll
        for (int d4 = 0; d4 < D / 4; ++d4) {
          const float4 k4 = kr[d4];
          dot = fmaf(q[4 * d4 + 0], k4.x, dot);
          dot = fmaf(q[4 * d4 + 1], k4.y, dot);
          dot = fmaf(q[4 * d4 + 2], k4.z, dot);
          dot = fmaf(q[4 * d4 + 3], k4.w, dot);
        }
        v = dot * scale + bias[j];
        if (!visible(j)) v = NEG_INF;
      }
      s[c] = v;
      cmax = fmaxf(cmax, v);
    }
    const float m_new = fmaxf(r.m, cmax);
    const float m_safe = fmaxf(m_new, NEG_HALF);
    const float alpha = (r.m <= NEG_HALF) ? 0.f : expf(fminf(r.m - m_safe, 0.f));
    r.l *= alpha;
#pragma unroll
    for (int d = 0; d < D; ++d) r.acc[d] *= alpha;
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      if (s[c] > NEG_HALF) {
        const float p = expf(s[c] - m_safe);
        r.l += p;
        const float pv = pv_operand<T>(p);
        const float4* vr = reinterpret_cast<const float4*>(Vs + (j0 + c) * D);
#pragma unroll
        for (int d4 = 0; d4 < D / 4; ++d4) {
          const float4 v4 = vr[d4];
          r.acc[4 * d4 + 0] = fmaf(pv, v4.x, r.acc[4 * d4 + 0]);
          r.acc[4 * d4 + 1] = fmaf(pv, v4.y, r.acc[4 * d4 + 1]);
          r.acc[4 * d4 + 2] = fmaf(pv, v4.z, r.acc[4 * d4 + 2]);
          r.acc[4 * d4 + 3] = fmaf(pv, v4.w, r.acc[4 * d4 + 3]);
        }
      }
    }
    r.m = m_new;
  }
}

// Write o = acc / l (zeros when no key was valid) and the lse residual.
template <typename T, int D>
__device__ __forceinline__ void write_row(const Row<D>& r, T* o, float* lse) {
  const float inv = 1.f / fmaxf(r.l, 1e-20f);
#pragma unroll
  for (int d = 0; d < D; ++d) o[d] = from_f<T>(r.l > 0.f ? r.acc[d] * inv : 0.f);
  const float m_safe = fmaxf(r.m, NEG_HALF);
  *lse = r.l > 0.f ? m_safe + logf(fmaxf(r.l, 1e-30f)) : LSE_EMPTY;
}

// A row that attends nothing: zeros and LSE_EMPTY.
template <typename T, int D>
__device__ __forceinline__ void write_empty_row(T* o, float* lse) {
#pragma unroll
  for (int d = 0; d < D; ++d) o[d] = from_f<T>(0.f);
  *lse = LSE_EMPTY;
}

template <typename T, int D>
__device__ __forceinline__ void load_row(const T* src, float (&q)[D]) {
#pragma unroll
  for (int d = 0; d < D; ++d) q[d] = to_f(src[d]);
}

// Copy n rows of D elements into shared memory as fp32, all threads of the
// block cooperating (neighbouring threads on neighbouring addresses).
template <typename T>
__device__ __forceinline__ void stage(const T* src, float* dst, int count) {
  for (int i = threadIdx.x; i < count; i += blockDim.x) dst[i] = to_f(src[i]);
}

}  // namespace rt

// Dispatch a templated launch over the head dims the port builds.
#define RT_DISPATCH_D(D, ...)                                   \
  switch (D) {                                                  \
    case 16: { constexpr int kD = 16; __VA_ARGS__; break; }     \
    case 32: { constexpr int kD = 32; __VA_ARGS__; break; }     \
    case 64: { constexpr int kD = 64; __VA_ARGS__; break; }     \
    default: return (int)cudaErrorInvalidValue;                 \
  }
