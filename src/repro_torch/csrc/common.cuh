// Shared device code of the port's attention kernels (sm_90a).
//
// Masking follows repro_torch/numerics.py: a masked key carries an additive
// fp32 bias of NEG_INF (-1e30), statistics guard at NEG_INF/2, a row with no
// valid key gives exact zeros and lse = LSE_EMPTY.  No -inf anywhere, so an
// all-masked row never produces NaN.
//
// Precision contract (kernels/common.py::resolve_compute_dtype): bf16 inputs
// are widened to fp32 on load (or multiplied as bf16 on the tensor cores,
// flash_bwd.cu), so QK^T products are exact and accumulate in fp32; the
// probabilities are rounded to bf16 before PV, as a bf16 tensor-core operand
// would be; every softmax statistic is fp32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace rt {

constexpr float NEG_INF = -1e30f;
constexpr float NEG_HALF = -5e29f;      // NEG_INF / 2
constexpr float LSE_EMPTY = 1e30f;
constexpr float LSE_HALF = 5e29f;       // lse at or above: an empty row

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

// Normalised probability recomputed from a logit and its row's lse residual
// (repro/kernels/common.py::p_from_lse): exp(s - lse), exactly 0 for a
// masked logit.  A row with lse = LSE_EMPTY gives 0 for every finite s.
__device__ __forceinline__ float p_from_lse(float s, float lse) {
  return s <= NEG_HALF ? 0.f : expf(s - lse);
}

// The same on the MUFU unit (__expf: ex2.approx, a few ulp): the bf16
// tensor-core kernels, whose p is rounded to bf16 before its products, use
// it; at their tile sizes the exact expf's range reduction, not the
// products, sets their pace.
__device__ __forceinline__ float p_from_lse_fast(float s, float lse) {
  return s <= NEG_HALF ? 0.f : __expf(s - lse);
}

// The index masks of the flash kernels (repro/kernels/flash.py::_mask_logits):
//   causal        key j visible to query t iff j <= t,
//   block_causal  coarse key j visible iff (j+1)*ell - 1 < t.
struct Mask {
  int causal, block_causal, ell;
  __device__ __forceinline__ bool visible(int key, int t) const {
    if (block_causal) return (key + 1) * ell <= t;
    if (causal) return key <= t;
    return true;
  }
  // the first position that sees key j
  __device__ __forceinline__ int first_t(int key) const {
    if (block_causal) return (key + 1) * ell;
    if (causal) return key;
    return 0;
  }
  // how many keys (0, 1, ...) position t sees
  __device__ __forceinline__ int keys_seen(int t) const {
    if (block_causal) return t / ell;
    if (causal) return t + 1;
    return INT_MAX;
  }
};

// Sum of a value over the `width` lanes of an aligned lane group.
template <int width>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = 1; o < width; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Dot product of a register row with a row of D floats in shared memory
// (16-byte aligned), read as float4 broadcasts; four partial sums.
template <int D>
__device__ __forceinline__ float dot_row(const float (&a)[D], const float* row) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll
  for (int d4 = 0; d4 < D / 4; ++d4) {
    const float4 x = r4[d4];
    s0 = fmaf(a[4 * d4 + 0], x.x, s0);
    s1 = fmaf(a[4 * d4 + 1], x.y, s1);
    s2 = fmaf(a[4 * d4 + 2], x.z, s2);
    s3 = fmaf(a[4 * d4 + 3], x.w, s3);
  }
  return (s0 + s1) + (s2 + s3);
}

// acc += a * row, the row of D floats in shared memory.
template <int D>
__device__ __forceinline__ void axpy_row(float (&acc)[D], float a, const float* row) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int d4 = 0; d4 < D / 4; ++d4) {
    const float4 x = r4[d4];
    acc[4 * d4 + 0] = fmaf(a, x.x, acc[4 * d4 + 0]);
    acc[4 * d4 + 1] = fmaf(a, x.y, acc[4 * d4 + 1]);
    acc[4 * d4 + 2] = fmaf(a, x.z, acc[4 * d4 + 2]);
    acc[4 * d4 + 3] = fmaf(a, x.w, acc[4 * d4 + 3]);
  }
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

template <typename T, int D>
__device__ __forceinline__ void store_row(const float (&x)[D], T* dst) {
#pragma unroll
  for (int d = 0; d < D; ++d) dst[d] = from_f<T>(x[d]);
}

template <typename T>
__device__ __forceinline__ void store_zeros(T* dst, int count) {
  for (int i = threadIdx.x; i < count; i += blockDim.x) dst[i] = from_f<T>(0.f);
}

// Copy n rows of D elements into shared memory as fp32, all threads of the
// block cooperating (neighbouring threads on neighbouring addresses).
template <typename T>
__device__ __forceinline__ void stage(const T* src, float* dst, int count) {
  for (int i = threadIdx.x; i < count; i += blockDim.x) dst[i] = to_f(src[i]);
}

// Keys (or rows) per staged fp32 tile of the one-thread-a-row kernels: 64,
// and fewer at D = 128 so that two staged tiles stay at 32 KB of static
// shared memory (the 48 KB cap).
template <int D>
constexpr int kTileRows = D > 64 ? 4096 / D : 64;

}  // namespace rt

// Dispatch a templated launch over the head dims the port builds:
// RT_DISPATCH_D for the ball and packed-varlen kernels (16, 32, 64),
// RT_DISPATCH_D128 for the causal LM path's kernels (also 128).
#define RT_DISPATCH_D(D, ...)                                   \
  switch (D) {                                                  \
    case 16: { constexpr int kD = 16; __VA_ARGS__; break; }     \
    case 32: { constexpr int kD = 32; __VA_ARGS__; break; }     \
    case 64: { constexpr int kD = 64; __VA_ARGS__; break; }     \
    default: return (int)cudaErrorInvalidValue;                 \
  }

#define RT_DISPATCH_D128(D, ...)                                \
  switch (D) {                                                  \
    case 16: { constexpr int kD = 16; __VA_ARGS__; break; }     \
    case 32: { constexpr int kD = 32; __VA_ARGS__; break; }     \
    case 64: { constexpr int kD = 64; __VA_ARGS__; break; }     \
    case 128: { constexpr int kD = 128; __VA_ARGS__; break; }   \
    default: return (int)cudaErrorInvalidValue;                 \
  }
