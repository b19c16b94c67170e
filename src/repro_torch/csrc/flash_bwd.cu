// Streaming-softmax attention backward, recomputed from the forward's lse:
// two kernels that share their inputs, the mask code and the recompute of p.
//
// Replaces repro/kernels/flash.py::_dq_kernel (flash_dq) and ::_dkv_kernel
// (flash_dkv) (Pallas, TPU), masks as in flash.py::_mask_logits:
//   causal        key j visible to query t iff j <= t,
//   block_causal  coarse key j visible iff (j+1)*ell - 1 < t.
//
// Layout (GQA-native): q, dO (B*Hkv, rep, N, D), k/v (B*Hkv, L, D), key_bias
// (B, L) fp32, lse and delta = rowsum(dO*O) (B*Hkv, rep, N) fp32
// -> dq like q (flash_dq), dk/dv like k (flash_dkv).
//
// Design.  The TPU accumulated dQ over sequential K-tile grid steps and
// dK/dV over sequential Q-tile steps.  Hopper blocks run in no order, so
// each sum is a loop inside one block:
//   flash_dq   the forward's grid: a block owns 128 query rows of one
//              (batch*KV-head), stages K/V tiles of 64 keys into shared
//              memory, and every thread folds its row: p = exp(s - lse),
//              dS = p*(dO.v - delta)*scale, dq += dS*k.
//   flash_dkv  the transposed grid: a block owns 64 keys (one a thread, with
//              k, v, dk, dv in registers), stages tiles of 64 query rows
//              (Q, dO, lse, delta) of all rep heads of the group and folds
//              them: dv += p*dO, dk += dS*q -- the GQA group's sum is this
//              loop, so no other block touches the key's gradient.
// p and dS are rounded to the operand dtype before their products.  Rows
// with lse = LSE_EMPTY (the forward skipped them, or they see no key) give
// p = 0: a 128-row tile of such rows writes zeros and stops, and such rows
// are skipped in flash_dkv.  The ragged key edge (L = 480) is masked here.
//
// Bound on the H100: at the compression branch's shapes (N = 3840,
// L = 480, D = 32, fp32) the five products are 10*L*D FLOP per query row,
// so the fp32 FMA rate bounds it.  This first version recomputes s and dO.v
// in both kernels and uses the fp32 pipes only.
#include "common.cuh"

namespace {

constexpr int kRows = 128;   // flash_dq: query rows (threads) per block
constexpr int kTile = 64;    // flash_dq: keys per tile; flash_dkv: keys per block
constexpr int kQTile = 64;   // flash_dkv: query rows per staged tile

struct Mask {
  int causal, block_causal, ell;
  __device__ __forceinline__ bool visible(int key, int t) const {
    if (block_causal) return (key + 1) * ell - 1 < t;
    if (causal) return key <= t;
    return true;
  }
};

template <typename T, int D>
__global__ void __launch_bounds__(kRows)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ key_bias,
                const T* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dq, int rep, int N,
                int L, int n_heads, Mask mask, float scale) {
  __shared__ __align__(16) float Ks[kTile * D];
  __shared__ __align__(16) float Vs[kTile * D];
  __shared__ float bs[kTile];

  const int bh = blockIdx.y;
  const int b = bh / n_heads;
  const int row0 = blockIdx.x * kRows;
  const int row = row0 + threadIdx.x;                      // in [0, rep*N)
  const bool has_row = row < rep * N;
  const int t = row % N;                                    // query position
  const size_t qrow = (size_t)bh * rep * N + row;
  const float l = has_row ? lse[qrow] : rt::LSE_EMPTY;
  const bool live = l < rt::LSE_HALF;

  if (!__syncthreads_or(live)) {           // every row empty: dq == 0
    const int n = min(kRows, rep * N - row0);
    rt::store_zeros(dq + ((size_t)bh * rep * N + row0) * D, n * D);
    return;
  }
  float qr[D], dor[D], acc[D];
  if (has_row) {
    rt::load_row<T, D>(q + qrow * D, qr);
    rt::load_row<T, D>(dout + qrow * D, dor);
  }
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  const float dl = has_row ? delta[qrow] : 0.f;
  const T* kb = k + (size_t)bh * L * D;
  const T* vb = v + (size_t)bh * L * D;
  const float* biasb = key_bias + (size_t)b * L;
  for (int j0 = 0; j0 < L; j0 += kTile) {
    const int n = min(kTile, L - j0);
    __syncthreads();                       // previous tile fully consumed
    rt::stage(kb + (size_t)j0 * D, Ks, n * D);
    rt::stage(vb + (size_t)j0 * D, Vs, n * D);
    rt::stage(biasb + j0, bs, n);
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < n; ++j) {
      if (!mask.visible(j0 + j, t)) continue;
      const float p = rt::p_from_lse(rt::dot_row<D>(qr, Ks + j * D) * scale + bs[j], l);
      if (p == 0.f) continue;
      const float ds = p * (rt::dot_row<D>(dor, Vs + j * D) - dl) * scale;
      rt::axpy_row<D>(acc, rt::pv_operand<T>(ds), Ks + j * D);
    }
  }
  if (has_row) rt::store_row<T, D>(acc, dq + qrow * D);
}

template <typename T, int D>
__global__ void __launch_bounds__(kTile)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ key_bias,
                 const T* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dk,
                 T* __restrict__ dv, int rep, int N, int L, int n_heads, Mask mask,
                 float scale) {
  __shared__ __align__(16) float Qs[kQTile * D];
  __shared__ __align__(16) float Ds[kQTile * D];
  __shared__ float ls[kQTile];
  __shared__ float dls[kQTile];

  const int bh = blockIdx.y;
  const int b = bh / n_heads;
  const int j = blockIdx.x * kTile + threadIdx.x;           // this thread's key
  const bool has_key = j < L;
  const size_t krow = (size_t)bh * L + j;
  float kr[D], vr[D], dka[D], dva[D];
  float bj = rt::NEG_INF;
  if (has_key) {
    rt::load_row<T, D>(k + krow * D, kr);
    rt::load_row<T, D>(v + krow * D, vr);
    bj = key_bias[(size_t)b * L + j];
  }
#pragma unroll
  for (int d = 0; d < D; ++d) dka[d] = dva[d] = 0.f;
  const bool live_key = bj > rt::NEG_HALF;
  const int rows = rep * N;
  const size_t base = (size_t)bh * rows;
  for (int i0 = 0; i0 < rows; i0 += kQTile) {
    const int n = min(kQTile, rows - i0);
    __syncthreads();                       // previous tile fully consumed
    rt::stage(q + (base + i0) * D, Qs, n * D);
    rt::stage(dout + (base + i0) * D, Ds, n * D);
    rt::stage(lse + base + i0, ls, n);
    rt::stage(delta + base + i0, dls, n);
    __syncthreads();
    if (!live_key) continue;
    for (int i = 0; i < n; ++i) {
      const float l = ls[i];
      if (l >= rt::LSE_HALF) continue;     // empty row: p == 0
      if (!mask.visible(j, (i0 + i) % N)) continue;
      const float p = rt::p_from_lse(rt::dot_row<D>(kr, Qs + i * D) * scale + bj, l);
      if (p == 0.f) continue;
      rt::axpy_row<D>(dva, rt::pv_operand<T>(p), Ds + i * D);
      const float ds = p * (rt::dot_row<D>(vr, Ds + i * D) - dls[i]) * scale;
      rt::axpy_row<D>(dka, rt::pv_operand<T>(ds), Qs + i * D);
    }
  }
  if (has_key) {
    rt::store_row<T, D>(dka, dk + krow * D);
    rt::store_row<T, D>(dva, dv + krow * D);
  }
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* key_bias,
              const void* dout, const void* lse, const void* delta, void* dq, int BH,
              int rep, int N, int L, int n_heads, Mask mask, cudaStream_t stream) {
  const dim3 grid((rep * N + kRows - 1) / kRows, BH);
  flash_dq_kernel<T, D><<<grid, kRows, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(key_bias), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), rep, N, L, n_heads, mask, (float)(1.0 / sqrt((double)D)));
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* key_bias,
               const void* dout, const void* lse, const void* delta, void* dk,
               void* dv, int BH, int rep, int N, int L, int n_heads, Mask mask,
               cudaStream_t stream) {
  const dim3 grid((L + kTile - 1) / kTile, BH);
  flash_dkv_kernel<T, D><<<grid, kTile, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(key_bias), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), rep, N, L, n_heads, mask,
      (float)(1.0 / sqrt((double)D)));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_dq(const void* q, const void* k, const void* v,
                        const void* key_bias, const void* dout, const void* lse,
                        const void* delta, void* dq, int BH, int rep, int N, int L,
                        int D, int n_heads, int causal, int block_causal, int ell,
                        int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Mask mask{causal, block_causal, ell};
  RT_DISPATCH_D(D, {
    return bf16 ? launch_dq<__nv_bfloat16, kD>(q, k, v, key_bias, dout, lse, delta, dq,
                                               BH, rep, N, L, n_heads, mask, s)
                : launch_dq<float, kD>(q, k, v, key_bias, dout, lse, delta, dq, BH,
                                       rep, N, L, n_heads, mask, s);
  });
  return 0;
}

extern "C" int flash_dkv(const void* q, const void* k, const void* v,
                         const void* key_bias, const void* dout, const void* lse,
                         const void* delta, void* dk, void* dv, int BH, int rep,
                         int N, int L, int D, int n_heads, int causal,
                         int block_causal, int ell, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Mask mask{causal, block_causal, ell};
  RT_DISPATCH_D(D, {
    return bf16 ? launch_dkv<__nv_bfloat16, kD>(q, k, v, key_bias, dout, lse, delta,
                                                dk, dv, BH, rep, N, L, n_heads, mask, s)
                : launch_dkv<float, kD>(q, k, v, key_bias, dout, lse, delta, dk, dv,
                                        BH, rep, N, L, n_heads, mask, s);
  });
  return 0;
}
