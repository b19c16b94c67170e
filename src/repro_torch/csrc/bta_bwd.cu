// Ball-Tree Attention backward: dQ, dK, dV of full softmax attention inside
// each contiguous ball of m keys, recomputed from the forward's lse.
//
// Replaces repro/kernels/bta.py::_bwd_kernel (Pallas, TPU).
//
// Layout (GQA-native): q, dO (B*Hkv, rep, N, D), k/v (B*Hkv, N, D), key_bias
// (B, N) fp32, live (B, N/m) int32, lse and delta = rowsum(dO*O) (B*Hkv, rep,
// N) fp32 -> dq like q, dk/dv like k.
//
// Design.  The ball is the tile, so a ball's gradients depend on that ball
// alone and one thread block per (batch*KV-head, ball) produces all three in
// a single pass, as the TPU kernel does:
//   1. dQ: the ball's K, V and key bias are staged into shared memory as
//      fp32; each thread carries one query row (of the rep*m rows of the
//      group) over the ball's keys: s = q.k*scale + bias, p = exp(s - lse),
//      dS = p*(dO.v - delta)*scale, dq += dS*k.
//   2. dK, dV: each thread owns one key of the ball (k, v, dk, dv in
//      registers) and runs over the query rows, staged one rep head at a
//      time (Q, dO, lse, delta of the ball's m rows): dv += p*dO,
//      dk += dS*q.  Summing over the rep heads in this loop is the GQA
//      group's reduction, so no other block touches the key's gradient.
// p and dS are rounded to the operand dtype before their products (bf16 in,
// bf16 operands, fp32 sums).  Masked keys and rows with lse = LSE_EMPTY give
// p = 0 and are skipped; a dead ball (live = 0) writes exact zeros.
//
// Bound on the H100: at the paper's shapes (m = 256, D = 32, fp32) the five
// products are 10*m*D FLOP per query row against a few D-wide rows of bytes,
// so the fp32 FMA rate bounds it.  This first kernel recomputes s and dO.v
// in both passes and runs on the fp32 pipes (no tensor cores yet).
#include "common.cuh"

namespace {

template <typename T, int D>
__global__ void __launch_bounds__(256)
bta_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const float* __restrict__ key_bias,
               const int* __restrict__ live, const T* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv, int rep,
               int N, int m, int n_heads, float scale) {
  extern __shared__ float4 smem4[];
  float* A = reinterpret_cast<float*>(smem4);   // pass 1: K      pass 2: Q
  float* Bm = A + m * D;                        // pass 1: V      pass 2: dO
  float* c1 = Bm + m * D;                       // pass 1: bias   pass 2: lse
  float* c2 = c1 + m;                           //                pass 2: delta

  const int bh = blockIdx.y;
  const int ball = blockIdx.x;
  const int b = bh / n_heads;
  const int rows = rep * m;
  const size_t kv0 = ((size_t)bh * N + (size_t)ball * m) * D;

  if (live[b * (N / m) + ball] == 0) {          // all keys masked: p == 0
    for (int r = 0; r < rep; ++r)
      rt::store_zeros(dq + (((size_t)bh * rep + r) * N + (size_t)ball * m) * D, m * D);
    rt::store_zeros(dk + kv0, m * D);
    rt::store_zeros(dv + kv0, m * D);
    return;
  }

  // ---- pass 1: dQ, one query row per thread
  rt::stage(k + kv0, A, m * D);
  rt::stage(v + kv0, Bm, m * D);
  rt::stage(key_bias + (size_t)b * N + (size_t)ball * m, c1, m);
  __syncthreads();
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    const size_t qrow = ((size_t)bh * rep + r / m) * N + (size_t)ball * m + r % m;
    float qr[D], dor[D], acc[D];
    rt::load_row<T, D>(q + qrow * D, qr);
    rt::load_row<T, D>(dout + qrow * D, dor);
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] = 0.f;
    const float l = lse[qrow], dl = delta[qrow];
    if (l < rt::LSE_HALF) {
      for (int j = 0; j < m; ++j) {
        const float p = rt::p_from_lse(rt::dot_row<D>(qr, A + j * D) * scale + c1[j], l);
        if (p == 0.f) continue;
        const float ds = p * (rt::dot_row<D>(dor, Bm + j * D) - dl) * scale;
        rt::axpy_row<D>(acc, rt::pv_operand<T>(ds), A + j * D);
      }
    }
    rt::store_row<T, D>(acc, dq + qrow * D);
  }

  // ---- pass 2: dK, dV, one key per thread, query rows staged per rep head
  for (int j0 = 0; j0 < m; j0 += blockDim.x) {
    const int j = j0 + threadIdx.x;
    const bool has_key = j < m;
    float kr[D], vr[D], dka[D], dva[D];
    float bj = 0.f;
    if (has_key) {
      rt::load_row<T, D>(k + kv0 + (size_t)j * D, kr);
      rt::load_row<T, D>(v + kv0 + (size_t)j * D, vr);
      bj = key_bias[(size_t)b * N + (size_t)ball * m + j];
    }
#pragma unroll
    for (int d = 0; d < D; ++d) dka[d] = dva[d] = 0.f;
    for (int r = 0; r < rep; ++r) {
      const size_t row0 = ((size_t)bh * rep + r) * N + (size_t)ball * m;
      __syncthreads();                        // previous contents consumed
      rt::stage(q + row0 * D, A, m * D);
      rt::stage(dout + row0 * D, Bm, m * D);
      rt::stage(lse + row0, c1, m);
      rt::stage(delta + row0, c2, m);
      __syncthreads();
      if (!has_key || bj <= rt::NEG_HALF) continue;
      for (int i = 0; i < m; ++i) {
        const float l = c1[i];
        if (l >= rt::LSE_HALF) continue;      // empty row: p == 0
        const float p = rt::p_from_lse(rt::dot_row<D>(kr, A + i * D) * scale + bj, l);
        if (p == 0.f) continue;
        rt::axpy_row<D>(dva, rt::pv_operand<T>(p), Bm + i * D);
        const float ds = p * (rt::dot_row<D>(vr, Bm + i * D) - c2[i]) * scale;
        rt::axpy_row<D>(dka, rt::pv_operand<T>(ds), A + i * D);
      }
    }
    if (has_key) {
      rt::store_row<T, D>(dka, dk + kv0 + (size_t)j * D);
      rt::store_row<T, D>(dva, dv + kv0 + (size_t)j * D);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* key_bias,
           const void* live, const void* dout, const void* lse, const void* delta,
           void* dq, void* dk, void* dv, int BH, int rep, int N, int m, int n_heads,
           cudaStream_t stream) {
  const int rows = rep * m;
  const int threads = rows < 256 ? ((rows + 31) / 32) * 32 : 256;
  const dim3 grid(N / m, BH);
  const size_t smem = (size_t)(2 * m * D + 2 * m) * sizeof(float);
  auto kern = bta_bwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(key_bias), static_cast<const int*>(live),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dq), static_cast<T*>(dk),
      static_cast<T*>(dv), rep, N, m, n_heads, (float)(1.0 / sqrt((double)D)));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int bta_bwd(const void* q, const void* k, const void* v,
                       const void* key_bias, const void* live, const void* dout,
                       const void* lse, const void* delta, void* dq, void* dk,
                       void* dv, int BH, int rep, int N, int D, int m, int n_heads,
                       int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N % m != 0) return (int)cudaErrorInvalidValue;
  RT_DISPATCH_D(D, {
    return bf16 ? launch<__nv_bfloat16, kD>(q, k, v, key_bias, live, dout, lse, delta,
                                            dq, dk, dv, BH, rep, N, m, n_heads, s)
                : launch<float, kD>(q, k, v, key_bias, live, dout, lse, delta, dq, dk,
                                    dv, BH, rep, N, m, n_heads, s);
  });
  return 0;
}
