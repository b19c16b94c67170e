// Packed-varlen streaming-softmax attention backward, recomputed from the
// forward's lse: two kernels that share their inputs, the segment test and
// the recompute of p.
//
// Replaces repro/kernels/varlen.py::_dq_kernel (varlen_dq) and ::_dkv_kernel
// (varlen_dkv) (Pallas, TPU).
//
// Layout (GQA-native): q, dO (Hkv, rep, T, D), k/v (Hkv, L, D), key_bias
// (1, L) fp32, qseg (T) / kseg (L) int32 segment ids, q_bounds / k_bounds
// (S+2) int32 segment boundaries of the two axes, lse and delta =
// rowsum(dO*O) (Hkv, rep, T) fp32 -> dq like q (varlen_dq), dk/dv like k
// (varlen_dkv).
//
// Design.  The TPU kernels walk the full grids (dQ over K tiles, dK/dV over
// Q tiles) and skip cells whose segment ranges do not overlap.  Here, as in
// varlen_fwd.cu, the skip is an interval, and each sum is a loop inside one
// block (Hopper blocks run in no order):
//   varlen_dq   the forward's grid: a block owns 128 query rows of one (KV
//               head, query head), folds only the keys of its rows'
//               segments [k_bounds[s_first], k_bounds[s_last+1]) in tiles of
//               64: p = exp(s - lse), dS = p*(dO.v - delta)*scale,
//               dq += dS*k.
//   varlen_dkv  the transposed grid: a block owns 32 keys (one a thread, with
//               k, v, dk, dv in registers), stages tiles of 64 query rows
//               (Q, dO, lse, delta, segment ids) of its keys' segments
//               [q_bounds[s_first], q_bounds[s_last+1]) for each of the rep
//               query heads of the group and folds them: dv += p*dO,
//               dk += dS*q -- the GQA group's sum is this loop, so no other
//               block touches the key's gradient.
// A (row, key) pair of two segments is masked like a masked key.  p and dS
// are rounded to the operand dtype before their products.  Rows with
// lse = LSE_EMPTY (they saw no valid key) give p = 0: a 128-row tile of
// such rows writes zeros and stops, and such rows are skipped in
// varlen_dkv; a key block with no valid key writes zeros and stops.
//
// Bound on the H100: 10*D FLOP per same-segment (row, key) pair for the
// whole backward, so the fp32 FMA rate bounds it.  This first version
// recomputes s and dO.v in both kernels and uses the fp32 pipes only;
// varlen_dkv, one thread a key, keeps flash_dkv's low parallelism.
#include "common.cuh"

namespace {

constexpr int kRows = 128;   // varlen_dq: query rows (threads) per block
constexpr int kTile = 64;    // varlen_dq: keys per staged tile
// varlen_dkv: keys (threads) per block.  32, not 64: the pooled key axis's
// segment boundaries fall at multiples of ball/ell (32 for ball 256, ell 8),
// and a block that straddles one walks the query rows of both segments;
// every block runs in one wave, so the slowest block sets the kernel's time
constexpr int kKeys = 32;
constexpr int kQTile = 64;   // varlen_dkv: query rows per staged tile

template <typename T, int D>
__global__ void __launch_bounds__(kRows)
varlen_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ key_bias,
                 const int* __restrict__ qseg, const int* __restrict__ kseg,
                 const int* __restrict__ k_bounds, const T* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 T* __restrict__ dq, int rep, int Tq, int L, float scale) {
  __shared__ __align__(16) float Ks[kTile * D];
  __shared__ __align__(16) float Vs[kTile * D];
  __shared__ float bs[kTile];
  __shared__ int ss[kTile];

  const int h = blockIdx.z;
  const int t0 = blockIdx.x * kRows;
  const int t = t0 + threadIdx.x;                           // query position
  const bool has_row = t < Tq;
  const size_t row0 = ((size_t)h * rep + blockIdx.y) * Tq + t0;
  const size_t qrow = row0 + threadIdx.x;
  const float l = has_row ? lse[qrow] : rt::LSE_EMPTY;
  const bool live = l < rt::LSE_HALF;

  if (!__syncthreads_or(live)) {           // every row empty: dq == 0
    rt::store_zeros(dq + row0 * D, min(kRows, Tq - t0) * D);
    return;
  }
  const int my_seg = has_row ? qseg[t] : -1;
  const int j_lo = k_bounds[qseg[t0]];
  const int j_hi = k_bounds[qseg[min(t0 + kRows, Tq) - 1] + 1];
  float qr[D], dor[D], acc[D];
  if (has_row) {
    rt::load_row<T, D>(q + qrow * D, qr);
    rt::load_row<T, D>(dout + qrow * D, dor);
  }
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  const float dl = has_row ? delta[qrow] : 0.f;
  const T* kh = k + (size_t)h * L * D;
  const T* vh = v + (size_t)h * L * D;
  for (int j0 = j_lo; j0 < j_hi; j0 += kTile) {
    const int n = min(kTile, j_hi - j0);
    __syncthreads();                       // previous tile fully consumed
    if (threadIdx.x < n) {
      bs[threadIdx.x] = key_bias[j0 + threadIdx.x];
      ss[threadIdx.x] = kseg[j0 + threadIdx.x];
    }
    const bool live_key = threadIdx.x < n && key_bias[j0 + threadIdx.x] > rt::NEG_HALF;
    if (!__syncthreads_or(live_key)) continue;   // no valid key in the tile
    rt::stage(kh + (size_t)j0 * D, Ks, n * D);
    rt::stage(vh + (size_t)j0 * D, Vs, n * D);
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < n; ++j) {
      if (ss[j] != my_seg) continue;
      const float p = rt::p_from_lse(rt::dot_row<D>(qr, Ks + j * D) * scale + bs[j], l);
      if (p == 0.f) continue;
      const float ds = p * (rt::dot_row<D>(dor, Vs + j * D) - dl) * scale;
      rt::axpy_row<D>(acc, rt::pv_operand<T>(ds), Ks + j * D);
    }
  }
  if (has_row) rt::store_row<T, D>(acc, dq + qrow * D);
}

template <typename T, int D>
__global__ void __launch_bounds__(kKeys)
varlen_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const float* __restrict__ key_bias,
                  const int* __restrict__ qseg, const int* __restrict__ kseg,
                  const int* __restrict__ q_bounds, const T* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  T* __restrict__ dk, T* __restrict__ dv, int rep, int Tq, int L,
                  float scale) {
  __shared__ __align__(16) float Qs[kQTile * D];
  __shared__ __align__(16) float Ds[kQTile * D];
  __shared__ float ls[kQTile];
  __shared__ float dls[kQTile];
  __shared__ int ss[kQTile];

  const int h = blockIdx.y;
  const int j0 = blockIdx.x * kKeys;
  const int j = j0 + threadIdx.x;                           // this thread's key
  const bool has_key = j < L;
  const size_t krow = (size_t)h * L + j;
  float kr[D], vr[D], dka[D], dva[D];
  float bj = rt::NEG_INF;
  int my_seg = -1;
  if (has_key) {
    rt::load_row<T, D>(k + krow * D, kr);
    rt::load_row<T, D>(v + krow * D, vr);
    bj = key_bias[j];
    my_seg = kseg[j];
  }
#pragma unroll
  for (int d = 0; d < D; ++d) dka[d] = dva[d] = 0.f;
  const bool live_key = bj > rt::NEG_HALF;
  if (__syncthreads_or(live_key)) {
    const int i_lo = q_bounds[kseg[j0]];
    const int i_hi = q_bounds[kseg[min(j0 + kKeys, L) - 1] + 1];
    for (int r = 0; r < rep; ++r) {
      const size_t base = ((size_t)h * rep + r) * Tq;
      for (int i0 = i_lo; i0 < i_hi; i0 += kQTile) {
        const int n = min(kQTile, i_hi - i0);
        __syncthreads();                   // previous tile fully consumed
        rt::stage(q + (base + i0) * D, Qs, n * D);
        rt::stage(dout + (base + i0) * D, Ds, n * D);
        rt::stage(lse + base + i0, ls, n);
        rt::stage(delta + base + i0, dls, n);
        for (int i = threadIdx.x; i < n; i += blockDim.x) ss[i] = qseg[i0 + i];
        __syncthreads();
        if (!live_key) continue;
        for (int i = 0; i < n; ++i) {
          const float l = ls[i];
          if (l >= rt::LSE_HALF || ss[i] != my_seg) continue;   // p == 0
          const float p = rt::p_from_lse(rt::dot_row<D>(kr, Qs + i * D) * scale + bj, l);
          if (p == 0.f) continue;
          rt::axpy_row<D>(dva, rt::pv_operand<T>(p), Ds + i * D);
          const float ds = p * (rt::dot_row<D>(vr, Ds + i * D) - dls[i]) * scale;
          rt::axpy_row<D>(dka, rt::pv_operand<T>(ds), Qs + i * D);
        }
      }
    }
  }
  if (has_key) {
    rt::store_row<T, D>(dka, dk + krow * D);
    rt::store_row<T, D>(dva, dv + krow * D);
  }
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* key_bias,
              const void* qseg, const void* kseg, const void* k_bounds,
              const void* dout, const void* lse, const void* delta, void* dq, int H,
              int rep, int Tq, int L, cudaStream_t stream) {
  const dim3 grid((Tq + kRows - 1) / kRows, rep, H);
  varlen_dq_kernel<T, D><<<grid, kRows, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(key_bias), static_cast<const int*>(qseg),
      static_cast<const int*>(kseg), static_cast<const int*>(k_bounds),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dq), rep, Tq, L,
      (float)(1.0 / sqrt((double)D)));
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* key_bias,
               const void* qseg, const void* kseg, const void* q_bounds,
               const void* dout, const void* lse, const void* delta, void* dk,
               void* dv, int H, int rep, int Tq, int L, cudaStream_t stream) {
  const dim3 grid((L + kKeys - 1) / kKeys, H);
  varlen_dkv_kernel<T, D><<<grid, kKeys, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(key_bias), static_cast<const int*>(qseg),
      static_cast<const int*>(kseg), static_cast<const int*>(q_bounds),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv), rep,
      Tq, L, (float)(1.0 / sqrt((double)D)));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int varlen_dq(const void* q, const void* k, const void* v,
                         const void* key_bias, const void* qseg, const void* kseg,
                         const void* q_bounds, const void* k_bounds, const void* dout,
                         const void* lse, const void* delta, void* dq, int H, int rep,
                         int Tq, int L, int D, int bf16, void* stream) {
  (void)q_bounds;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  RT_DISPATCH_D(D, {
    return bf16 ? launch_dq<__nv_bfloat16, kD>(q, k, v, key_bias, qseg, kseg, k_bounds,
                                               dout, lse, delta, dq, H, rep, Tq, L, s)
                : launch_dq<float, kD>(q, k, v, key_bias, qseg, kseg, k_bounds, dout,
                                       lse, delta, dq, H, rep, Tq, L, s);
  });
  return 0;
}

extern "C" int varlen_dkv(const void* q, const void* k, const void* v,
                          const void* key_bias, const void* qseg, const void* kseg,
                          const void* q_bounds, const void* k_bounds, const void* dout,
                          const void* lse, const void* delta, void* dk, void* dv, int H,
                          int rep, int Tq, int L, int D, int bf16, void* stream) {
  (void)k_bounds;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  RT_DISPATCH_D(D, {
    return bf16 ? launch_dkv<__nv_bfloat16, kD>(q, k, v, key_bias, qseg, kseg,
                                                q_bounds, dout, lse, delta, dk, dv, H,
                                                rep, Tq, L, s)
                : launch_dkv<float, kD>(q, k, v, key_bias, qseg, kseg, q_bounds, dout,
                                        lse, delta, dk, dv, H, rep, Tq, L, s);
  });
  return 0;
}
