// Packed-varlen streaming-softmax attention forward: T packed query rows
// against L packed keys, a query seeing only the keys of its own segment.
//
// Replaces repro/kernels/varlen.py::_fwd_kernel (Pallas, TPU).
//
// Layout (GQA-native): q (Hkv, rep, T, D), k/v (Hkv, L, D), key_bias (1, L)
// fp32, qseg (T) / kseg (L) int32 segment ids, k_bounds (S+2) int32: segment
// s owns keys [k_bounds[s], k_bounds[s+1]) (the capacity tail is segment S)
// -> o like q, lse (Hkv, rep, T) fp32.
//
// Design.  The TPU kernel walks the full (q-tile, k-tile) grid and skips the
// cells whose per-tile segment ranges do not overlap (scalar-prefetched
// ranges).  Here the skip is a key interval: one thread block owns 128
// consecutive query rows of one (KV head, query head of its group), reads
// the segment ids of its first and last row (ids are monotone along the
// axis) and folds only keys [k_bounds[s_first], k_bounds[s_last+1]), in
// tiles of 64 staged into shared memory as fp32; every thread folds its row
// through an online softmax (rt::fold_keys), masking keys of another segment
// (qseg != kseg) to NEG_INF on top of the key bias.  A key tile with no
// valid key is skipped whole (the capacity tail of the compression branch).
// A row that saw no valid key writes zeros and lse = LSE_EMPTY.
//
// Bound on the H100: the work is sum_i T_i * L_i (row, key) pairs of 4*D
// FLOP, so the fp32 FMA rate bounds it.  This first kernel uses the fp32
// pipes only, like flash_fwd.cu.
#include "common.cuh"

namespace {

constexpr int kRows = 128;   // query rows (threads) per block
constexpr int kTile = 64;    // keys per shared-memory tile

template <typename T, int D>
__global__ void __launch_bounds__(kRows)
varlen_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const float* __restrict__ key_bias,
                  const int* __restrict__ qseg, const int* __restrict__ kseg,
                  const int* __restrict__ k_bounds, T* __restrict__ o,
                  float* __restrict__ lse, int rep, int Tq, int L, float scale) {
  __shared__ __align__(16) float Ks[kTile * D];
  __shared__ __align__(16) float Vs[kTile * D];
  __shared__ float bs[kTile];
  __shared__ int ss[kTile];

  const int h = blockIdx.z;
  const int t0 = blockIdx.x * kRows;
  const int t = t0 + threadIdx.x;                           // query position
  const bool has_row = t < Tq;
  const size_t qrow = ((size_t)h * rep + blockIdx.y) * Tq + t;
  const int my_seg = has_row ? qseg[t] : -1;
  const int j_lo = k_bounds[qseg[t0]];
  const int j_hi = k_bounds[qseg[min(t0 + kRows, Tq) - 1] + 1];

  float qr[D];
  if (has_row) rt::load_row<T, D>(q + qrow * D, qr);
  rt::Row<D> st;
  const T* kh = k + (size_t)h * L * D;
  const T* vh = v + (size_t)h * L * D;
  for (int j0 = j_lo; j0 < j_hi; j0 += kTile) {
    const int n = min(kTile, j_hi - j0);
    __syncthreads();                       // previous tile fully consumed
    if (threadIdx.x < n) {
      bs[threadIdx.x] = key_bias[j0 + threadIdx.x];
      ss[threadIdx.x] = kseg[j0 + threadIdx.x];
    }
    const bool live = threadIdx.x < n && key_bias[j0 + threadIdx.x] > rt::NEG_HALF;
    if (!__syncthreads_or(live)) continue;  // no valid key in the tile
    rt::stage(kh + (size_t)j0 * D, Ks, n * D);
    rt::stage(vh + (size_t)j0 * D, Vs, n * D);
    __syncthreads();
    if (!has_row) continue;
    auto visible = [&](int j) { return ss[j] == my_seg; };
    rt::fold_keys<T, D>(qr, Ks, Vs, bs, n, scale, visible, st);
  }
  if (has_row) rt::write_row<T, D>(st, o + qrow * D, lse + qrow);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* key_bias,
           const void* qseg, const void* kseg, const void* k_bounds, void* o,
           void* lse, int H, int rep, int Tq, int L, cudaStream_t stream) {
  const dim3 grid((Tq + kRows - 1) / kRows, rep, H);
  varlen_fwd_kernel<T, D><<<grid, kRows, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(key_bias), static_cast<const int*>(qseg),
      static_cast<const int*>(kseg), static_cast<const int*>(k_bounds),
      static_cast<T*>(o), static_cast<float*>(lse), rep, Tq, L,
      (float)(1.0 / sqrt((double)D)));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int varlen_fwd(const void* q, const void* k, const void* v,
                          const void* key_bias, const void* qseg, const void* kseg,
                          const void* k_bounds, void* o, void* lse, int H, int rep,
                          int Tq, int L, int D, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  RT_DISPATCH_D(D, {
    return bf16 ? launch<__nv_bfloat16, kD>(q, k, v, key_bias, qseg, kseg, k_bounds,
                                            o, lse, H, rep, Tq, L, s)
                : launch<float, kD>(q, k, v, key_bias, qseg, kseg, k_bounds, o, lse,
                                    H, rep, Tq, L, s);
  });
  return 0;
}
