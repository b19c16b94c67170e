// Packed-varlen streaming-softmax attention backward, recomputed from the
// forward's lse: the kernels share their inputs and the recompute of p.
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
// Bound on the H100: 10*D FLOP per same-segment (row, key) pair for the
// whole backward (6*D of them in varlen_dq, 8*D in varlen_dkv), so the fp32
// FMA rate bounds it.
//
// Design.  The TPU kernels walk the full grids (dQ over K tiles, dK/dV over
// Q tiles) and skip cells whose segment ranges do not overlap.  Here each sum
// is a loop inside one block (Hopper blocks run in no order), or a loop plus
// a fixed-order second pass.  Two paths each (kernels/varlen.py::varlen_plan):
//   fma   fp32.  Host plans from the offsets cut the segments into tiles that
//         never cross a segment boundary, so every pair a block visits is of
//         one segment and no segment test is left: the key bias and
//         lse = LSE_EMPTY mask the rest.
//     varlen_dq   the forward's plan (kernels/occupancy.py::varlen_row_tiles:
//                 each segment's rows in tiles of 64, the last ragged, each
//                 with its segment's keys; an int32 table (tiles, 4) of
//                 (first row, rows, first key, end key)).  Grid (tiles, rep,
//                 Hkv): a block runs flash_dq_fma's register-tiled block
//                 (csrc/fma_bwd.cuh) on its rows against its keys in 32-key
//                 tiles; each row's dQ is summed by its own threads in key
//                 order.  A tile whose rows are all LSE_EMPTY (the capacity
//                 tail's) writes zeros and stages nothing.
//     varlen_dkv  kernels/occupancy.py::varlen_dkv_tiles cuts each segment's
//                 keys into tiles of 64 (the segment's last tile ragged) and
//                 gives each tile its segment's rows cut into S splits of
//                 whole 64-row tiles: an int32 table (tiles, S, 4) of (first
//                 key, keys, first row, end row).  Grid (tiles, Hkv, S): a
//                 block runs flash_dkv_fma's register-tiled block
//                 (csrc/fma_bwd.cuh) on its keys and rows, the rep query
//                 heads of the group summed in its walk.  A tile with no
//                 valid key (the capacity tail's) writes zeros and walks
//                 nothing.  With S > 1 the splits write fp32 partials into ws
//                 (2, S, Hkv, L, D) and varlen_dkv_reduce sums them in split
//                 order and casts: no atomics, bit-reproducible.
//   rows  bf16 (no main path runs it).
//     varlen_dq   a block owns 128 query rows (one a thread) of one (KV
//                 head, query head), folds only the keys of its rows'
//                 segments [k_bounds[s_first], k_bounds[s_last+1]) in tiles
//                 of 64: p = exp(s - lse), dS = p*(dO.v - delta)*scale,
//                 dq += dS*k.
//     varlen_dkv  a block owns 32 keys (one a thread, with k, v, dk, dv in
//                 registers) and stages tiles of 64 query rows (Q, dO, lse,
//                 delta, segment ids) of its keys' segments
//                 [q_bounds[s_first], q_bounds[s_last+1]) for each of the rep
//                 query heads and folds them: dv += p*dO, dk += dS*q.
//     A pair of two segments is masked like a masked key.
// p and dS are rounded to the operand dtype before their products.  Rows
// with lse = LSE_EMPTY (they saw no valid key) give p = 0: a row tile of
// such rows writes zeros and stops, and such rows are skipped in
// varlen_dkv; a key block with no valid key writes zeros and stops.
#include "fma_bwd.cuh"

namespace {

constexpr int kRows = 128;   // varlen_dq_rows: query rows (threads) per block
constexpr int kTile = 64;    // varlen_dq_rows: keys per staged tile
// varlen_dkv_rows: keys (threads) per block.  32, not 64: the pooled key
// axis's segment boundaries fall at multiples of ball/ell (32 for ball 256,
// ell 8), and a block that straddles one walks the query rows of both
// segments
constexpr int kKeys = 32;
constexpr int kQTile = 64;   // varlen_dkv_rows: query rows per staged tile

template <typename T, int D>
__global__ void __launch_bounds__(kRows)
varlen_dq_rows(const T* __restrict__ q, const T* __restrict__ k,
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
varlen_dkv_rows(const T* __restrict__ q, const T* __restrict__ k,
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

// varlen_dq, fp32: the dQ block of csrc/fma_bwd.cuh on one planned row tile.
// tiles: (n_tiles) int4 of (first row, rows, first key, end key).
template <int D>
__global__ void __launch_bounds__(rt::DqFma<D>::NT, rt::DqFma<D>::MIN_BLOCKS)
varlen_dq_fma(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ key_bias,
              const float* __restrict__ dout, const float* __restrict__ lse,
              const float* __restrict__ delta, const int4* __restrict__ tiles,
              float* __restrict__ dq, int rep, int Tq, int L, float scale) {
  const int4 t = tiles[blockIdx.x];
  const size_t base = ((size_t)blockIdx.z * rep + blockIdx.y) * Tq + t.x;
  const size_t kv = ((size_t)blockIdx.z * L + t.z) * D;
  rt::fma_dq_block<D>(q + base * D, dout + base * D, lse + base, delta + base, dq + base * D,
                      t.y, k + kv, v + kv, key_bias + t.z, t.w - t.z, scale,
                      [](int, int) { return true; });
}

// varlen_dkv, fp32: the block of csrc/fma_bwd.cuh on one planned (key tile,
// split).  tiles: (n_tiles, S) int4 of (first key, keys, first row, end row).
template <int D>
__global__ void __launch_bounds__(rt::DkvFma<D>::NT, 1)
varlen_dkv_fma(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ key_bias,
               const float* __restrict__ dout, const float* __restrict__ lse,
               const float* __restrict__ delta, const int4* __restrict__ tiles,
               float* __restrict__ dk, float* __restrict__ dv, float* __restrict__ ws,
               int S, int rep, int Tq, int L, float scale) {
  static_assert(rt::DkvFma<D>::NT >= rt::DkvFma<D>::BK, "one thread per key for the dead-tile test");
  const int4 t = tiles[(size_t)blockIdx.x * S + blockIdx.z];
  const bool live_key = (int)threadIdx.x < t.y && key_bias[t.x + threadIdx.x] > rt::NEG_HALF;
  const int2 range = make_int2(t.z, __syncthreads_or(live_key) ? t.w : t.z);
  rt::fma_dkv_block<D>(q, k, v, key_bias + t.x, dout, lse, delta, dk, dv, ws, blockIdx.y,
                       gridDim.y, t.x, t.y, range, rep, Tq, L, blockIdx.z, S, scale,
                       [](int, int) { return true; });
}

// Sum the S row-split partials of dK and dV in split order and cast.
template <typename T>
__global__ void __launch_bounds__(256)
varlen_dkv_reduce(const float* __restrict__ ws, T* __restrict__ dk, T* __restrict__ dv,
                  int S, size_t n4) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e < n4) rt::dkv_reduce_elem<T>(ws, dk, dv, S, n4, e, blockIdx.y);
}

template <int D>
int launch_dq_rows(const void* q, const void* k, const void* v, const void* key_bias,
                   const void* qseg, const void* kseg, const void* k_bounds,
                   const void* dout, const void* lse, const void* delta, void* dq, int H,
                   int rep, int Tq, int L, cudaStream_t stream) {
  using T = __nv_bfloat16;
  const dim3 grid((Tq + kRows - 1) / kRows, rep, H);
  varlen_dq_rows<T, D><<<grid, kRows, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(key_bias), static_cast<const int*>(qseg),
      static_cast<const int*>(kseg), static_cast<const int*>(k_bounds),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dq), rep, Tq, L,
      (float)(1.0 / sqrt((double)D)));
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq_fma(const void* q, const void* k, const void* v, const void* key_bias,
                  const void* dout, const void* lse, const void* delta, const void* tiles,
                  void* dq, int H, int rep, int Tq, int L, int n_tiles, cudaStream_t stream) {
  using C = rt::DqFma<D>;
  auto kern = varlen_dq_fma<D>;
  if (int err = rt::set_smem(kern, C::SMEM)) return err;
  const dim3 grid(n_tiles, rep, H);
  kern<<<grid, C::NT, C::SMEM, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(key_bias),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const int4*>(tiles),
      static_cast<float*>(dq), rep, Tq, L, (float)(1.0 / sqrt((double)D)));
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv_rows(const void* q, const void* k, const void* v, const void* key_bias,
                    const void* qseg, const void* kseg, const void* q_bounds,
                    const void* dout, const void* lse, const void* delta, void* dk,
                    void* dv, int H, int rep, int Tq, int L, cudaStream_t stream) {
  using T = __nv_bfloat16;
  const dim3 grid((L + kKeys - 1) / kKeys, H);
  varlen_dkv_rows<T, D><<<grid, kKeys, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(key_bias), static_cast<const int*>(qseg),
      static_cast<const int*>(kseg), static_cast<const int*>(q_bounds),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv), rep,
      Tq, L, (float)(1.0 / sqrt((double)D)));
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv_fma(const void* q, const void* k, const void* v, const void* key_bias,
                   const void* dout, const void* lse, const void* delta, const void* tiles,
                   void* ws, void* dk, void* dv, int H, int rep, int Tq, int L, int n_tiles,
                   int S, cudaStream_t stream) {
  using C = rt::DkvFma<D>;
  auto kern = varlen_dkv_fma<D>;
  if (int err = rt::set_smem(kern, C::SMEM)) return err;
  const dim3 grid(n_tiles, H, S);
  kern<<<grid, C::NT, C::SMEM, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(key_bias),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const int4*>(tiles),
      static_cast<float*>(dk), static_cast<float*>(dv), static_cast<float*>(ws), S, rep, Tq,
      L, (float)(1.0 / sqrt((double)D)));
  if (int err = (int)cudaGetLastError()) return err;
  if (S > 1) {
    const size_t n4 = (size_t)H * L * D / 4;
    const dim3 rgrid((unsigned)((n4 + 255) / 256), 2);
    varlen_dkv_reduce<float><<<rgrid, 256, 0, stream>>>(static_cast<const float*>(ws),
                                                        static_cast<float*>(dk),
                                                        static_cast<float*>(dv), S, n4);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// fp32 (the fma path): tiles the (n_tiles, 4) int32 plan of
// kernels/occupancy.py::varlen_row_tiles, whose tiles cover [0, T); qseg,
// kseg and the bounds unused.  bf16 (the rows path): tiles and n_tiles
// unused.
extern "C" int varlen_dq(const void* q, const void* k, const void* v,
                         const void* key_bias, const void* qseg, const void* kseg,
                         const void* q_bounds, const void* k_bounds, const void* dout,
                         const void* lse, const void* delta, const void* tiles, void* dq,
                         int H, int rep, int Tq, int L, int n_tiles, int D, int bf16,
                         void* stream) {
  (void)q_bounds;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H == 0 || rep == 0 || Tq == 0) return 0;
  if (!bf16 && (tiles == nullptr || n_tiles < 1)) return (int)cudaErrorInvalidValue;
  RT_DISPATCH_D(D, {
    return bf16 ? launch_dq_rows<kD>(q, k, v, key_bias, qseg, kseg, k_bounds, dout, lse,
                                     delta, dq, H, rep, Tq, L, s)
                : launch_dq_fma<kD>(q, k, v, key_bias, dout, lse, delta, tiles, dq, H, rep,
                                    Tq, L, n_tiles, s);
  });
  return 0;
}

// fp32 (the fma path): tiles the (n_tiles, S, 4) int32 plan of
// kernels/occupancy.py::varlen_dkv_tiles, whose tiles cover [0, L); ws
// (2, S, H, L, D) fp32 partials when S > 1 (unused, may be NULL, when
// S == 1).  bf16 (the rows path): tiles, ws, n_tiles and S unused.
extern "C" int varlen_dkv(const void* q, const void* k, const void* v,
                          const void* key_bias, const void* qseg, const void* kseg,
                          const void* q_bounds, const void* k_bounds, const void* dout,
                          const void* lse, const void* delta, const void* tiles, void* ws,
                          void* dk, void* dv, int H, int rep, int Tq, int L, int n_tiles,
                          int S, int D, int bf16, void* stream) {
  (void)k_bounds;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H == 0 || L == 0) return 0;
  if (!bf16 && (tiles == nullptr || n_tiles < 1 || S < 1 || (S > 1 && ws == nullptr)))
    return (int)cudaErrorInvalidValue;
  RT_DISPATCH_D(D, {
    return bf16 ? launch_dkv_rows<kD>(q, k, v, key_bias, qseg, kseg, q_bounds, dout, lse,
                                      delta, dk, dv, H, rep, Tq, L, s)
                : launch_dkv_fma<kD>(q, k, v, key_bias, dout, lse, delta, tiles, ws, dk,
                                     dv, H, rep, Tq, L, n_tiles, S, s);
  });
  return 0;
}
