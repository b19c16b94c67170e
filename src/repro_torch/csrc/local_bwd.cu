// Blocked local causal attention backward (the causal LM's local branch),
// recomputed from the forward's lse: two kernels that share their inputs and
// the recompute of p.
//
// Replaces repro/kernels/local.py::_bwd_kernel (Pallas, TPU).  Query block i
// (w positions) attends causally within block i and fully to block i-1, so
//   dQ of block i   comes from the keys of blocks i-1 (prev half) and i (self
//                   half, key <= query),
//   dK/dV of block i come from the queries of block i (self half, query >=
//                   key) and of block i+1 (its prev half, every row).
//
// Layout (GQA-native): q, dO (B*Hkv, rep, N, D), k/v (B*Hkv, N, D), key_bias
// (B, N) fp32, live (B, N/w, 2) int32, lse and delta = rowsum(dO*O)
// (B*Hkv, rep, N) fp32 -> dq like q (local_dq), dk/dv like k (local_dkv).
// live[b, i, 0] / live[b, i, 1] say the prev / self half of block i carries
// weight (kernels/occupancy.py::local_half_live, the packed segment rule
// folded in); block i's "next" flag is live[b, i+1, 0], which already holds
// block i's key liveness and the same-segment rule (the JAX kernel's
// live_next), and is 0 past the last block.
//
// Design.  The TPU ran one grid cell per (b*h, block i) that owned dQ, dK
// and dV of block i, fetching the next query block through a second set of
// index maps.  Hopper blocks run in no order, so the work is split in two
// kernels that each own their outputs; neither uses atomics:
//   local_dq   the forward's grid: a block owns 64 positions of one
//              (b*h, query head r, block i), stages the live halves' K/V in
//              tiles of 64 keys (32 at D = 128) into shared memory and
//              folds them:
//              p = exp(s - lse), dS = p*(dO.v - delta)*scale, dq += dS*k.
//              The self half stops at the warp's last position.
//   local_dkv  a block owns 64 keys of one (b*h, block i) and walks the rep
//              query heads over block i's rows at positions >= its first key
//              and, if the next flag is set, all of block i+1's rows, staging
//              Q, dO, lse, delta in tiles of 64 rows (32 at D = 128):
//              dv += p*dO, dk += dS*q.
//              The GQA group's sum is this loop.
// A row (local_dq) or a key (local_dkv) is held by 4 lanes, each with D/4
// dims (float4 chunks sub, sub+4, ...: the four lanes read neighbouring 16
// bytes of a shared row, so no bank conflict), and the dot products are
// summed over the 4 lanes by shuffles.  One thread a key would keep k, v, dk
// and dv rows (4*D floats) in registers, past the 255-register cap at
// D = 64; a lane here keeps D floats.  p and dS are rounded to the operand
// dtype before their products.  A masked key (bias NEG_INF) and a row with
// lse = LSE_EMPTY give p = 0, so they contribute exactly 0; a block with no
// live half writes zeros.
//
// Bound on the H100: at the tinyllama train shapes (w = 256, rep 8, D 64)
// each visible (row, key) pair costs 6*D FLOP in local_dq and 8*D in
// local_dkv against one read of q, dO, k, v, so the arithmetic bounds them.
// This first version uses the fp32 pipes only.
#include "common.cuh"

namespace {

constexpr int kLanes = 4;                  // lanes per query row / per key
constexpr int kThreads = 256;
constexpr int kItems = kThreads / kLanes;  // rows (local_dq) or keys (local_dkv) a block
constexpr int kWarpItems = 32 / kLanes;    // rows a warp holds (local_dq)

// The lane's D/4 dims of a global row, as fp32: chunk c holds dims
// 16*c + 4*sub .. 16*c + 4*sub + 3.
template <typename T, int D>
__device__ __forceinline__ void load_part(const T* row, int sub, float (&x)[D / 4]) {
#pragma unroll
  for (int c = 0; c < D / 16; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[4 * c + e] = rt::to_f(row[16 * c + 4 * sub + e]);
}

template <typename T, int D>
__device__ __forceinline__ void store_part(const float (&x)[D / 4], int sub, T* row) {
#pragma unroll
  for (int c = 0; c < D / 16; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) row[16 * c + 4 * sub + e] = rt::from_f<T>(x[4 * c + e]);
}

// The lane's share of a dot product with a shared-memory row of D floats.
template <int D>
__device__ __forceinline__ float part_dot(const float (&a)[D / 4], const float* row,
                                          int sub) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int c = 0; c < D / 16; ++c) {
    const float4 x = r4[4 * c + sub];
    s0 = fmaf(a[4 * c + 0], x.x, s0);
    s1 = fmaf(a[4 * c + 1], x.y, s1);
    s0 = fmaf(a[4 * c + 2], x.z, s0);
    s1 = fmaf(a[4 * c + 3], x.w, s1);
  }
  return s0 + s1;
}

// acc += a * (the lane's dims of a shared-memory row)
template <int D>
__device__ __forceinline__ void part_axpy(float (&acc)[D / 4], float a, const float* row,
                                          int sub) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int c = 0; c < D / 16; ++c) {
    const float4 x = r4[4 * c + sub];
    acc[4 * c + 0] = fmaf(a, x.x, acc[4 * c + 0]);
    acc[4 * c + 1] = fmaf(a, x.y, acc[4 * c + 1]);
    acc[4 * c + 2] = fmaf(a, x.z, acc[4 * c + 2]);
    acc[4 * c + 3] = fmaf(a, x.w, acc[4 * c + 3]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
local_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ key_bias,
                const int* __restrict__ live, const T* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                T* __restrict__ dq, int rep, int N, int w, int n_heads, int chunks,
                float scale) {
  constexpr int kTile = rt::kTileRows<D>;  // staged keys
  __shared__ __align__(16) float Ks[kTile * D];
  __shared__ __align__(16) float Vs[kTile * D];
  __shared__ float bs[kTile];

  const int nb = N / w;
  const int c = blockIdx.x % chunks;                 // row chunk inside the block
  const int i = (blockIdx.x / chunks) % nb;          // query block
  const int r = blockIdx.x / (chunks * nb);          // query head of the group
  const int bh = blockIdx.y;
  const int b = bh / n_heads;
  const int sub = threadIdx.x % kLanes;
  const int tin = c * kItems + threadIdx.x / kLanes; // position inside block i
  const bool has_row = tin < w;
  // the warp's last position: no row of the warp sees a self key past it
  const int warp_last = c * kItems + (threadIdx.x / 32) * kWarpItems + kWarpItems - 1;
  const size_t qrow = ((size_t)bh * rep + r) * N + (size_t)i * w + tin;

  float acc[D / 4];
#pragma unroll
  for (int d = 0; d < D / 4; ++d) acc[d] = 0.f;
  const int* lv = live + ((size_t)b * nb + i) * 2;
  const bool live_prev = lv[0] != 0;
  const bool live_self = lv[1] != 0;
  if (!live_prev && !live_self) {                    // block-uniform: dq == 0
    if (has_row) store_part<T, D>(acc, sub, dq + qrow * D);
    return;
  }
  float qr[D / 4], dor[D / 4];
  float l = rt::LSE_EMPTY, dl = 0.f;
  if (has_row) {
    load_part<T, D>(q + qrow * D, sub, qr);
    load_part<T, D>(dout + qrow * D, sub, dor);
    l = lse[qrow];
    dl = delta[qrow];
  } else {
#pragma unroll
    for (int d = 0; d < D / 4; ++d) qr[d] = dor[d] = 0.f;
  }
  const T* kb = k + (size_t)bh * N * D;
  const T* vb = v + (size_t)bh * N * D;
  const float* biasb = key_bias + (size_t)b * N;

  // half 0: block i-1, fully visible; half 1: block i, key <= tin
  for (int half = 0; half < 2; ++half) {
    if (half == 0 ? !live_prev : !live_self) continue;     // block-uniform
    const int base = (i - 1 + half) * w;
    const int limit = half == 0 ? w : min(w, (c + 1) * kItems);
    for (int j0 = 0; j0 < limit; j0 += kTile) {
      const int n = min(kTile, limit - j0);
      __syncthreads();                     // previous tile fully consumed
      rt::stage(kb + (size_t)(base + j0) * D, Ks, n * D);
      rt::stage(vb + (size_t)(base + j0) * D, Vs, n * D);
      rt::stage(biasb + base + j0, bs, n);
      __syncthreads();
      const int m = half == 0 ? n : min(n, warp_last - j0 + 1);   // warp-uniform
      for (int j = 0; j < m; ++j) {
        const float s =
            rt::group_sum<kLanes>(part_dot<D>(qr, Ks + j * D, sub)) * scale + bs[j];
        const float dp = rt::group_sum<kLanes>(part_dot<D>(dor, Vs + j * D, sub));
        const bool visible = half == 0 || j0 + j <= tin;
        const float p = visible ? rt::p_from_lse(s, l) : 0.f;
        part_axpy<D>(acc, rt::pv_operand<T>(p * (dp - dl) * scale), Ks + j * D, sub);
      }
    }
  }
  if (has_row) store_part<T, D>(acc, sub, dq + qrow * D);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
local_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ key_bias,
                 const int* __restrict__ live, const T* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 T* __restrict__ dk, T* __restrict__ dv, int rep, int N, int w,
                 int n_heads, int chunks, float scale) {
  constexpr int kTile = rt::kTileRows<D>;  // staged rows
  __shared__ __align__(16) float Qs[kTile * D];
  __shared__ __align__(16) float Ds[kTile * D];
  __shared__ float ls[kTile];
  __shared__ float dls[kTile];

  const int nb = N / w;
  const int c = blockIdx.x % chunks;                 // key chunk inside the block
  const int i = blockIdx.x / chunks;                 // key block
  const int bh = blockIdx.y;
  const int b = bh / n_heads;
  const int sub = threadIdx.x % kLanes;
  const int jin = c * kItems + threadIdx.x / kLanes; // this group's key, inside block i
  const bool has_key = jin < w;
  const size_t krow = (size_t)bh * N + (size_t)i * w + jin;

  float kr[D / 4], vr[D / 4], dka[D / 4], dva[D / 4];
  float bj = rt::NEG_INF;
  if (has_key) {
    load_part<T, D>(k + krow * D, sub, kr);
    load_part<T, D>(v + krow * D, sub, vr);
    bj = key_bias[(size_t)b * N + (size_t)i * w + jin];
  }
#pragma unroll
  for (int d = 0; d < D / 4; ++d) {
    if (!has_key) kr[d] = vr[d] = 0.f;
    dka[d] = dva[d] = 0.f;
  }
  const int* lv = live + ((size_t)b * nb + i) * 2;
  const bool live_self = lv[1] != 0;                 // some key of block i is valid
  const bool live_next = i + 1 < nb && lv[2] != 0;   // block i+1's prev flag

  // half 0: block i's rows at positions >= the chunk's first key (key <= row);
  // half 1: block i+1's rows, every key visible.  Both need a valid key of
  // block i (block-uniform), as the TPU kernel's guards do.
  for (int half = 0; half < 2 && live_self; ++half) {
    if (half == 1 && !live_next) break;
    const int t_lo = half == 0 ? c * kItems : 0;
    for (int r = 0; r < rep; ++r) {
      const size_t row0 = ((size_t)bh * rep + r) * N + (size_t)(i + half) * w;
      for (int t0 = t_lo; t0 < w; t0 += kTile) {
        const int n = min(kTile, w - t0);
        __syncthreads();                   // previous tile fully consumed
        rt::stage(q + (row0 + t0) * D, Qs, n * D);
        rt::stage(dout + (row0 + t0) * D, Ds, n * D);
        rt::stage(lse + row0 + t0, ls, n);
        rt::stage(delta + row0 + t0, dls, n);
        __syncthreads();
        for (int t = 0; t < n; ++t) {
          const float s =
              rt::group_sum<kLanes>(part_dot<D>(kr, Qs + t * D, sub)) * scale + bj;
          const float dp = rt::group_sum<kLanes>(part_dot<D>(vr, Ds + t * D, sub));
          const bool visible = half == 1 || jin <= t0 + t;
          const float p = visible ? rt::p_from_lse(s, ls[t]) : 0.f;
          part_axpy<D>(dva, rt::pv_operand<T>(p), Ds + t * D, sub);
          part_axpy<D>(dka, rt::pv_operand<T>(p * (dp - dls[t]) * scale), Qs + t * D,
                       sub);
        }
      }
    }
  }
  if (has_key) {
    store_part<T, D>(dka, sub, dk + krow * D);
    store_part<T, D>(dva, sub, dv + krow * D);
  }
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* key_bias,
              const void* live, const void* dout, const void* lse, const void* delta,
              void* dq, int BH, int rep, int N, int w, int n_heads, cudaStream_t stream) {
  const int chunks = (w + kItems - 1) / kItems;
  const dim3 grid(rep * (N / w) * chunks, BH);
  local_dq_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(key_bias), static_cast<const int*>(live),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dq), rep, N, w, n_heads, chunks,
      (float)(1.0 / sqrt((double)D)));
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* key_bias,
               const void* live, const void* dout, const void* lse, const void* delta,
               void* dk, void* dv, int BH, int rep, int N, int w, int n_heads,
               cudaStream_t stream) {
  const int chunks = (w + kItems - 1) / kItems;
  const dim3 grid((N / w) * chunks, BH);
  local_dkv_kernel<T, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(key_bias), static_cast<const int*>(live),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv), rep, N,
      w, n_heads, chunks, (float)(1.0 / sqrt((double)D)));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int local_dq(const void* q, const void* k, const void* v,
                        const void* key_bias, const void* live, const void* dout,
                        const void* lse, const void* delta, void* dq, int BH, int rep,
                        int N, int D, int w, int n_heads, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (BH == 0 || N == 0) return 0;
  RT_DISPATCH_D128(D, {
    return bf16 ? launch_dq<__nv_bfloat16, kD>(q, k, v, key_bias, live, dout, lse, delta,
                                               dq, BH, rep, N, w, n_heads, s)
                : launch_dq<float, kD>(q, k, v, key_bias, live, dout, lse, delta, dq,
                                       BH, rep, N, w, n_heads, s);
  });
  return 0;
}

extern "C" int local_dkv(const void* q, const void* k, const void* v,
                         const void* key_bias, const void* live, const void* dout,
                         const void* lse, const void* delta, void* dk, void* dv, int BH,
                         int rep, int N, int D, int w, int n_heads, int bf16,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (BH == 0 || N == 0) return 0;
  RT_DISPATCH_D128(D, {
    return bf16 ? launch_dkv<__nv_bfloat16, kD>(q, k, v, key_bias, live, dout, lse,
                                                delta, dk, dv, BH, rep, N, w, n_heads, s)
                : launch_dkv<float, kD>(q, k, v, key_bias, live, dout, lse, delta, dk,
                                        dv, BH, rep, N, w, n_heads, s);
  });
  return 0;
}
