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
// What bounds them on the H100.  Each visible (row, key) pair costs 6*D
// FLOP in local_dq and 8*D in local_dkv against one read of q, dO, k, v: at
// the tinyllama train shape (w 256, rep 8, D 64, bf16) the products bound
// them on the tensor cores (~0.04 / 0.05 ms).
//
// Design.  The TPU ran one grid cell per (b*h, block i) that owned dQ, dK
// and dV of block i, fetching the next query block through a second set of
// index maps.  Hopper blocks run in no order, so the work is split in two
// kernels that each own their outputs; neither uses atomics, and both sum
// in a fixed order (the backward is bit-reproducible).  Two paths, one rule
// (kernels/local.py::local_plan, the wrapper passes `tiles`):
//   tiles  bf16, w a multiple of 64: the tensor cores (mma.sync m16n8k16,
//          fp32 accumulation), tiles staged by cp.async, double-buffered,
//          exponentials on the MUFU unit (__expf).
//     local_dq   a block owns 64 rows of one (b*h, query head r, block i)
//                and walks the live prev half's 64-key tiles, then the self
//                half's up to the diagonal tile (masked key <= row); a warp
//                owns 16 rows: S, dP = dO V^T and dQ += dS K.
//     local_dkv  a block owns 64 keys of one (b*h, block i) and walks the
//                rep query heads over block i's rows from its first key on
//                (the first 64 masked row >= key) and, when block i+1's prev
//                flag is set, all of block i+1's rows, in staged tiles of BM
//                rows (32 at D 128); a warp owns 16 keys: S^T, dP^T,
//                dV += P^T dO and dK += dS^T Q.  The GQA group's sum stays
//                in registers.  Both tile steps are mma_bwd.cuh's, shared
//                with bta_bwd_mma's two block roles.
//   lanes  fp32, and w not a multiple of 64: 256 threads, a row (local_dq)
//          or a key (local_dkv) held by 4 lanes with D/4 dims each (float4
//          chunks sub, sub+4, ...: the four lanes read neighbouring 16
//          bytes of a shared row, so no bank conflict), K/V or Q/dO staged
//          as fp32 in tiles of 64 (32 at D = 128), dot products summed over
//          the 4 lanes by shuffles; the self half stops at the warp's last
//          position.
// p and dS are rounded to the operand dtype before their products.  A masked
// key (bias NEG_INF) and a row with lse = LSE_EMPTY give p = 0, so they
// contribute exactly 0; a block with no live half writes zeros.
#include "mma_bwd.cuh"

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
local_dq_lanes(const T* __restrict__ q, const T* __restrict__ k,
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
local_dkv_lanes(const T* __restrict__ q, const T* __restrict__ k,
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

// ---------------------------------------------------------------------------
// tiles, local_dq (bf16): 4 warps, warp w owns rows 16w..16w+15 of the
// block's 64; per staged tile of 64 keys a warp computes S and dP (16 rows x
// 64 keys), turns dS into A fragments and adds dS K into its dQ (16 x D).
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;
using rt::stage_rows;
using rt::stage_vals;
using rt::store2;

template <int D>
struct DqMma {
  static constexpr int BM = 64, BK = 64, NT = 128, LD = D + 8;
  // three blocks an SM where the registers allow it without spills
  static constexpr int MIN_BLOCKS = D > 64 ? 2 : 3;
  static constexpr int Q_OFF = 0, DO_OFF = BM * LD, K_OFF = 2 * BM * LD;
  static constexpr int V_OFF = K_OFF + 2 * BK * LD, BF_END = V_OFF + 2 * BK * LD;
  static constexpr size_t SMEM = (size_t)BF_END * 2 + (size_t)2 * BK * 4;
};

template <int D>
__global__ void __launch_bounds__(DqMma<D>::NT, DqMma<D>::MIN_BLOCKS)
local_dq_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, const float* __restrict__ key_bias,
             const int* __restrict__ live, const bf16* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             bf16* __restrict__ dq, int BH, int rep, int N, int w, int n_heads, float scale) {
  using C = DqMma<D>;
  constexpr int BM = C::BM, BK = C::BK, LD = C::LD;
  bf16* sm = reinterpret_cast<bf16*>(rt::dyn_smem());
  bf16* Qs = sm + C::Q_OFF;
  bf16* Ds = sm + C::DO_OFF;
  float* bs = reinterpret_cast<float*>(sm + C::BF_END);    // [2][BK]

  const int lane = threadIdx.x % 32, g = lane / 4, tig = lane % 4;
  const int rw = (threadIdx.x / 32) * 16;                   // the warp's first row
  // blockIdx.x = ((chunks - 1 - c) * BH + bh) * nb + i) * rep + r: the late
  // (heavy) row chunks of every block first
  const int nb = N / w, chunks = w / BM;
  int x = blockIdx.x;
  const int r = x % rep;
  x /= rep;
  const int i = x % nb;
  x /= nb;
  const int bh = x % BH, c = chunks - 1 - x / BH;
  const int b = bh / n_heads;
  const size_t base = ((size_t)bh * rep + r) * N + (size_t)i * w + c * BM;
  const int* lv = live + ((size_t)b * nb + i) * 2;
  const int n_prev = lv[0] != 0 ? w / BK : 0;               // block i-1, every key
  const int n_self = lv[1] != 0 ? c + 1 : 0;                // block i up to the diagonal
  const int n_kt = n_prev + n_self;

  const bool row_live = threadIdx.x < BM && lse[base + threadIdx.x] < rt::LSE_HALF;
  if (!__syncthreads_or(row_live) || n_kt == 0) {           // dq == 0
    rt::store_zeros(dq + base * D, BM * D);
    return;
  }
  stage_rows<bf16, D, LD>(Qs, q + base * D, BM, BM, C::NT);
  stage_rows<bf16, D, LD>(Ds, dout + base * D, BM, BM, C::NT);
  const bf16* kb = k + (size_t)bh * N * D;
  const bf16* vb = v + (size_t)bh * N * D;
  const float* biasb = key_bias + (size_t)b * N;
  auto load_tile = [&](int kt, int buf) {
    const int j0 = kt < n_prev ? (i - 1) * w + kt * BK : i * w + (kt - n_prev) * BK;
    stage_rows<bf16, D, LD>(sm + C::K_OFF + buf * BK * LD, kb + (size_t)j0 * D, BK, BK, C::NT);
    stage_rows<bf16, D, LD>(sm + C::V_OFF + buf * BK * LD, vb + (size_t)j0 * D, BK, BK, C::NT);
    stage_vals(bs + buf * BK, biasb + j0, BK, BK, rt::NEG_INF, C::NT);
  };

  float l[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rr = rw + g + 8 * h;
    l[h] = lse[base + rr];
    dl[h] = delta[base + rr];
  }
  float dqa[D / 8][4];
#pragma unroll
  for (int a = 0; a < D / 8; ++a)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[a][e] = 0.f;

  load_tile(0, 0);
  rt::cp_async_commit();
  for (int kt = 0; kt < n_kt; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < n_kt) load_tile(kt + 1, buf ^ 1);
    rt::cp_async_commit();
    rt::cp_async_wait<1>();
    __syncthreads();
    const bf16* Kt = sm + C::K_OFF + buf * BK * LD;
    const bf16* Vt = sm + C::V_OFF + buf * BK * LD;
    const float* bt = bs + buf * BK;
    // the self half's tile c is the diagonal: key <= row (both from the chunk start)
    const bool diag = n_self > 0 && kt == n_kt - 1;
    rt::mma_dq_tile<D, BK, LD>(Qs, Ds, Kt, Vt, bt, rw, l, dl, scale,
                               [&](int key, int row) { return !diag || key <= row; }, dqa);
    __syncthreads();                       // buffer `buf` is free for tile kt+2
  }
  rt::cp_async_wait<0>();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    bf16* out = dq + (base + rw + g + 8 * h) * D + tig * 2;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
      store2<bf16>(out + nt * 8, dqa[nt][2 * h], dqa[nt][2 * h + 1]);
  }
}

// ---------------------------------------------------------------------------
// tiles, local_dkv (bf16): 4 warps, warp w owns keys 16w..16w+15 of the
// block's 64; per 32 rows of a staged tile a warp computes S^T and dP^T (16
// keys x 32 rows), turns them into P^T and dS^T fragments and adds P^T dO
// and dS^T Q into its dV, dK (16 keys x D, fp32).
// ---------------------------------------------------------------------------
template <int D>
struct DkvMma {
  static constexpr int BK = 64, BM = D > 64 ? 32 : 64, NT = 128;
  static constexpr int LD = D + 8;   // bf16 row stride: ldmatrix rows on distinct banks
  static constexpr int K_OFF = 0, V_OFF = BK * LD, Q_OFF = 2 * BK * LD;
  static constexpr int DO_OFF = Q_OFF + 2 * BM * LD, BF_END = DO_OFF + 2 * BM * LD;
  static constexpr size_t SMEM = (size_t)BF_END * 2 + (size_t)(4 * BM + BK) * 4;
};

template <int D>
__global__ void __launch_bounds__(128, 1)
local_dkv_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const float* __restrict__ key_bias,
              const int* __restrict__ live, const bf16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              bf16* __restrict__ dk, bf16* __restrict__ dv, int BH, int rep, int N, int w,
              int n_heads, float scale) {
  using C = DkvMma<D>;
  constexpr int BM = C::BM, BK = C::BK, LD = C::LD;
  bf16* sm = reinterpret_cast<bf16*>(rt::dyn_smem());
  bf16* Ks = sm + C::K_OFF;
  bf16* Vs = sm + C::V_OFF;
  float* ls = reinterpret_cast<float*>(sm + C::BF_END);   // [2][BM]
  float* dls = ls + 2 * BM;                                 // [2][BM]
  float* bs = dls + 2 * BM;                                 // [BK]

  const int lane = threadIdx.x % 32, g = lane / 4, tig = lane % 4;
  const int kw = (threadIdx.x / 32) * 16;                   // the warp's first key
  // blockIdx.x = (c * BH + bh) * nb + i: the early key chunks, which see
  // the most rows of their own block, first
  const int nb = N / w;
  const int i = blockIdx.x % nb, bh = (blockIdx.x / nb) % BH, c = blockIdx.x / (nb * BH);
  const int b = bh / n_heads;
  const int j0 = i * w + c * BK;                            // the block's first key

  stage_rows<bf16, D, LD>(Ks, k + ((size_t)bh * N + j0) * D, BK, BK, C::NT);
  stage_rows<bf16, D, LD>(Vs, v + ((size_t)bh * N + j0) * D, BK, BK, C::NT);
  bool key_live = false;
  if (threadIdx.x < BK) {
    bs[threadIdx.x] = key_bias[(size_t)b * N + j0 + threadIdx.x];
    key_live = bs[threadIdx.x] > rt::NEG_HALF;
  }
  const int* lv = live + ((size_t)b * nb + i) * 2;
  const bool live_next = i + 1 < nb && lv[2] != 0;          // block i+1's prev flag
  // per query head: block i's rows from the chunk's first key on (per_a
  // tiles), then block i+1's rows (per_b); none without a valid key here
  const int per_a = (w - c * BK) / BM, per_b = live_next ? w / BM : 0;
  const int per_head = per_a + per_b;
  const int n_tiles = __syncthreads_or(key_live) && lv[1] != 0 ? rep * per_head : 0;
  auto tile_t0 = [&](int u) { return u < per_a ? j0 + u * BM : (i + 1) * w + (u - per_a) * BM; };
  auto load_tile = [&](int it, int buf) {
    const size_t row0 = ((size_t)bh * rep + it / per_head) * N + tile_t0(it % per_head);
    stage_rows<bf16, D, LD>(sm + C::Q_OFF + buf * BM * LD, q + row0 * D, BM, BM, C::NT);
    stage_rows<bf16, D, LD>(sm + C::DO_OFF + buf * BM * LD, dout + row0 * D, BM, BM, C::NT);
    stage_vals(ls + buf * BM, lse + row0, BM, BM, rt::LSE_EMPTY, C::NT);
    stage_vals(dls + buf * BM, delta + row0, BM, BM, 0.f, C::NT);
  };

  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int a = 0; a < D / 8; ++a)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[a][e] = dva[a][e] = 0.f;

  if (n_tiles > 0) load_tile(0, 0);
  rt::cp_async_commit();
  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_tiles) load_tile(it + 1, buf ^ 1);
    rt::cp_async_commit();
    rt::cp_async_wait<1>();
    const float* lt = ls + buf * BM;
    const float* dlt = dls + buf * BM;
    const bool row_live = threadIdx.x < BM && lt[threadIdx.x] < rt::LSE_HALF;
    const int u = it % per_head;
    const int t0 = tile_t0(u);
    // rows of block i before the chunk's last key: causal, row >= key
    const bool causal = u < per_a && u * BM < BK;
    // the tile has a live row, and the warp a key its last row sees
    if (__syncthreads_or(row_live) && !(causal && j0 + kw > t0 + BM - 1)) {
      rt::mma_dkv_tile<D, BM, LD>(
          Ks, Vs, bs, sm + C::Q_OFF + buf * BM * LD, sm + C::DO_OFF + buf * BM * LD, lt, dlt, kw,
          scale, [&](int key, int row) { return !causal || j0 + key <= t0 + row; }, dka, dva);
    }
    __syncthreads();                       // buffer `buf` is free for tile it+2
  }
  rt::cp_async_wait<0>();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const size_t off = ((size_t)bh * N + j0 + kw + g + 8 * h) * D + tig * 2;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      store2<bf16>(dk + off + nt * 8, dka[nt][2 * h], dka[nt][2 * h + 1]);
      store2<bf16>(dv + off + nt * 8, dva[nt][2 * h], dva[nt][2 * h + 1]);
    }
  }
}

// ---------------------------------------------------------------------------

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* key_bias,
              const void* live, const void* dout, const void* lse, const void* delta,
              void* dq, int BH, int rep, int N, int w, int n_heads, cudaStream_t stream) {
  const int chunks = (w + kItems - 1) / kItems;
  const dim3 grid(rep * (N / w) * chunks, BH);
  local_dq_lanes<T, D><<<grid, kThreads, 0, stream>>>(
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
  local_dkv_lanes<T, D><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(key_bias), static_cast<const int*>(live),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv), rep, N,
      w, n_heads, chunks, (float)(1.0 / sqrt((double)D)));
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq_mma(const void* q, const void* k, const void* v, const void* key_bias,
                  const void* live, const void* dout, const void* lse, const void* delta,
                  void* dq, int BH, int rep, int N, int w, int n_heads, cudaStream_t stream) {
  using C = DqMma<D>;
  auto kern = local_dq_mma<D>;
  if (int err = rt::set_smem(kern, C::SMEM)) return err;
  const unsigned blocks = (unsigned)(w / C::BM) * BH * (N / w) * rep;
  kern<<<blocks, C::NT, C::SMEM, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(key_bias), static_cast<const int*>(live),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), BH, rep, N, w, n_heads,
      (float)(1.0 / sqrt((double)D)));
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv_mma(const void* q, const void* k, const void* v, const void* key_bias,
                   const void* live, const void* dout, const void* lse, const void* delta,
                   void* dk, void* dv, int BH, int rep, int N, int w, int n_heads,
                   cudaStream_t stream) {
  using C = DkvMma<D>;
  auto kern = local_dkv_mma<D>;
  if (int err = rt::set_smem(kern, C::SMEM)) return err;
  const unsigned blocks = (unsigned)(w / C::BK) * BH * (N / w);
  kern<<<blocks, C::NT, C::SMEM, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(key_bias), static_cast<const int*>(live),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv), BH,
      rep, N, w, n_heads, (float)(1.0 / sqrt((double)D)));
  return (int)cudaGetLastError();
}

}  // namespace

// tiles: 1 = the tiled path (bf16, w a multiple of 64), 0 = the lanes path;
// kernels/local.py::local_plan picks
extern "C" int local_dq(const void* q, const void* k, const void* v,
                        const void* key_bias, const void* live, const void* dout,
                        const void* lse, const void* delta, void* dq, int BH, int rep,
                        int N, int D, int w, int n_heads, int bf16, int tiles, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (BH == 0 || rep == 0 || N == 0) return 0;
  if (tiles && (!bf16 || w % 64 != 0)) return (int)cudaErrorInvalidValue;
  RT_DISPATCH_D128(D, {
    if (tiles)
      return launch_dq_mma<kD>(q, k, v, key_bias, live, dout, lse, delta, dq, BH, rep, N, w,
                               n_heads, s);
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
                         int rep, int N, int D, int w, int n_heads, int bf16, int tiles,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (BH == 0 || rep == 0 || N == 0) return 0;
  if (tiles && (!bf16 || w % 64 != 0)) return (int)cudaErrorInvalidValue;
  RT_DISPATCH_D128(D, {
    if (tiles)
      return launch_dkv_mma<kD>(q, k, v, key_bias, live, dout, lse, delta, dk, dv, BH, rep,
                                N, w, n_heads, s);
    return bf16 ? launch_dkv<__nv_bfloat16, kD>(q, k, v, key_bias, live, dout, lse,
                                                delta, dk, dv, BH, rep, N, w, n_heads, s)
                : launch_dkv<float, kD>(q, k, v, key_bias, live, dout, lse, delta, dk,
                                        dv, BH, rep, N, w, n_heads, s);
  });
  return 0;
}
