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
// What bounds them.  Per visible (row, key) pair flash_dq does three
// D-long products (S = QK^T, dP = dO V^T, dQ += dS K) and flash_dkv four
// (S, dP, dV += P^T dO, dK += dS^T Q).  At the compression branch's shapes
// (shapenet: B*H 64, N 3840 against L 480 pooled keys, D 32, fp32) that
// arithmetic bounds both; at the LM train shape (B*Hkv 8, rep 8, N 4096
// against L 64 pooled keys, D 64, bf16) the bytes of Q and dO bound them,
// and parallelism: the key axis alone gives flash_dkv 8 blocks for 132 SMs.
//
// Design.
//   flash_dkv  grid (key tiles of 64, B*Hkv, S row splits).  A block owns
//              one key tile and one range of positions t, walks the rep
//              heads of the GQA group over that range in staged tiles of BM
//              rows and keeps dK, dV of its keys in registers.  The range
//              starts at the tile's first visible position ((j0+1)*ell
//              block-causal, j0 causal), so no block walks rows its keys
//              cannot see; a staged tile whose rows are all LSE_EMPTY is
//              skipped, and so is a warp none of whose keys the tile sees.
//              S (kernels/flash.py::dkv_splits) gives about four blocks an
//              SM; with S > 1 each split writes fp32 partials into a
//              (2, S, B*Hkv, L, D) workspace and a second pass
//              (flash_dkv_reduce) sums them in split order and casts:
//              deterministic, no atomics.
//   flash_dq   grid (row tiles of 64, B*Hkv).  A block holds 64 query rows
//              and stages only the key tiles its last row can see.
//   Tiles are staged by cp.async, double-buffered, in dynamic shared memory,
//   in the operand dtype.
//     bf16  the five products on the tensor cores (mma.sync m16n8k16, fp32
//           accumulation), a warp owning 16 keys (dkv) or 16 rows (dq); P
//           and dS go from the accumulator to the next product's A fragment
//           in registers.
//     fp32  the FMA pipes, register-tiled: a thread holds a micro-tile of
//           keys x rows of S and dP (four float4 operands a step), P and dS
//           go through shared memory, and each thread adds into dK/dV (dQ)
//           of its keys (rows) x D/RY dims.  Both blocks are
//           csrc/fma_bwd.cuh's, flash_dkv's shared with varlen_dkv_fma and
//           flash_dq's with varlen_dq_fma.  3xTF32 on the tensor cores was
//           tried: it holds the kernel checks' 1e-4 but, an error of 2^-22
//           a product against fp32's 2^-24, not shapenet's train check on
//           phi_k.pos, whose gradient is a near-cancelling sum over keys.
//   The D-long sums are split over lanes or threads: no thread holds a whole
//   row of D of two operands, so D 64 and D 128 build without spills.
// p and dS are rounded to the operand dtype before their products.  Rows
// with lse = LSE_EMPTY give p = 0: their dQ is exactly 0 and they add
// nothing to dK, dV.  The ragged key edge (L = 480) and the ragged row edge
// are masked here: staged rows past the edge are zeros, keys past L carry
// NEG_INF bias.
#include "fma_bwd.cuh"

namespace {

using bf16 = __nv_bfloat16;
using rt::DkvFma;
using rt::DqFma;
using rt::Mask;
using rt::set_smem;
using rt::stage_rows;
using rt::stage_vals;
using rt::store2;

// Positions [lo, hi) that split s of S walks for a key tile whose first
// visible position is `first`: [first, N) cut into S chunks of whole BM-row
// tiles (kernels/flash.py::dkv_ranges is the same rule).
__device__ __forceinline__ int2 split_range(int first, int N, int S, int s, int bm) {
  first = min(first, N);
  const int per = (N - first + S - 1) / S;
  const int chunk = (per + bm - 1) / bm * bm;
  const int lo = min(N, first + s * chunk);
  return make_int2(lo, min(N, lo + chunk));
}

// ---------------------------------------------------------------------------
// flash_dkv, bf16: tensor cores.  4 warps, warp w owns keys 16w..16w+15 of
// the block's 64; per 32 rows of a staged tile a warp computes S^T and dP^T
// (16 keys x 32 rows), turns them into P^T and dS^T fragments and adds
// P^T dO and dS^T Q into its dV, dK (16 keys x D, fp32).
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
flash_dkv_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const float* __restrict__ key_bias,
              const bf16* __restrict__ dout, const float* __restrict__ lse,
              const float* __restrict__ delta, bf16* __restrict__ dk,
              bf16* __restrict__ dv, float* __restrict__ ws, int S, int rep, int N,
              int L, int n_heads, Mask mask, float scale) {
  using C = DkvMma<D>;
  constexpr int BM = C::BM, LD = C::LD;
  bf16* sm = reinterpret_cast<bf16*>(rt::dyn_smem());
  bf16* Ks = sm + C::K_OFF;
  bf16* Vs = sm + C::V_OFF;
  float* ls = reinterpret_cast<float*>(sm + C::BF_END);   // [2][BM]
  float* dls = ls + 2 * BM;                                 // [2][BM]
  float* bs = dls + 2 * BM;                                 // [BK]

  const int lane = threadIdx.x % 32, g = lane / 4, tig = lane % 4;
  const int kw = (threadIdx.x / 32) * 16;                   // the warp's first key
  const int j0 = blockIdx.x * C::BK, bh = blockIdx.y, s = blockIdx.z;
  const int b = bh / n_heads;
  const int nk = min(C::BK, L - j0);

  stage_rows<bf16, D, LD>(Ks, k + ((size_t)bh * L + j0) * D, nk, C::BK, C::NT);
  stage_rows<bf16, D, LD>(Vs, v + ((size_t)bh * L + j0) * D, nk, C::BK, C::NT);
  for (int i = threadIdx.x; i < C::BK; i += C::NT)
    bs[i] = i < nk ? key_bias[(size_t)b * L + j0 + i] : rt::NEG_INF;

  const int2 range = split_range(mask.first_t(j0), N, S, s, BM);
  const int per_head = (range.y - range.x + BM - 1) / BM;
  const int n_tiles = rep * per_head;
  const size_t rows0 = (size_t)bh * rep * N;
  auto load_tile = [&](int it, int buf) {
    const int t0 = range.x + (it % per_head) * BM;
    const int n = min(BM, range.y - t0);
    const size_t row0 = rows0 + (size_t)(it / per_head) * N + t0;
    stage_rows<bf16, D, LD>(sm + C::Q_OFF + buf * BM * LD, q + row0 * D, n, BM, C::NT);
    stage_rows<bf16, D, LD>(sm + C::DO_OFF + buf * BM * LD, dout + row0 * D, n, BM, C::NT);
    stage_vals(ls + buf * BM, lse + row0, n, BM, rt::LSE_EMPTY, C::NT);
    stage_vals(dls + buf * BM, delta + row0, n, BM, 0.f, C::NT);
  };

  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[i][e] = dva[i][e] = 0.f;

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
    const int t0 = range.x + (it % per_head) * BM;
    const int t_last = min(range.y, t0 + BM) - 1;
    // the tile has a live row, and the warp a key visible at its last position
    if (__syncthreads_or(row_live) && kw < nk && mask.first_t(j0 + kw) <= t_last) {
      const bf16* Qt = sm + C::Q_OFF + buf * BM * LD;
      const bf16* Dt = sm + C::DO_OFF + buf * BM * LD;
      // sub-tiles of 32 rows bound the S^T / dP^T registers
#pragma unroll 1
      for (int r0 = 0; r0 < BM; r0 += 32) {
        float st[4][4], dp[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) st[i][e] = dp[i][e] = 0.f;
        // S^T = K Q^T, dP^T = V dO^T over D
#pragma unroll
        for (int d0 = 0; d0 < D; d0 += 16) {
          uint32_t ka[4], va[4];
          const int aoff = (kw + lane % 16) * LD + d0 + (lane / 16) * 8;
          rt::ldmatrix_x4(ka, Ks + aoff);
          rt::ldmatrix_x4(va, Vs + aoff);
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            const int boff =
                (r0 + np * 16 + lane % 8 + 8 * (lane / 16)) * LD + d0 + 8 * ((lane / 8) % 2);
            uint32_t qb[4], db[4];
            rt::ldmatrix_x4(qb, Qt + boff);
            rt::ldmatrix_x4(db, Dt + boff);
            rt::mma_bf16(st[2 * np], ka, qb[0], qb[1]);
            rt::mma_bf16(st[2 * np + 1], ka, qb[2], qb[3]);
            rt::mma_bf16(dp[2 * np], va, db[0], db[1]);
            rt::mma_bf16(dp[2 * np + 1], va, db[2], db[3]);
          }
        }
        // P^T and dS^T, rounded to bf16 as A fragments (keys x rows)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = kw + g + 8 * (e / 2);
            const int row = r0 + nt * 8 + tig * 2 + (e % 2);
            float p = 0.f;
            if (mask.visible(j0 + key, t0 + row))
              p = rt::p_from_lse(st[nt][e] * scale + bs[key], lt[row]);
            dp[nt][e] = p * (dp[nt][e] - dlt[row]) * scale;
            st[nt][e] = p;
          }
        }
        uint32_t pa[2][4], sa[2][4];
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          pa[kk][0] = rt::pack_bf16(st[2 * kk][0], st[2 * kk][1]);
          pa[kk][1] = rt::pack_bf16(st[2 * kk][2], st[2 * kk][3]);
          pa[kk][2] = rt::pack_bf16(st[2 * kk + 1][0], st[2 * kk + 1][1]);
          pa[kk][3] = rt::pack_bf16(st[2 * kk + 1][2], st[2 * kk + 1][3]);
          sa[kk][0] = rt::pack_bf16(dp[2 * kk][0], dp[2 * kk][1]);
          sa[kk][1] = rt::pack_bf16(dp[2 * kk][2], dp[2 * kk][3]);
          sa[kk][2] = rt::pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
          sa[kk][3] = rt::pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
        }
        // dV += P^T dO, dK += dS^T Q over the sub-tile's rows
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
          for (int n0 = 0; n0 < D; n0 += 16) {
            const int boff =
                (r0 + kk * 16 + lane % 8 + 8 * ((lane / 8) % 2)) * LD + n0 + 8 * (lane / 16);
            uint32_t db[4], qb[4];
            rt::ldmatrix_x4_trans(db, Dt + boff);
            rt::ldmatrix_x4_trans(qb, Qt + boff);
            rt::mma_bf16(dva[n0 / 8], pa[kk], db[0], db[1]);
            rt::mma_bf16(dva[n0 / 8 + 1], pa[kk], db[2], db[3]);
            rt::mma_bf16(dka[n0 / 8], sa[kk], qb[0], qb[1]);
            rt::mma_bf16(dka[n0 / 8 + 1], sa[kk], qb[2], qb[3]);
          }
        }
      }
    }
    __syncthreads();                       // buffer `buf` is free for tile it+2
  }
  rt::cp_async_wait<0>();

  const size_t slab = (size_t)gridDim.y * L * D;            // one (B*Hkv, L, D) array
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = kw + g + 8 * h;
    if (key >= nk) continue;
    const size_t off = ((size_t)bh * L + j0 + key) * D + tig * 2;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      if (S == 1) {
        store2<bf16>(dk + off + nt * 8, dka[nt][2 * h], dka[nt][2 * h + 1]);
        store2<bf16>(dv + off + nt * 8, dva[nt][2 * h], dva[nt][2 * h + 1]);
      } else {
        store2<float>(ws + (size_t)s * slab + off + nt * 8, dka[nt][2 * h], dka[nt][2 * h + 1]);
        store2<float>(ws + (size_t)(S + s) * slab + off + nt * 8, dva[nt][2 * h],
                      dva[nt][2 * h + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// flash_dkv, fp32: FMA pipes, register-tiled, the block of csrc/fma_bwd.cuh
// (shared with varlen_dkv_fma): NT threads as 16 key lanes x RY row lanes,
// S^T and dP^T of a staged tile as 4 keys x BM/RY rows a thread, P^T and
// dS^T through shared memory, dV, dK as 4 keys x D/RY dims a thread.  The
// index mask is the visibility test.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(DkvFma<D>::NT, 1)
flash_dkv_fma(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ key_bias,
              const float* __restrict__ dout, const float* __restrict__ lse,
              const float* __restrict__ delta, float* __restrict__ dk,
              float* __restrict__ dv, float* __restrict__ ws, int S, int rep, int N,
              int L, int n_heads, Mask mask, float scale) {
  const int j0 = blockIdx.x * DkvFma<D>::BK, bh = blockIdx.y, s = blockIdx.z;
  const int b = bh / n_heads;
  const int nk = min(DkvFma<D>::BK, L - j0);
  const int2 range = split_range(mask.first_t(j0), N, S, s, DkvFma<D>::BM);
  rt::fma_dkv_block<D>(q, k, v, key_bias + (size_t)b * L + j0, dout, lse, delta, dk, dv, ws,
                       bh, gridDim.y, j0, nk, range, rep, N, L, s, S, scale,
                       [&](int key, int t) { return mask.visible(key, t); });
}

// Sum the S row-split partials of dK and dV in split order and cast.
template <typename T>
__global__ void __launch_bounds__(256)
flash_dkv_reduce(const float* __restrict__ ws, T* __restrict__ dk, T* __restrict__ dv,
                 int S, size_t n4) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e < n4) rt::dkv_reduce_elem<T>(ws, dk, dv, S, n4, e, blockIdx.y);
}

// ---------------------------------------------------------------------------
// flash_dq, bf16: tensor cores.  4 warps, warp w owns rows 16w..16w+15 of
// the block's 64; per staged key tile a warp computes S and dP (16 rows x 64
// keys), turns dS into A fragments and adds dS K into its dQ (16 x D).
// ---------------------------------------------------------------------------
template <int D>
struct DqMma {
  static constexpr int BM = 64, BK = 64, NT = 128, LD = D + 8;
  static constexpr int Q_OFF = 0, DO_OFF = BM * LD, K_OFF = 2 * BM * LD;
  static constexpr int V_OFF = K_OFF + 2 * BK * LD, BF_END = V_OFF + 2 * BK * LD;
  static constexpr size_t SMEM = (size_t)BF_END * 2 + (size_t)2 * BK * 4;
};

// The last position of rows [row0, row0 + n) of a (rep, N) row axis.
__device__ __forceinline__ int last_position(int row0, int n, int N) {
  const int last = row0 + n - 1;
  return row0 / N == last / N ? last % N : N - 1;
}

template <int D>
__global__ void __launch_bounds__(128, 3)
flash_dq_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, const float* __restrict__ key_bias,
             const bf16* __restrict__ dout, const float* __restrict__ lse,
             const float* __restrict__ delta, bf16* __restrict__ dq, int rep, int N,
             int L, int n_heads, Mask mask, float scale) {
  using C = DqMma<D>;
  constexpr int BK = C::BK, LD = C::LD;
  bf16* sm = reinterpret_cast<bf16*>(rt::dyn_smem());
  bf16* Qs = sm + C::Q_OFF;
  bf16* Ds = sm + C::DO_OFF;
  float* bs = reinterpret_cast<float*>(sm + C::BF_END);    // [2][BK]

  const int lane = threadIdx.x % 32, g = lane / 4, tig = lane % 4;
  const int rw = (threadIdx.x / 32) * 16;                   // the warp's first row
  const int bh = blockIdx.y, b = bh / n_heads;
  const int rows = rep * N, row0 = blockIdx.x * C::BM;
  const int nrows = min(C::BM, rows - row0);
  const size_t base = (size_t)bh * rows + row0;

  const bool live = threadIdx.x < nrows && lse[base + threadIdx.x] < rt::LSE_HALF;
  if (!__syncthreads_or(live)) {           // every row empty: dq == 0
    rt::store_zeros(dq + base * D, nrows * D);
    return;
  }
  const int kmax = min(L, mask.keys_seen(last_position(row0, nrows, N)));
  const int n_kt = (kmax + BK - 1) / BK;

  stage_rows<bf16, D, LD>(Qs, q + base * D, nrows, C::BM, C::NT);
  stage_rows<bf16, D, LD>(Ds, dout + base * D, nrows, C::BM, C::NT);
  const bf16* kb = k + (size_t)bh * L * D;
  const bf16* vb = v + (size_t)bh * L * D;
  const float* biasb = key_bias + (size_t)b * L;
  auto load_tile = [&](int kt, int buf) {
    const int j0 = kt * BK, n = min(BK, L - j0);
    stage_rows<bf16, D, LD>(sm + C::K_OFF + buf * BK * LD, kb + (size_t)j0 * D, n, BK, C::NT);
    stage_rows<bf16, D, LD>(sm + C::V_OFF + buf * BK * LD, vb + (size_t)j0 * D, n, BK, C::NT);
    stage_vals(bs + buf * BK, biasb + j0, n, BK, rt::NEG_INF, C::NT);
  };

  float l[2], dl[2];
  int t[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = rw + g + 8 * h;
    const bool ok = r < nrows;
    l[h] = ok ? lse[base + r] : rt::LSE_EMPTY;
    dl[h] = ok ? delta[base + r] : 0.f;
    t[h] = (row0 + r) % N;
  }
  float dqa[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[i][e] = 0.f;

  if (n_kt > 0) load_tile(0, 0);
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
    const int j0 = kt * BK;
    float st[BK / 8][4], dp[BK / 8][4];
#pragma unroll
    for (int i = 0; i < BK / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[i][e] = dp[i][e] = 0.f;
    // S = Q K^T, dP = dO V^T over D
#pragma unroll
    for (int d0 = 0; d0 < D; d0 += 16) {
      uint32_t qa[4], da[4];
      const int aoff = (rw + lane % 16) * LD + d0 + (lane / 16) * 8;
      rt::ldmatrix_x4(qa, Qs + aoff);
      rt::ldmatrix_x4(da, Ds + aoff);
#pragma unroll
      for (int np = 0; np < BK / 16; ++np) {
        const int boff = (np * 16 + lane % 8 + 8 * (lane / 16)) * LD + d0 + 8 * ((lane / 8) % 2);
        uint32_t kf[4], vf[4];
        rt::ldmatrix_x4(kf, Kt + boff);
        rt::ldmatrix_x4(vf, Vt + boff);
        rt::mma_bf16(st[2 * np], qa, kf[0], kf[1]);
        rt::mma_bf16(st[2 * np + 1], qa, kf[2], kf[3]);
        rt::mma_bf16(dp[2 * np], da, vf[0], vf[1]);
        rt::mma_bf16(dp[2 * np + 1], da, vf[2], vf[3]);
      }
    }
    // dS = P (dP - delta) scale, rounded to bf16 as A fragments (rows x keys)
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e / 2;
        const int key = nt * 8 + tig * 2 + (e % 2);
        float p = 0.f;
        if (mask.visible(j0 + key, t[h]))
          p = rt::p_from_lse(st[nt][e] * scale + bt[key], l[h]);
        dp[nt][e] = p * (dp[nt][e] - dl[h]) * scale;
      }
    }
    uint32_t sa[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      sa[kk][0] = rt::pack_bf16(dp[2 * kk][0], dp[2 * kk][1]);
      sa[kk][1] = rt::pack_bf16(dp[2 * kk][2], dp[2 * kk][3]);
      sa[kk][2] = rt::pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
      sa[kk][3] = rt::pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
    }
    // dQ += dS K over the tile's keys
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int n0 = 0; n0 < D; n0 += 16) {
        const int boff = (kk * 16 + lane % 8 + 8 * ((lane / 8) % 2)) * LD + n0 + 8 * (lane / 16);
        uint32_t kf[4];
        rt::ldmatrix_x4_trans(kf, Kt + boff);
        rt::mma_bf16(dqa[n0 / 8], sa[kk], kf[0], kf[1]);
        rt::mma_bf16(dqa[n0 / 8 + 1], sa[kk], kf[2], kf[3]);
      }
    }
    __syncthreads();                       // buffer `buf` is free for tile kt+2
  }
  rt::cp_async_wait<0>();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = rw + g + 8 * h;
    if (r >= nrows) continue;
    bf16* out = dq + (base + r) * D + tig * 2;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) store2<bf16>(out + nt * 8, dqa[nt][2 * h], dqa[nt][2 * h + 1]);
  }
}

// ---------------------------------------------------------------------------
// flash_dq, fp32: FMA pipes, register-tiled, the block of csrc/fma_bwd.cuh
// (shared with varlen_dq_fma): NT threads as 16 key lanes x RY row lanes, S
// and dP of a staged key tile as BM/RY rows x 2 keys a thread, dS through
// shared memory, dQ as BM/RY rows x D/16 dims a thread.  The block's rows
// are 64 of the flattened (rep, N) row axis; it stages the key tiles its last
// row can see, and the index mask is the visibility test.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(DqFma<D>::NT, DqFma<D>::MIN_BLOCKS)
flash_dq_fma(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ key_bias,
             const float* __restrict__ dout, const float* __restrict__ lse,
             const float* __restrict__ delta, float* __restrict__ dq, int rep, int N,
             int L, int n_heads, Mask mask, float scale) {
  const int bh = blockIdx.y, b = bh / n_heads;
  const int rows = rep * N, row0 = blockIdx.x * DqFma<D>::BM;
  const int nrows = min(DqFma<D>::BM, rows - row0);
  const size_t base = (size_t)bh * rows + row0;
  const int kmax = min(L, mask.keys_seen(last_position(row0, nrows, N)));
  rt::fma_dq_block<D>(q + base * D, dout + base * D, lse + base, delta + base, dq + base * D,
                      nrows, k + (size_t)bh * L * D, v + (size_t)bh * L * D,
                      key_bias + (size_t)b * L, kmax, scale,
                      [&](int key, int row) { return mask.visible(key, (row0 + row) % N); });
}

// ---------------------------------------------------------------------------

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* key_bias,
              const void* dout, const void* lse, const void* delta, void* dq, int BH,
              int rep, int N, int L, int n_heads, Mask mask, cudaStream_t stream) {
  const float scale = (float)(1.0 / sqrt((double)D));
  const dim3 grid((rep * N + 63) / 64, BH);
  if constexpr (sizeof(T) == 2) {
    using C = DqMma<D>;
    auto kern = flash_dq_mma<D>;
    if (int err = set_smem(kern, C::SMEM)) return err;
    kern<<<grid, C::NT, C::SMEM, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const float*>(key_bias), static_cast<const bf16*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<bf16*>(dq), rep, N, L, n_heads, mask, scale);
  } else {
    using C = DqFma<D>;
    auto kern = flash_dq_fma<D>;
    if (int err = set_smem(kern, C::SMEM)) return err;
    kern<<<grid, C::NT, C::SMEM, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(key_bias),
        static_cast<const float*>(dout), static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<float*>(dq), rep, N, L, n_heads, mask,
        scale);
  }
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* key_bias,
               const void* dout, const void* lse, const void* delta, void* dk, void* dv,
               void* ws, int S, int BH, int rep, int N, int L, int n_heads, Mask mask,
               cudaStream_t stream) {
  const float scale = (float)(1.0 / sqrt((double)D));
  const dim3 grid((L + 63) / 64, BH, S);
  if constexpr (sizeof(T) == 2) {
    using C = DkvMma<D>;
    auto kern = flash_dkv_mma<D>;
    if (int err = set_smem(kern, C::SMEM)) return err;
    kern<<<grid, C::NT, C::SMEM, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const float*>(key_bias), static_cast<const bf16*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<bf16*>(dk), static_cast<bf16*>(dv), static_cast<float*>(ws), S, rep, N, L,
        n_heads, mask, scale);
  } else {
    using C = DkvFma<D>;
    auto kern = flash_dkv_fma<D>;
    if (int err = set_smem(kern, C::SMEM)) return err;
    kern<<<grid, C::NT, C::SMEM, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(key_bias),
        static_cast<const float*>(dout), static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<float*>(dk), static_cast<float*>(dv),
        static_cast<float*>(ws), S, rep, N, L, n_heads, mask, scale);
  }
  if (int err = (int)cudaGetLastError()) return err;
  if (S > 1) {
    const size_t n4 = (size_t)BH * L * D / 4;
    const dim3 rgrid((unsigned)((n4 + 255) / 256), 2);
    flash_dkv_reduce<T><<<rgrid, 256, 0, stream>>>(static_cast<const float*>(ws),
                                                   static_cast<T*>(dk), static_cast<T*>(dv),
                                                   S, n4);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_dq(const void* q, const void* k, const void* v,
                        const void* key_bias, const void* dout, const void* lse,
                        const void* delta, void* dq, int BH, int rep, int N, int L,
                        int D, int n_heads, int causal, int block_causal, int ell,
                        int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (BH == 0 || N == 0) return 0;
  const Mask mask{causal, block_causal, ell};
  RT_DISPATCH_D128(D, {
    return bf16 ? launch_dq<__nv_bfloat16, kD>(q, k, v, key_bias, dout, lse, delta, dq,
                                               BH, rep, N, L, n_heads, mask, s)
                : launch_dq<float, kD>(q, k, v, key_bias, dout, lse, delta, dq, BH,
                                       rep, N, L, n_heads, mask, s);
  });
  return 0;
}

// ws: (2, S, BH, L, D) fp32 partials when S > 1 (unused, may be NULL, when
// S == 1: the kernel then writes dk, dv directly).
extern "C" int flash_dkv(const void* q, const void* k, const void* v,
                         const void* key_bias, const void* dout, const void* lse,
                         const void* delta, void* dk, void* dv, void* ws, int BH, int rep,
                         int N, int L, int D, int n_heads, int causal,
                         int block_causal, int ell, int S, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (BH == 0 || L == 0) return 0;
  if (S < 1 || (S > 1 && ws == nullptr)) return (int)cudaErrorInvalidValue;
  const Mask mask{causal, block_causal, ell};
  RT_DISPATCH_D128(D, {
    return bf16 ? launch_dkv<__nv_bfloat16, kD>(q, k, v, key_bias, dout, lse, delta, dk,
                                                dv, ws, S, BH, rep, N, L, n_heads, mask, s)
                : launch_dkv<float, kD>(q, k, v, key_bias, dout, lse, delta, dk, dv, ws,
                                        S, BH, rep, N, L, n_heads, mask, s);
  });
  return 0;
}
