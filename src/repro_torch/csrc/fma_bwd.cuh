// The blocks of the fp32 register-tiled backward kernels: the dK/dV block
// (flash_dkv_fma in flash_bwd.cu, varlen_dkv_fma in varlen_bwd.cu) with the
// fixed-order sum of its row-split partials, and the dQ block (flash_dq_fma,
// varlen_dq_fma).
//
// dK/dV.  A block owns one tile of BK = 64 keys of one KV head and one range
// of query positions [lo, hi).  It stages the tile's K, V and key bias once,
// walks the range for each of the rep query heads of the GQA group in staged
// tiles of BM rows (Q, dO, lse, delta; cp.async, double-buffered) and keeps
// dK, dV of its keys in registers.  NT threads as 16 key lanes (kx) x RY row
// lanes (ry).  The tile step: S^T and dP^T of a staged tile, a thread holding
// keys kx+16i (i < 4) x rows ry+RY*j (j < BM/RY), four float4 operands a
// step; P^T and dS^T go to shared memory; then the thread adds dV += P^T dO
// and dK += dS^T Q into its 4 keys x D/RY dims.  A staged tile whose rows are
// all LSE_EMPTY is skipped.  visible(key, t) is the caller's index mask
// (absolute key and position); masked pairs, keys with bias at or below
// NEG_INF/2 and rows with lse = LSE_EMPTY give p = 0.
//
// The store: with S == 1 the block writes dk, dv (the block's keys only); with
// S > 1 split s writes fp32 partials into ws (2, S, heads, L, D) and a second
// pass (dkv_reduce_elem) sums them in split order and casts: no atomics,
// deterministic.
//
// dQ.  A block owns BM = 64 query rows and walks a range of keys in staged
// tiles of BK = 32 (K, V, key bias; cp.async, double-buffered), with its
// rows' Q, dO, lse and delta staged once.  NT threads as 16 key lanes (kx) x
// RY row lanes (ry).  S and dP of a staged key tile: a thread holds rows
// ry+RY*j (j < BM/RY) x keys kx+16i (i < BK/16); dS goes to shared memory;
// then the thread adds dS K into dQ of its rows x D/16 dims, each row's dQ
// summed by its own threads in key order: no atomics.  A block whose rows
// are all LSE_EMPTY writes zeros and stages nothing.
#pragma once

#include "tiles.cuh"

namespace rt {

template <int D>
struct DkvFma {
  static constexpr int BK = 64, BM = D > 64 ? 32 : 64, NT = D > 64 ? 256 : 128;
  static constexpr int RY = NT / 16, RPT = BM / RY, DPT = D / RY;
  static constexpr int LD = D + 4, LP = BM + 4;
  static constexpr int K_OFF = 0, V_OFF = BK * LD, Q_OFF = 2 * BK * LD;
  static constexpr int DO_OFF = Q_OFF + 2 * BM * LD, P_OFF = DO_OFF + 2 * BM * LD;
  static constexpr int S_OFF = P_OFF + BK * LP, L_OFF = S_OFF + BK * LP;
  static constexpr int DL_OFF = L_OFF + 2 * BM, B_OFF = DL_OFF + 2 * BM;
  static constexpr size_t SMEM = (size_t)(B_OFF + BK) * 4;
};

// One staged row tile (rows t0.. of one query head) folded into dka, dva.
template <int D, typename Visible>
__device__ __forceinline__ void fma_dkv_tile(const float* Ks, const float* Vs,
                                             const float* bs, const float* Qt,
                                             const float* Dt, const float* lt,
                                             const float* dlt, float* Ps, float* Ss,
                                             int j0, int t0, float scale, Visible visible,
                                             float (&dka)[4][DkvFma<D>::DPT],
                                             float (&dva)[4][DkvFma<D>::DPT]) {
  using C = DkvFma<D>;
  constexpr int BM = C::BM, LD = C::LD, LP = C::LP, RY = C::RY, RPT = C::RPT, DPT = C::DPT;
  const int kx = threadIdx.x % 16, ry = threadIdx.x / 16;
  float st[4][RPT], dp[4][RPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < RPT; ++j) st[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 kk[4], vv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      kk[i] = *reinterpret_cast<const float4*>(Ks + (kx + 16 * i) * LD + d);
      vv[i] = *reinterpret_cast<const float4*>(Vs + (kx + 16 * i) * LD + d);
    }
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      const float4 qq = *reinterpret_cast<const float4*>(Qt + (ry + RY * j) * LD + d);
      const float4 oo = *reinterpret_cast<const float4*>(Dt + (ry + RY * j) * LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        st[i][j] = dot4(kk[i], qq, st[i][j]);
        dp[i][j] = dot4(vv[i], oo, dp[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = kx + 16 * i;
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      const int row = ry + RY * j;
      float p = 0.f;
      if (visible(j0 + key, t0 + row)) p = p_from_lse(st[i][j] * scale + bs[key], lt[row]);
      Ps[key * LP + row] = p;
      Ss[key * LP + row] = p * (dp[i][j] - dlt[row]) * scale;
    }
  }
  __syncthreads();
  // dV += P^T dO, dK += dS^T Q: keys kx+16i, dims ry*DPT..
#pragma unroll 2
  for (int r = 0; r < BM; r += 4) {
    float4 pp[4], ss[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      pp[i] = *reinterpret_cast<const float4*>(Ps + (kx + 16 * i) * LP + r);
      ss[i] = *reinterpret_cast<const float4*>(Ss + (kx + 16 * i) * LP + r);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float od[DPT], qd[DPT];
      load_vec<DPT>(od, Dt + (r + c) * LD + ry * DPT);
      load_vec<DPT>(qd, Qt + (r + c) * LD + ry * DPT);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pv = lane_of(pp[i], c), sv = lane_of(ss[i], c);
#pragma unroll
        for (int m = 0; m < DPT; ++m) {
          dva[i][m] = fmaf(pv, od[m], dva[i][m]);
          dka[i][m] = fmaf(sv, qd[m], dka[i][m]);
        }
      }
    }
  }
}

// The whole block: keys [j0, j0 + nk) of head h (k, v (heads, L, D); bias
// points at key j0's), positions [range.x, range.y) of each of the rep query
// heads of h (q, dO (heads, rep, N, D); lse, delta (heads, rep, N)), split s
// of S.  Needs DkvFma<D>::SMEM bytes of dynamic shared memory.
template <int D, typename Visible>
__device__ __forceinline__ void fma_dkv_block(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ bias, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta, float* __restrict__ dk,
    float* __restrict__ dv, float* __restrict__ ws, int h, int heads, int j0, int nk,
    int2 range, int rep, int N, int L, int s, int S, float scale, Visible visible) {
  using C = DkvFma<D>;
  constexpr int BM = C::BM, LD = C::LD, DPT = C::DPT;
  float* sm = reinterpret_cast<float*>(dyn_smem());
  float* Ks = sm + C::K_OFF;
  float* Vs = sm + C::V_OFF;
  float* ls = sm + C::L_OFF;
  float* dls = sm + C::DL_OFF;
  float* bs = sm + C::B_OFF;
  const int kx = threadIdx.x % 16, ry = threadIdx.x / 16;

  stage_rows<float, D, LD>(Ks, k + ((size_t)h * L + j0) * D, nk, C::BK, C::NT);
  stage_rows<float, D, LD>(Vs, v + ((size_t)h * L + j0) * D, nk, C::BK, C::NT);
  for (int i = threadIdx.x; i < C::BK; i += C::NT) bs[i] = i < nk ? bias[i] : NEG_INF;

  const int per_head = (range.y - range.x + BM - 1) / BM;
  const int n_tiles = rep * per_head;
  const size_t rows0 = (size_t)h * rep * N;
  auto load_tile = [&](int it, int buf) {
    const int t0 = range.x + (it % per_head) * BM;
    const int n = min(BM, range.y - t0);
    const size_t row0 = rows0 + (size_t)(it / per_head) * N + t0;
    stage_rows<float, D, LD>(sm + C::Q_OFF + buf * BM * LD, q + row0 * D, n, BM, C::NT);
    stage_rows<float, D, LD>(sm + C::DO_OFF + buf * BM * LD, dout + row0 * D, n, BM, C::NT);
    stage_vals(ls + buf * BM, lse + row0, n, BM, LSE_EMPTY, C::NT);
    stage_vals(dls + buf * BM, delta + row0, n, BM, 0.f, C::NT);
  };

  float dka[4][DPT], dva[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int m = 0; m < DPT; ++m) dka[i][m] = dva[i][m] = 0.f;

  if (n_tiles > 0) load_tile(0, 0);
  cp_async_commit();
  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_tiles) load_tile(it + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    const float* lt = ls + buf * BM;
    const bool row_live = threadIdx.x < BM && lt[threadIdx.x] < LSE_HALF;
    if (__syncthreads_or(row_live))        // block-uniform
      fma_dkv_tile<D>(Ks, Vs, bs, sm + C::Q_OFF + buf * BM * LD,
                      sm + C::DO_OFF + buf * BM * LD, lt, dls + buf * BM, sm + C::P_OFF,
                      sm + C::S_OFF, j0, range.x + (it % per_head) * BM, scale, visible,
                      dka, dva);
    __syncthreads();                       // buffers free for the next loads
  }
  cp_async_wait<0>();

  const size_t slab = (size_t)heads * L * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = kx + 16 * i;
    if (key >= nk) continue;
    const size_t off = ((size_t)h * L + j0 + key) * D + ry * DPT;
    float* outk = S == 1 ? dk + off : ws + (size_t)s * slab + off;
    float* outv = S == 1 ? dv + off : ws + (size_t)(S + s) * slab + off;
#pragma unroll
    for (int m = 0; m < DPT; ++m) {
      outk[m] = dka[i][m];
      outv[m] = dva[i][m];
    }
  }
}

// Element e (a float4) of the second pass: the S split partials of dK
// (which 0) or dV (which 1) summed in split order and cast.
template <typename T>
__device__ __forceinline__ void dkv_reduce_elem(const float* __restrict__ ws,
                                                T* __restrict__ dk, T* __restrict__ dv,
                                                int S, size_t n4, size_t e, int which) {
  const float4* src = reinterpret_cast<const float4*>(ws) + (size_t)which * S * n4 + e;
  float4 a = src[0];
  for (int s = 1; s < S; ++s) {
    const float4 x = src[(size_t)s * n4];
    a.x += x.x, a.y += x.y, a.z += x.z, a.w += x.w;
  }
  T* out = (which == 0 ? dk : dv) + 4 * e;
  store2<T>(out, a.x, a.y);
  store2<T>(out + 2, a.z, a.w);
}

// The dQ block's tiles.
template <int D>
struct DqFma {
  static constexpr int BM = 64, BK = 32, NT = D > 64 ? 256 : 128;
  // three blocks an SM where the registers allow it without spills
  static constexpr int MIN_BLOCKS = D > 64 ? 1 : 3;
  static constexpr int RY = NT / 16, RPT = BM / RY, KPT = BK / 16, DPT = D / 16;
  static constexpr int LD = D + 4, LS = BK + 4;
  static constexpr int Q_OFF = 0, DO_OFF = BM * LD, K_OFF = 2 * BM * LD;
  static constexpr int V_OFF = K_OFF + 2 * BK * LD, S_OFF = V_OFF + 2 * BK * LD;
  static constexpr int L_OFF = S_OFF + BM * LS, DL_OFF = L_OFF + BM, B_OFF = DL_OFF + BM;
  static constexpr size_t SMEM = (size_t)(B_OFF + 2 * BK) * 4;
};

// The whole dQ block: rows [0, nrows) (q, dout, dq at the first row, row
// stride D; lse, delta at the first row) against keys [0, nkeys) (k, v at
// the first key, row stride D; bias at the first key's).  visible(key, row)
// is the caller's index mask (key and row counted from those firsts).  Needs
// DqFma<D>::SMEM bytes of dynamic shared memory.
template <int D, typename Visible>
__device__ __forceinline__ void fma_dq_block(
    const float* __restrict__ q, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta, float* __restrict__ dq,
    int nrows, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ bias, int nkeys, float scale, Visible visible) {
  using C = DqFma<D>;
  constexpr int BK = C::BK, LD = C::LD, LS = C::LS, RY = C::RY, RPT = C::RPT;
  constexpr int KPT = C::KPT, DPT = C::DPT;
  float* sm = reinterpret_cast<float*>(dyn_smem());
  float* Qs = sm + C::Q_OFF;
  float* Ds = sm + C::DO_OFF;
  float* Ss = sm + C::S_OFF;
  float* ls = sm + C::L_OFF;
  float* dls = sm + C::DL_OFF;
  float* bs = sm + C::B_OFF;                                // [2][BK]
  const int kx = threadIdx.x % 16, ry = threadIdx.x / 16;

  const bool live = (int)threadIdx.x < nrows && lse[threadIdx.x] < LSE_HALF;
  if (!__syncthreads_or(live)) {           // every row empty: dq == 0
    store_zeros(dq, nrows * D);
    return;
  }
  const int n_kt = (nkeys + BK - 1) / BK;

  stage_rows<float, D, LD>(Qs, q, nrows, C::BM, C::NT);
  stage_rows<float, D, LD>(Ds, dout, nrows, C::BM, C::NT);
  stage_vals(ls, lse, nrows, C::BM, LSE_EMPTY, C::NT);
  stage_vals(dls, delta, nrows, C::BM, 0.f, C::NT);
  auto load_tile = [&](int kt, int buf) {
    const int j0 = kt * BK, n = min(BK, nkeys - j0);
    stage_rows<float, D, LD>(sm + C::K_OFF + buf * BK * LD, k + (size_t)j0 * D, n, BK, C::NT);
    stage_rows<float, D, LD>(sm + C::V_OFF + buf * BK * LD, v + (size_t)j0 * D, n, BK, C::NT);
    stage_vals(bs + buf * BK, bias + j0, n, BK, NEG_INF, C::NT);
  };

  float dqa[RPT][DPT];
#pragma unroll
  for (int j = 0; j < RPT; ++j)
#pragma unroll
    for (int m = 0; m < DPT; ++m) dqa[j][m] = 0.f;

  if (n_kt > 0) load_tile(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < n_kt; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < n_kt) load_tile(kt + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* Kt = sm + C::K_OFF + buf * BK * LD;
    const float* Vt = sm + C::V_OFF + buf * BK * LD;
    const float* bt = bs + buf * BK;
    const int j0 = kt * BK;
    float st[RPT][KPT], dp[RPT][KPT];
#pragma unroll
    for (int j = 0; j < RPT; ++j)
#pragma unroll
      for (int i = 0; i < KPT; ++i) st[j][i] = dp[j][i] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      float4 kk[KPT], vv[KPT];
#pragma unroll
      for (int i = 0; i < KPT; ++i) {
        kk[i] = *reinterpret_cast<const float4*>(Kt + (kx + 16 * i) * LD + d);
        vv[i] = *reinterpret_cast<const float4*>(Vt + (kx + 16 * i) * LD + d);
      }
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        const float4 qq = *reinterpret_cast<const float4*>(Qs + (ry + RY * j) * LD + d);
        const float4 oo = *reinterpret_cast<const float4*>(Ds + (ry + RY * j) * LD + d);
#pragma unroll
        for (int i = 0; i < KPT; ++i) {
          st[j][i] = dot4(qq, kk[i], st[j][i]);
          dp[j][i] = dot4(oo, vv[i], dp[j][i]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      const int row = ry + RY * j;
#pragma unroll
      for (int i = 0; i < KPT; ++i) {
        const int key = kx + 16 * i;
        float p = 0.f;
        if (visible(j0 + key, row)) p = p_from_lse(st[j][i] * scale + bt[key], ls[row]);
        Ss[row * LS + key] = p * (dp[j][i] - dls[row]) * scale;
      }
    }
    __syncthreads();
    // dQ += dS K: rows ry+RY*j, dims kx*DPT..
#pragma unroll 2
    for (int c0 = 0; c0 < BK; c0 += 4) {
      float4 dd[RPT];
#pragma unroll
      for (int j = 0; j < RPT; ++j)
        dd[j] = *reinterpret_cast<const float4*>(Ss + (ry + RY * j) * LS + c0);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float kd[DPT];
        load_vec<DPT>(kd, Kt + (c0 + c) * LD + kx * DPT);
#pragma unroll
        for (int j = 0; j < RPT; ++j) {
          const float sv = lane_of(dd[j], c);
#pragma unroll
          for (int m = 0; m < DPT; ++m) dqa[j][m] = fmaf(sv, kd[m], dqa[j][m]);
        }
      }
    }
    __syncthreads();                       // buffers free for the next loads
  }
  cp_async_wait<0>();
#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    const int row = ry + RY * j;
    if (row >= nrows) continue;
    float* out = dq + (size_t)row * D + kx * DPT;
#pragma unroll
    for (int m = 0; m < DPT; ++m) out[m] = dqa[j][m];
  }
}

}  // namespace rt
