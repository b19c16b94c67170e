// The forward step of the fp32 register-tiled attention kernels
// (flash_fwd_fma in flash_fwd.cu, varlen_fwd_fma in varlen_fwd.cu, bta_fwd_fma
// in bta_fwd.cu): a walk over staged key tiles that folds each into the
// block's query rows by S = QK^T -> online softmax -> O += PV on the FMA
// pipes, and the store of (o, lse) at its end.
//
// The tile shapes come from a struct C (FwdFma below for flash_fwd_fma and
// varlen_fwd_fma; bta_fwd.cu has its own): BM staged query
// rows, BK keys a staged tile, NT threads as KX key lanes (kx) x RY = NT/KX
// row lanes (ry).  S of a tile: a thread holds rows ry + RY*j (j < RPT) x
// keys kx + KX*i (i < KPT) in registers, reading Q and K as float4; a row's
// max and sum run over its KX key lanes (an aligned lane group) by
// shuffles.  P goes to shared memory (row stride LS); then the thread adds
// P V into O of its rows x dims kx*DPT.. (DPT = D/KX).  Q, K and V have row
// stride LD.  The exponentials are the exact expf.  Masking follows
// common.cuh: a masked logit is NEG_INF, a row that sees no unmasked key
// gets o = 0 and lse = LSE_EMPTY.
#pragma once

#include "tiles.cuh"

namespace rt {

// The tiles of flash_fwd_fma and varlen_fwd_fma: NT threads as KX key lanes
// x NT/KX row lanes (8 x 16; 16 x 16 at D 128, where a thread's O would
// otherwise hold 4 rows x 16 dims); per staged tile of 32 keys a thread folds
// its 4 rows x 4 keys of S into its rows' online softmax and adds P V into O
// of its rows x D/KX dims.  Shared memory: Q (BM rows), K and V (two buffers
// of BK rows each), P (BM x LS), the key bias (two buffers of BK).
template <int D>
struct FwdFma {
  static constexpr int BM = 64, BK = 32, KX = D > 64 ? 16 : 8, NT = D > 64 ? 256 : 128;
  static constexpr int RY = NT / KX, RPT = BM / RY, KPT = BK / KX, DPT = D / KX;
  static constexpr int LD = D + 4, LS = BK + 4;
  static constexpr int Q_OFF = 0, K_OFF = BM * LD, V_OFF = K_OFF + 2 * BK * LD;
  static constexpr int P_OFF = V_OFF + 2 * BK * LD, B_OFF = P_OFF + BM * LS;
  static constexpr size_t SMEM = (size_t)(B_OFF + 2 * BK) * 4;
};

// Online-softmax state of a thread's RPT rows: running max m, running sum l
// over the thread's keys (the lane group's sum is taken at the store), and
// O over its DPT dims.
template <int RPT, int DPT>
struct FmaRows {
  float m[RPT], l[RPT], acc[RPT][DPT];
  __device__ __forceinline__ FmaRows() {
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      m[j] = NEG_INF;
      l[j] = 0.f;
#pragma unroll
      for (int d = 0; d < DPT; ++d) acc[j][d] = 0.f;
    }
  }
};

// Fold staged tile kt (Kt, Vt: BK rows; bt: the keys' additive bias) into
// the thread's rows.  masked(kt, key, row) says that key `key` of the tile
// is hidden from row `row` of the block by an index mask.
template <class C, int D, typename Masked>
__device__ __forceinline__ void fma_fwd_tile(const float* Qs, const float* Kt,
                                             const float* Vt, const float* bt, float* Ps,
                                             int kt, float scale, Masked masked,
                                             FmaRows<C::RPT, C::DPT>& st) {
  constexpr int KX = C::KX, RY = C::RY, RPT = C::RPT, KPT = C::KPT, DPT = C::DPT;
  constexpr int LD = C::LD, LS = C::LS, BK = C::BK;
  const int kx = threadIdx.x % KX, ry = threadIdx.x / KX;
  float s[RPT][KPT];
#pragma unroll
  for (int j = 0; j < RPT; ++j)
#pragma unroll
    for (int i = 0; i < KPT; ++i) s[j][i] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 kk[KPT];
#pragma unroll
    for (int i = 0; i < KPT; ++i)
      kk[i] = *reinterpret_cast<const float4*>(Kt + (kx + KX * i) * LD + d);
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      const float4 qq = *reinterpret_cast<const float4*>(Qs + (ry + RY * j) * LD + d);
#pragma unroll
      for (int i = 0; i < KPT; ++i) s[j][i] = dot4(qq, kk[i], s[j][i]);
    }
  }
  float bk[KPT];
#pragma unroll
  for (int i = 0; i < KPT; ++i) bk[i] = bt[kx + KX * i];
#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    const int row = ry + RY * j;
    float mx = NEG_INF;
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      float x = s[j][i] * scale + bk[i];
      if (masked(kt, kx + KX * i, row)) x = NEG_INF;
      s[j][i] = x;
      mx = fmaxf(mx, x);
    }
#pragma unroll
    for (int off = 1; off < KX; off <<= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_new = fmaxf(st.m[j], mx);
    const float ms = fmaxf(m_new, NEG_HALF);
    const float alpha = st.m[j] <= NEG_HALF ? 0.f : expf(fminf(st.m[j] - ms, 0.f));
    st.m[j] = m_new;
    st.l[j] *= alpha;
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      const float p = s[j][i] > NEG_HALF ? expf(s[j][i] - ms) : 0.f;
      st.l[j] += p;
      Ps[row * LS + kx + KX * i] = p;
    }
#pragma unroll
    for (int d = 0; d < DPT; ++d) st.acc[j][d] *= alpha;
  }
  __syncthreads();
  // O += P V: rows ry+RY*j, dims kx*DPT..
#pragma unroll 2
  for (int c0 = 0; c0 < BK; c0 += 4) {
    float4 pp[RPT];
#pragma unroll
    for (int j = 0; j < RPT; ++j)
      pp[j] = *reinterpret_cast<const float4*>(Ps + (ry + RY * j) * LS + c0);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float vd[DPT];
      load_vec<DPT>(vd, Vt + (c0 + c) * LD + kx * DPT);
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        const float pv = lane_of(pp[j], c);
#pragma unroll
        for (int d = 0; d < DPT; ++d) st.acc[j][d] = fmaf(pv, vd[d], st.acc[j][d]);
      }
    }
  }
}

// The walk over n_kt >= 1 key tiles: load_tile(kt, buf) stages tile kt into
// buffer buf (Ks / Vs + buf * BK * LD, bs + buf * BK) by cp.async without
// committing; Q's copies, issued before the call, join tile 0's group.
template <class C, int D, typename Load, typename Masked>
__device__ __forceinline__ void fma_fwd_walk(const float* Qs, const float* Ks,
                                             const float* Vs, const float* bs, float* Ps,
                                             int n_kt, float scale, Load load_tile,
                                             Masked masked, FmaRows<C::RPT, C::DPT>& st) {
  constexpr int BK = C::BK, LD = C::LD;
  load_tile(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < n_kt; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < n_kt) load_tile(kt + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    fma_fwd_tile<C, D>(Qs, Ks + buf * BK * LD, Vs + buf * BK * LD, bs + buf * BK, Ps, kt,
                       scale, masked, st);
    __syncthreads();                       // buffer `buf` and P are free for tile kt+2
  }
  cp_async_wait<0>();
}

// o = O / l (zeros where l = 0) and lse = max(m, NEG_HALF) + log l
// (LSE_EMPTY where l = 0) of the thread's rows below n; o and lse point at
// the block's first row.
template <class C, int D>
__device__ __forceinline__ void fma_fwd_store(FmaRows<C::RPT, C::DPT>& st, float* o,
                                              float* lse, int n) {
  constexpr int KX = C::KX, RY = C::RY, DPT = C::DPT;
  const int kx = threadIdx.x % KX, ry = threadIdx.x / KX;
#pragma unroll
  for (int j = 0; j < C::RPT; ++j) {
    const float l = group_sum<KX>(st.l[j]);
    const int row = ry + RY * j;
    if (row >= n) continue;
    const float inv = l > 0.f ? 1.f / l : 0.f;
    float* out = o + (size_t)row * D + kx * DPT;
#pragma unroll
    for (int d = 0; d < DPT; ++d) out[d] = st.acc[j][d] * inv;
    if (kx == 0)
      lse[row] = l > 0.f ? fmaxf(st.m[j], NEG_HALF) + logf(fmaxf(l, 1e-30f)) : LSE_EMPTY;
  }
}

}  // namespace rt
