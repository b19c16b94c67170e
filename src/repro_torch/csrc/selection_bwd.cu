// Group-selected sparse attention backward, recomputed from the forward's
// lse: dQ accumulated over each group's k* selected blocks, and each selected
// block's dK, dV summed into the blocked gradients, duplicates summing.
//
// Replaces repro/kernels/selection.py::_bwd_kernel (Pallas, TPU) and the jnp
// scatter that follows it (selection.py::_scatter_blocks).
//
// Layout: q, dO (B, Hkv, G, M, D) with M = g*rep rows per group, kb/vb
// (B, Hkv, NB, ell, D), idx (B, Hkv, G, k*) int32 (-1 = skip), tok_bias
// (B, NB, ell) fp32, lse and delta = rowsum(dO*O) (B, Hkv, G, M) fp32
// -> dq like q, dkb/dvb like kb.
//
// Per valid (row, key) pair: p = exp(s - lse), dS = p*(dO.v - delta)*scale,
// dq += dS*k, dk += dS*q, dv += p*dO: 10*M*k*ell*D FLOP a group against
// the k* blocks of K and V it reads and as many gradient elements it adds.
// p and dS are rounded to the operand dtype before their products.  Invalid
// selections, masked keys and rows with lse = LSE_EMPTY contribute nothing;
// a group with no valid selection writes dq = 0, a block no group selected
// dk = dv = 0.
//
// Design: two paths, chosen by kernels/selection.py::selection_plan.
//   warp   M < 16 (shapenet: 8 rows, ell = 8), one entry point,
//          selection_bwd.  One warp owns one (b, h, group): lanes are (8
//          rows) x (4 lanes per row), each lane holds D/4 dims of its row's
//          q, dO and dq; a row's dot products are summed over its 4 lanes by
//          shuffles.  Each selection's dk, dv is summed over the 8 row
//          groups of lanes by a shuffle reduce-scatter (one dim a lane at
//          D 32) and stored, fp32 and coalesced, into the staging buffer ws
//          (2, B*Hkv*G*k*, ell, D) at slot rank[item*k* + j].  rank comes
//          from a first pass (selection_bwd_ranks): a stable counting sort
//          of each head's selections by block, the order of scatter_plan
//          below, a head's slots starting at its first selection's flat
//          position.  A last pass (selection_bwd_reduce) sums each block's
//          slots in that order and casts.  No atomics: the sums run in a
//          fixed order, so the backward is bit-reproducible.  Groups of 9-15
//          rows take two passes; the second adds into the slots its own
//          lanes stored.
//   tiles  M >= 16 (the LM: 512 rows, ell = 64), the TPU's own split into
//          two entry points, no atomics:
//     selection_dq   on the forward's grid (b, h, group, tile of 64 rows):
//                    stages its rows of Q and dO once and walks the group's
//                    valid selections in staged chunks of keys, recomputing
//                    S, P and dP; dQ stays in registers.
//     selection_dkv  one block per (valid selection, chunk of keys): stages
//                    the chunk's K and V once, streams the group's rows of
//                    Q, dO, lse and delta through shared memory and keeps dK,
//                    dV of its keys in registers; writes them, fp32, into a
//                    staging buffer ws (2, B*Hkv*G*k*, ell, D), as the TPU's
//                    out_specs did.  The blocks run in the order of an
//                    inverse index of idx (kernels/selection.py::
//                    scatter_plan: selections sorted by block, stable, with
//                    each block's [offsets[i], offsets[i+1]) range), so slot
//                    s of ws holds the s-th selection in that order; a second
//                    pass (selection_dkv_reduce) sums each block's range in
//                    order and casts: deterministic.
//     Tiles are staged by cp.async, double-buffered, in the operand dtype:
//       bf16  the products on the tensor cores (mma.sync m16n8k16, fp32
//             accumulation); P and dS go from the accumulator to the next
//             product's A fragment in registers; p from __expf (MUFU).
//       fp32  the FMA pipes in register micro-tiles, P and dS through shared
//             memory (3xTF32 fails shapenet's train check on phi_k.pos).
#include "selection.cuh"

namespace {

using bf16 = __nv_bfloat16;
using rt::dot4;
using rt::lane_of;
using rt::load_vec;
using rt::set_smem;
using rt::stage_rows;
using rt::stage_vals;
using rt::store2;

// ---------------------------------------------------------------------------
// warp: one warp a (b, h, group), 8 rows a pass; each selection's dK, dV
// stored into its staging slot, no atomics.
// ---------------------------------------------------------------------------

constexpr int kWarps = 4;          // (b, h, group) items per block
constexpr int kLanesPerRow = 4;
constexpr int kRowsPerPass = 32 / kLanesPerRow;

// v[0..N): a lane's partials of N dims of its row.  Sum them over the 8 row
// groups of lanes (lane bits O = 16, 8, 4) and scatter the sums: each level
// halves the values a lane keeps (the upper half where its bit O is set) and
// adds its partner's half by one shuffle each; once one value is left, a
// level is a plain shuffle sum.  On return v[0..max(1, N/8)) hold the sums of
// the dims scatter_dims names (N = 8: one dim a lane, 7 shuffles where a
// butterfly over every dim takes 24).
template <int N, int O>
__device__ __forceinline__ void sum_scatter_rows(float* v, int lane) {
  if constexpr (O >= kLanesPerRow) {
    const bool hi = (lane & O) != 0;
    constexpr int H = N >= 2 ? N / 2 : 1;
    if constexpr (N >= 2) {
#pragma unroll
      for (int i = 0; i < H; ++i) {
        const float send = hi ? v[i] : v[i + H];
        const float keep = hi ? v[i + H] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
      }
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], O);
    }
    sum_scatter_rows<H, O / 2>(v, lane);
  }
}

// Which sums sum_scatter_rows<N, O> leaves with a lane: those of its dims
// first.. ; of lanes left with equal sums (N < 8) only the owner stores them.
template <int N, int O>
__device__ __forceinline__ void scatter_dims(int lane, int& first, bool& owner) {
  if constexpr (O >= kLanesPerRow) {
    const bool hi = (lane & O) != 0;
    if constexpr (N >= 2) {
      if (hi) first += N / 2;
    } else {
      owner = owner && !hi;
    }
    scatter_dims<(N >= 2 ? N / 2 : 1), O / 2>(lane, first, owner);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(32 * kWarps)
selection_bwd_kernel(const T* __restrict__ q, const T* __restrict__ kb,
                     const T* __restrict__ vb, const int* __restrict__ idx,
                     const float* __restrict__ tok_bias, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     const int* __restrict__ rank, T* __restrict__ dq,
                     float* __restrict__ ws, int Hkv, int G, int M, int NB, int ell,
                     int k_star, int n_items, int n_slots, float scale) {
  constexpr int DPL = D / kLanesPerRow;      // dims per lane
  constexpr int KEEP = DPL >= kRowsPerPass ? DPL / kRowsPerPass : 1;
  const int item = blockIdx.x * kWarps + threadIdx.x / 32;
  if (item >= n_items) return;               // warp-uniform
  const int lane = threadIdx.x % 32;
  const int rsub = lane / kLanesPerRow;
  const int d0 = (lane % kLanesPerRow) * DPL;
  const int bh = item / G;                   // b * Hkv + h
  const int b = bh / Hkv;
  const int* sel = idx + (size_t)item * k_star;
  const size_t slab = (size_t)n_slots * ell * D;             // ws: (2, n_slots, ell, D)
  int first = 0;                             // the dims this lane stores: d0 + first..
  bool owner = true;
  scatter_dims<DPL, 16>(lane, first, owner);

  for (int r0 = 0; r0 < M; r0 += kRowsPerPass) {
    const int row = r0 + rsub;
    const bool has_row = row < M;
    const size_t qrow = (size_t)item * M + row;
    float qv[DPL], dov[DPL], acc[DPL];
#pragma unroll
    for (int d = 0; d < DPL; ++d) {
      qv[d] = has_row ? rt::to_f(q[qrow * D + d0 + d]) : 0.f;
      dov[d] = has_row ? rt::to_f(dout[qrow * D + d0 + d]) : 0.f;
      acc[d] = 0.f;
    }
    const float l = has_row ? lse[qrow] : rt::LSE_EMPTY;
    const float dl = has_row ? delta[qrow] : 0.f;

    for (int j = 0; j < k_star; ++j) {
      const int blk = sel[j];                // same for every lane
      if (blk < 0 || blk >= NB) continue;    // neither staged nor summed
      const size_t blk0 = ((size_t)bh * NB + blk) * ell;
      const T* kp = kb + blk0 * D;
      const T* vp = vb + blk0 * D;
      const float* tb = tok_bias + ((size_t)b * NB + blk) * ell;
      float* wk = ws + (size_t)rank[(size_t)item * k_star + j] * ell * D + d0 + first;
      for (int c = 0; c < ell; ++c) {
        float gk[DPL], gv[DPL];
        if (tb[c] <= rt::NEG_HALF) {         // masked key: p == 0 on every row
          if (r0 > 0 || !owner) continue;
#pragma unroll
          for (int i = 0; i < KEEP; ++i) wk[c * D + i] = wk[slab + c * D + i] = 0.f;
          continue;
        }
        float kc[DPL], sp = 0.f, dpp = 0.f;
#pragma unroll
        for (int d = 0; d < DPL; ++d) {
          kc[d] = rt::to_f(kp[c * D + d0 + d]);
          sp = fmaf(qv[d], kc[d], sp);
          dpp = fmaf(dov[d], rt::to_f(vp[c * D + d0 + d]), dpp);
        }
        sp = rt::group_sum<kLanesPerRow>(sp);
        dpp = rt::group_sum<kLanesPerRow>(dpp);
        const float p = rt::p_from_lse(sp * scale + tb[c], l);
        const float dsa = rt::pv_operand<T>(p * (dpp - dl) * scale);
        const float pa = rt::pv_operand<T>(p);
#pragma unroll
        for (int d = 0; d < DPL; ++d) {
          acc[d] = fmaf(dsa, kc[d], acc[d]);
          gk[d] = dsa * qv[d];
          gv[d] = pa * dov[d];
        }
        sum_scatter_rows<DPL, 16>(gk, lane);
        sum_scatter_rows<DPL, 16>(gv, lane);
        if (!owner) continue;
        float* pk = wk + c * D;
        float* pv = pk + slab;
#pragma unroll
        for (int i = 0; i < KEEP; ++i) {     // a later pass adds to its own stores
          pk[i] = r0 > 0 ? pk[i] + gk[i] : gk[i];
          pv[i] = r0 > 0 ? pv[i] + gv[i] : gv[i];
        }
      }
    }
    if (!has_row) continue;
#pragma unroll
    for (int d = 0; d < DPL; ++d) dq[qrow * D + d0 + d] = rt::from_f<T>(acc[d]);
  }
}

// ---------------------------------------------------------------------------
// selection_dq, bf16: tensor cores.  4 warps, warp w owns rows 16w..16w+15
// of the block's 64; per staged chunk of 64 keys a warp computes S and dP
// (16 rows x 64 keys), turns dS into A fragments and adds dS K into its dQ.
// ---------------------------------------------------------------------------
template <int D>
struct DqMma {
  static constexpr int BM = 64, BK = 64, NT = 128, LD = D + 8;
  static constexpr int Q_OFF = 0, DO_OFF = BM * LD, K_OFF = 2 * BM * LD;
  static constexpr int V_OFF = K_OFF + 2 * BK * LD, BF_END = V_OFF + 2 * BK * LD;
  // + the selection list, k* + 1 ints
  static constexpr size_t SMEM = (size_t)BF_END * 2 + (size_t)2 * BK * 4;
};

template <int D>
__global__ void __launch_bounds__(128, 1)
selection_dq_mma(const bf16* __restrict__ q, const bf16* __restrict__ kb,
                 const bf16* __restrict__ vb, const int* __restrict__ idx,
                 const float* __restrict__ tok_bias, const bf16* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 bf16* __restrict__ dq, int Hkv, int G, int M, int NB, int ell, int k_star,
                 float scale) {
  using C = DqMma<D>;
  constexpr int BK = C::BK, LD = C::LD;
  bf16* sm = reinterpret_cast<bf16*>(rt::dyn_smem());
  bf16* Qs = sm + C::Q_OFF;
  bf16* Ds = sm + C::DO_OFF;
  float* bs = reinterpret_cast<float*>(sm + C::BF_END);    // [2][BK]
  int* list = reinterpret_cast<int*>(bs + 2 * BK);        // [k* + 1]

  const int lane = threadIdx.x % 32, g = lane / 4, tig = lane % 4;
  const int rw = (threadIdx.x / 32) * 16;                   // the warp's first row
  const int item = blockIdx.x;                              // (b * Hkv + h) * G + group
  const int bh = item / G, b = bh / Hkv;
  const int row0 = blockIdx.y * C::BM;
  const int nrows = min(C::BM, M - row0);
  const size_t base = (size_t)item * M + row0;

  const bool live = threadIdx.x < nrows && lse[base + threadIdx.x] < rt::LSE_HALF;
  if (!__syncthreads_or(live)) {           // every row empty: dq == 0
    rt::store_zeros(dq + base * D, nrows * D);
    return;
  }
  const int n_sel = rt::collect_selections(idx + (size_t)item * k_star, k_star, NB, list);
  const int nch = (ell + BK - 1) / BK;
  const int n_tiles = n_sel * nch;
  stage_rows<bf16, D, LD>(Qs, q + base * D, nrows, C::BM, C::NT);
  stage_rows<bf16, D, LD>(Ds, dout + base * D, nrows, C::BM, C::NT);
  auto load_tile = [&](int t, int buf) {
    rt::stage_block_chunk<bf16, D, LD, BK>(sm + C::K_OFF + buf * BK * LD,
                                           sm + C::V_OFF + buf * BK * LD, bs + buf * BK,
                                           kb, vb, tok_bias, bh, b, list[1 + t / nch],
                                           (t % nch) * BK, NB, ell, C::NT);
  };

  float l[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = rw + g + 8 * h;
    const bool ok = r < nrows;
    l[h] = ok ? lse[base + r] : rt::LSE_EMPTY;
    dl[h] = ok ? delta[base + r] : 0.f;
  }
  float dqa[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[i][e] = 0.f;

  if (n_tiles > 0) load_tile(0, 0);
  rt::cp_async_commit();
  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_tiles) load_tile(t + 1, buf ^ 1);
    rt::cp_async_commit();
    rt::cp_async_wait<1>();
    __syncthreads();
    const bf16* Kt = sm + C::K_OFF + buf * BK * LD;
    const bf16* Vt = sm + C::V_OFF + buf * BK * LD;
    const float* bt = bs + buf * BK;
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
        const float p = rt::p_from_lse_fast(st[nt][e] * scale + bt[nt * 8 + tig * 2 + (e % 2)],
                                       l[h]);
        dp[nt][e] = p * (dp[nt][e] - dl[h]) * scale;
      }
    }
    // dQ += dS K over the chunk's keys
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t sa[4];
      sa[0] = rt::pack_bf16(dp[2 * kk][0], dp[2 * kk][1]);
      sa[1] = rt::pack_bf16(dp[2 * kk][2], dp[2 * kk][3]);
      sa[2] = rt::pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
      sa[3] = rt::pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
#pragma unroll
      for (int n0 = 0; n0 < D; n0 += 16) {
        const int boff = (kk * 16 + lane % 8 + 8 * ((lane / 8) % 2)) * LD + n0 + 8 * (lane / 16);
        uint32_t kf[4];
        rt::ldmatrix_x4_trans(kf, Kt + boff);
        rt::mma_bf16(dqa[n0 / 8], sa, kf[0], kf[1]);
        rt::mma_bf16(dqa[n0 / 8 + 1], sa, kf[2], kf[3]);
      }
    }
    __syncthreads();                       // buffer `buf` is free for chunk t+2
  }
  rt::cp_async_wait<0>();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = rw + g + 8 * h;
    if (r >= nrows) continue;
    bf16* out = dq + (base + r) * D + tig * 2;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
      store2<bf16>(out + nt * 8, dqa[nt][2 * h], dqa[nt][2 * h + 1]);
  }
}

// ---------------------------------------------------------------------------
// selection_dq, fp32: FMA pipes, register-tiled.  NT threads as 16 key lanes
// (kx) x RY row lanes (ry).  S and dP of a staged chunk: a thread holds rows
// ry+RY*j (j < 64/RY) x keys kx+16i (i < BK/16).  dS goes to shared memory;
// then the thread adds dS K into dQ of its rows x D/16 dims.
// ---------------------------------------------------------------------------
template <int D>
struct DqFma {
  static constexpr int BM = 64, BK = 32, NT = D > 64 ? 256 : 128;
  static constexpr int RY = NT / 16, RPT = BM / RY, KPT = BK / 16, DPT = D / 16;
  static constexpr int LD = D + 4, LS = BK + 4;
  static constexpr int Q_OFF = 0, DO_OFF = BM * LD, K_OFF = 2 * BM * LD;
  static constexpr int V_OFF = K_OFF + 2 * BK * LD, S_OFF = V_OFF + 2 * BK * LD;
  static constexpr int L_OFF = S_OFF + BM * LS, DL_OFF = L_OFF + BM, B_OFF = DL_OFF + BM;
  // + the selection list, k* + 1 ints
  static constexpr size_t SMEM = (size_t)(B_OFF + 2 * BK) * 4;
};

template <int D>
__global__ void __launch_bounds__(DqFma<D>::NT, 1)
selection_dq_fma(const float* __restrict__ q, const float* __restrict__ kb,
                 const float* __restrict__ vb, const int* __restrict__ idx,
                 const float* __restrict__ tok_bias, const float* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 float* __restrict__ dq, int Hkv, int G, int M, int NB, int ell, int k_star,
                 float scale) {
  using C = DqFma<D>;
  constexpr int BK = C::BK, LD = C::LD, LS = C::LS, RY = C::RY, RPT = C::RPT;
  constexpr int KPT = C::KPT, DPT = C::DPT;
  float* sm = reinterpret_cast<float*>(rt::dyn_smem());
  float* Qs = sm + C::Q_OFF;
  float* Ds = sm + C::DO_OFF;
  float* Ss = sm + C::S_OFF;
  float* ls = sm + C::L_OFF;
  float* dls = sm + C::DL_OFF;
  float* bs = sm + C::B_OFF;                                // [2][BK]
  int* list = reinterpret_cast<int*>(bs + 2 * BK);          // [k* + 1]

  const int kx = threadIdx.x % 16, ry = threadIdx.x / 16;
  const int item = blockIdx.x;
  const int bh = item / G, b = bh / Hkv;
  const int row0 = blockIdx.y * C::BM;
  const int nrows = min(C::BM, M - row0);
  const size_t base = (size_t)item * M + row0;

  const bool live = threadIdx.x < nrows && lse[base + threadIdx.x] < rt::LSE_HALF;
  if (!__syncthreads_or(live)) {           // every row empty: dq == 0
    rt::store_zeros(dq + base * D, nrows * D);
    return;
  }
  const int n_sel = rt::collect_selections(idx + (size_t)item * k_star, k_star, NB, list);
  const int nch = (ell + BK - 1) / BK;
  const int n_tiles = n_sel * nch;
  stage_rows<float, D, LD>(Qs, q + base * D, nrows, C::BM, C::NT);
  stage_rows<float, D, LD>(Ds, dout + base * D, nrows, C::BM, C::NT);
  stage_vals(ls, lse + base, nrows, C::BM, rt::LSE_EMPTY, C::NT);
  stage_vals(dls, delta + base, nrows, C::BM, 0.f, C::NT);
  auto load_tile = [&](int t, int buf) {
    rt::stage_block_chunk<float, D, LD, BK>(sm + C::K_OFF + buf * BK * LD,
                                            sm + C::V_OFF + buf * BK * LD, bs + buf * BK,
                                            kb, vb, tok_bias, bh, b, list[1 + t / nch],
                                            (t % nch) * BK, NB, ell, C::NT);
  };

  float dqa[RPT][DPT];
#pragma unroll
  for (int j = 0; j < RPT; ++j)
#pragma unroll
    for (int m = 0; m < DPT; ++m) dqa[j][m] = 0.f;

  if (n_tiles > 0) load_tile(0, 0);
  rt::cp_async_commit();
  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_tiles) load_tile(t + 1, buf ^ 1);
    rt::cp_async_commit();
    rt::cp_async_wait<1>();
    __syncthreads();
    const float* Kt = sm + C::K_OFF + buf * BK * LD;
    const float* Vt = sm + C::V_OFF + buf * BK * LD;
    const float* bt = bs + buf * BK;
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
        const float p = rt::p_from_lse(st[j][i] * scale + bt[key], ls[row]);
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
  rt::cp_async_wait<0>();
#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    const int row = ry + RY * j;
    if (row >= nrows) continue;
    float* out = dq + (base + row) * D + kx * DPT;
#pragma unroll
    for (int m = 0; m < DPT; ++m) out[m] = dqa[j][m];
  }
}

// The selection a selection_dkv block owns: slot s of the inverse index,
// its group item = (b * Hkv + h) * G + group and its block.  false when s is
// past the valid selections (offsets[n_blocks]).
struct Slot {
  int item, blk;
};
__device__ __forceinline__ bool slot_of(int s, const int* order, const int* offsets,
                                        const int* idx, int n_blocks, int k_star, Slot& out) {
  if (s >= offsets[n_blocks]) return false;
  const int pos = order[s];                                 // (item, j) flattened
  out.item = pos / k_star;
  out.blk = idx[pos];
  return true;
}

// ---------------------------------------------------------------------------
// selection_dkv, bf16: tensor cores.  4 warps, warp w owns keys 16w..16w+15
// of the block's chunk of 64; per 32 rows of a staged row tile a warp
// computes S^T and dP^T (16 keys x 32 rows), turns them into P^T and dS^T
// fragments and adds P^T dO and dS^T Q into its dV, dK (16 keys x D, fp32).
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
selection_dkv_mma(const bf16* __restrict__ q, const bf16* __restrict__ kb,
                  const bf16* __restrict__ vb, const int* __restrict__ idx,
                  const float* __restrict__ tok_bias, const bf16* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  const int* __restrict__ order, const int* __restrict__ offsets,
                  float* __restrict__ ws, int n_blocks, int n_slots, int Hkv, int G, int M,
                  int NB, int ell, int k_star, float scale) {
  using C = DkvMma<D>;
  constexpr int BM = C::BM, LD = C::LD;
  Slot sl;
  if (!slot_of(blockIdx.x, order, offsets, idx, n_blocks, k_star, sl)) return;
  bf16* sm = reinterpret_cast<bf16*>(rt::dyn_smem());
  bf16* Ks = sm + C::K_OFF;
  bf16* Vs = sm + C::V_OFF;
  float* ls = reinterpret_cast<float*>(sm + C::BF_END);   // [2][BM]
  float* dls = ls + 2 * BM;                                // [2][BM]
  float* bs = dls + 2 * BM;                                // [BK]

  const int lane = threadIdx.x % 32, g = lane / 4, tig = lane % 4;
  const int kw = (threadIdx.x / 32) * 16;                   // the warp's first key
  const int bh = sl.item / G, b = bh / Hkv;
  const int j0 = blockIdx.y * C::BK;
  const int nk = min(C::BK, ell - j0);

  rt::stage_block_chunk<bf16, D, LD, C::BK>(Ks, Vs, bs, kb, vb, tok_bias, bh, b, sl.blk, j0,
                                            NB, ell, C::NT);
  const int n_tiles = (M + BM - 1) / BM;
  const size_t rows0 = (size_t)sl.item * M;
  auto load_tile = [&](int it, int buf) {
    const int t0 = it * BM;
    const int n = min(BM, M - t0);
    const size_t row0 = rows0 + t0;
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

  load_tile(0, 0);
  rt::cp_async_commit();
  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_tiles) load_tile(it + 1, buf ^ 1);
    rt::cp_async_commit();
    rt::cp_async_wait<1>();
    const float* lt = ls + buf * BM;
    const float* dlt = dls + buf * BM;
    const bool row_live = threadIdx.x < BM && lt[threadIdx.x] < rt::LSE_HALF;
    // the tile has a live row, and the warp a key of the block
    if (__syncthreads_or(row_live) && kw < nk) {
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
            const float p = rt::p_from_lse_fast(st[nt][e] * scale + bs[key], lt[row]);
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

  const size_t slab = (size_t)n_slots * ell * D;            // one (slots, ell, D) array
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = kw + g + 8 * h;
    if (key >= nk) continue;
    const size_t off = ((size_t)blockIdx.x * ell + j0 + key) * D + tig * 2;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      store2<float>(ws + off + nt * 8, dka[nt][2 * h], dka[nt][2 * h + 1]);
      store2<float>(ws + slab + off + nt * 8, dva[nt][2 * h], dva[nt][2 * h + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// selection_dkv, fp32: FMA pipes, register-tiled.  NT threads as 16 key
// lanes (kx) x RY row lanes (ry).  S^T and dP^T of a staged row tile: a
// thread holds keys kx+16i (i < 4) x rows ry+RY*j (j < BM/RY).  P^T and dS^T
// go to shared memory; then the thread adds into dV, dK of its 4 keys x D/RY
// dims.
// ---------------------------------------------------------------------------
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

template <int D>
__global__ void __launch_bounds__(DkvFma<D>::NT, 1)
selection_dkv_fma(const float* __restrict__ q, const float* __restrict__ kb,
                  const float* __restrict__ vb, const int* __restrict__ idx,
                  const float* __restrict__ tok_bias, const float* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  const int* __restrict__ order, const int* __restrict__ offsets,
                  float* __restrict__ ws, int n_blocks, int n_slots, int Hkv, int G, int M,
                  int NB, int ell, int k_star, float scale) {
  using C = DkvFma<D>;
  constexpr int BM = C::BM, LD = C::LD, LP = C::LP, RY = C::RY, RPT = C::RPT, DPT = C::DPT;
  Slot sl;
  if (!slot_of(blockIdx.x, order, offsets, idx, n_blocks, k_star, sl)) return;
  float* sm = reinterpret_cast<float*>(rt::dyn_smem());
  float* Ks = sm + C::K_OFF;
  float* Vs = sm + C::V_OFF;
  float* Ps = sm + C::P_OFF;
  float* Ss = sm + C::S_OFF;
  float* ls = sm + C::L_OFF;
  float* dls = sm + C::DL_OFF;
  float* bs = sm + C::B_OFF;

  const int kx = threadIdx.x % 16, ry = threadIdx.x / 16;
  const int bh = sl.item / G, b = bh / Hkv;
  const int j0 = blockIdx.y * C::BK;
  const int nk = min(C::BK, ell - j0);

  rt::stage_block_chunk<float, D, LD, C::BK>(Ks, Vs, bs, kb, vb, tok_bias, bh, b, sl.blk, j0,
                                             NB, ell, C::NT);
  const int n_tiles = (M + BM - 1) / BM;
  const size_t rows0 = (size_t)sl.item * M;
  auto load_tile = [&](int it, int buf) {
    const int t0 = it * BM;
    const int n = min(BM, M - t0);
    const size_t row0 = rows0 + t0;
    stage_rows<float, D, LD>(sm + C::Q_OFF + buf * BM * LD, q + row0 * D, n, BM, C::NT);
    stage_rows<float, D, LD>(sm + C::DO_OFF + buf * BM * LD, dout + row0 * D, n, BM, C::NT);
    stage_vals(ls + buf * BM, lse + row0, n, BM, rt::LSE_EMPTY, C::NT);
    stage_vals(dls + buf * BM, delta + row0, n, BM, 0.f, C::NT);
  };

  float dka[4][DPT], dva[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int m = 0; m < DPT; ++m) dka[i][m] = dva[i][m] = 0.f;

  load_tile(0, 0);
  rt::cp_async_commit();
  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_tiles) load_tile(it + 1, buf ^ 1);
    rt::cp_async_commit();
    rt::cp_async_wait<1>();
    const float* lt = ls + buf * BM;
    const float* dlt = dls + buf * BM;
    const bool row_live = threadIdx.x < BM && lt[threadIdx.x] < rt::LSE_HALF;
    if (__syncthreads_or(row_live)) {      // block-uniform
      const float* Qt = sm + C::Q_OFF + buf * BM * LD;
      const float* Dt = sm + C::DO_OFF + buf * BM * LD;
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
          const float p = rt::p_from_lse(st[i][j] * scale + bs[key], lt[row]);
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
    __syncthreads();                       // buffers free for the next loads
  }
  rt::cp_async_wait<0>();

  const size_t slab = (size_t)n_slots * ell * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = kx + 16 * i;
    if (key >= nk) continue;
    const size_t off = ((size_t)blockIdx.x * ell + j0 + key) * D + ry * DPT;
#pragma unroll
    for (int m = 0; m < DPT; ++m) {
      ws[off + m] = dka[i][m];
      ws[slab + off + m] = dva[i][m];
    }
  }
}

// Float4 e of the blocked dK (which 0) or dV (which 1), (n_blocks, ell*D/4)
// float4s: the sum of its block's staged slots [lo, hi) in slot order, cast;
// zeros for a block no group selected.  The tiled path's offsets have one
// entry a block and one more (lo = offsets[blk], hi = offsets[blk + 1]); the
// warp path's NB + 1 a head (head_pad 1: block blk of the flat index reads
// entry blk + blk / NB).
template <typename T>
__device__ __forceinline__ void reduce_slots(const float* __restrict__ ws,
                                             const int* __restrict__ offsets,
                                             T* __restrict__ dkb, T* __restrict__ dvb,
                                             int n_slots, int per_blk4, int NB, int head_pad,
                                             size_t e, int which) {
  const int blk = (int)(e / per_blk4), within = (int)(e % per_blk4);
  const int o = blk + head_pad * (blk / NB);
  const int lo = offsets[o], hi = offsets[o + 1];
  const float4* src =
      reinterpret_cast<const float4*>(ws) + (size_t)which * n_slots * per_blk4 + within;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
  for (int s = lo; s < hi; ++s) {
    const float4 x = src[(size_t)s * per_blk4];
    a.x += x.x, a.y += x.y, a.z += x.z, a.w += x.w;
  }
  T* out = (which == 0 ? dkb : dvb) + e * 4;
  store2<T>(out, a.x, a.y);
  store2<T>(out + 2, a.z, a.w);
}

// The tiled path's second pass (selection_dkv's staging buffer).
template <typename T>
__global__ void __launch_bounds__(256)
selection_dkv_reduce(const float* __restrict__ ws, const int* __restrict__ offsets,
                     T* __restrict__ dkb, T* __restrict__ dvb, int n_slots, int per_blk4,
                     size_t n4) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e < n4) reduce_slots<T>(ws, offsets, dkb, dvb, n_slots, per_blk4, 1, 0, e, blockIdx.y);
}

// The warp path's second pass (selection_bwd_kernel's staging buffer).
template <typename T>
__global__ void __launch_bounds__(256)
selection_bwd_reduce(const float* __restrict__ ws, const int* __restrict__ offsets,
                     T* __restrict__ dkb, T* __restrict__ dvb, int n_slots, int per_blk4,
                     int NB, size_t n4) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e < n4) reduce_slots<T>(ws, offsets, dkb, dvb, n_slots, per_blk4, NB, 1, e, blockIdx.y);
}

// The warp path's slots (what scatter_plan's inverse index is to the tiled
// path), one warp a (b, h) head, no atomics: the head's n = G*k* selections
// are walked in (g, j) order twice, 32 at a time (RUN chunks loaded ahead).
// Lanes that pick one block find each other by __match_any_sync, and the
// lowest of them updates the block's counter in shared memory, so no two
// lanes write one counter.  Pass 1 counts each block's valid selections; an
// exclusive scan gives offsets[bh][blk] = bh*n + (the head's valid
// selections of blocks before blk) and offsets[bh][NB] the end of the
// head's; pass 2 gives each valid selection its slot rank = offsets[bh][blk]
// + (its block's earlier selections in (g, j) order), the stable order of
// scatter_plan, head by head, and an invalid one -1 (never staged).  A head's
// slots start at bh*n, so no head waits for another's count.  Dynamic shared
// memory: NB ints.
constexpr int kRankRun = 16;

__global__ void __launch_bounds__(32)
selection_bwd_ranks(const int* __restrict__ idx, int* __restrict__ rank,
                    int* __restrict__ offsets, int n, int NB) {
  int* cnt = reinterpret_cast<int*>(rt::dyn_smem());
  const int lane = threadIdx.x;
  const size_t head = blockIdx.x;
  const int* sel = idx + head * n;
  int* rk = rank + head * n;
  int* off = offsets + head * (NB + 1);
  const unsigned below = (1u << lane) - 1u;
  for (int i = lane; i < NB; i += 32) cnt[i] = 0;
  __syncwarp();
  // walk(f): f(p, blk, valid, group) for every selection p, chunk by chunk
  auto walk = [&](auto f) {
    for (int c0 = 0; c0 < n; c0 += 32 * kRankRun) {
      int blk[kRankRun];
#pragma unroll
      for (int u = 0; u < kRankRun; ++u) {
        const int p = c0 + 32 * u + lane;
        blk[u] = p < n ? sel[p] : -1;
      }
#pragma unroll
      for (int u = 0; u < kRankRun; ++u) {
        const int p = c0 + 32 * u + lane;
        const bool valid = blk[u] >= 0 && blk[u] < NB;
        const unsigned group = __match_any_sync(0xffffffffu, valid ? blk[u] : -1);
        f(p, blk[u], valid, group);
        __syncwarp();
      }
    }
  };
  walk([&](int, int b, bool valid, unsigned group) {
    if (valid && (group & below) == 0) cnt[b] += __popc(group);
  });
  int carry = (int)(head * n);
  for (int i0 = 0; i0 < NB; i0 += 32) {
    const int i = i0 + lane;
    const int c = i < NB ? cnt[i] : 0;
    int x = c;                                      // inclusive scan over the warp
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    if (i < NB) cnt[i] = off[i] = carry + x - c;
    carry += __shfl_sync(0xffffffffu, x, 31);
  }
  if (lane == 0) off[NB] = carry;
  __syncwarp();
  walk([&](int p, int b, bool valid, unsigned group) {
    if (p < n) rk[p] = valid ? cnt[b] + __popc(group & below) : -1;
    __syncwarp();
    if (valid && (group & below) == 0) cnt[b] += __popc(group);
  });
}

// ---------------------------------------------------------------------------

template <typename T, int D>
int launch_warp(const void* q, const void* kb, const void* vb, const void* idx,
                const void* tok_bias, const void* dout, const void* lse, const void* delta,
                void* rank, void* offsets, void* ws, void* dq, void* dkb, void* dvb, int B,
                int Hkv, int G, int M, int NB, int ell, int k_star, cudaStream_t stream) {
  const int n_items = B * Hkv * G, n_slots = n_items * k_star;
  const size_t smem = (size_t)NB * sizeof(int);
  if (int err = set_smem(selection_bwd_ranks, smem)) return err;
  selection_bwd_ranks<<<B * Hkv, 32, smem, stream>>>(static_cast<const int*>(idx),
                                                      static_cast<int*>(rank),
                                                      static_cast<int*>(offsets), G * k_star,
                                                      NB);
  if (int err = (int)cudaGetLastError()) return err;
  const int blocks = (n_items + kWarps - 1) / kWarps;
  if (blocks > 0) {
    selection_bwd_kernel<T, D><<<blocks, 32 * kWarps, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(kb), static_cast<const T*>(vb),
        static_cast<const int*>(idx), static_cast<const float*>(tok_bias),
        static_cast<const T*>(dout), static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<const int*>(rank),
        static_cast<T*>(dq), static_cast<float*>(ws), Hkv, G, M, NB, ell, k_star, n_items,
        n_slots, (float)(1.0 / sqrt((double)D)));
    if (int err = (int)cudaGetLastError()) return err;
  }
  const int per_blk4 = ell * D / 4;
  const size_t n4 = (size_t)B * Hkv * NB * per_blk4;
  const dim3 rgrid((unsigned)((n4 + 255) / 256), 2);
  selection_bwd_reduce<T><<<rgrid, 256, 0, stream>>>(
      static_cast<const float*>(ws), static_cast<const int*>(offsets), static_cast<T*>(dkb),
      static_cast<T*>(dvb), n_slots, per_blk4, NB, n4);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dq(const void* q, const void* kb, const void* vb, const void* idx,
              const void* tok_bias, const void* dout, const void* lse, const void* delta,
              void* dq, int B, int Hkv, int G, int M, int NB, int ell, int k_star,
              cudaStream_t stream) {
  const float scale = (float)(1.0 / sqrt((double)D));
  const size_t list_bytes = (size_t)(k_star + 1) * sizeof(int);
  if constexpr (sizeof(T) == 2) {
    using C = DqMma<D>;
    auto kern = selection_dq_mma<D>;
    const size_t smem = C::SMEM + list_bytes;
    if (int err = set_smem(kern, smem)) return err;
    const dim3 grid(B * Hkv * G, (M + C::BM - 1) / C::BM);
    kern<<<grid, C::NT, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(kb), static_cast<const bf16*>(vb),
        static_cast<const int*>(idx), static_cast<const float*>(tok_bias),
        static_cast<const bf16*>(dout), static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<bf16*>(dq), Hkv, G, M, NB, ell, k_star,
        scale);
  } else {
    using C = DqFma<D>;
    auto kern = selection_dq_fma<D>;
    const size_t smem = C::SMEM + list_bytes;
    if (int err = set_smem(kern, smem)) return err;
    const dim3 grid(B * Hkv * G, (M + C::BM - 1) / C::BM);
    kern<<<grid, C::NT, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(kb),
        static_cast<const float*>(vb), static_cast<const int*>(idx),
        static_cast<const float*>(tok_bias), static_cast<const float*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<float*>(dq), Hkv, G, M, NB, ell, k_star, scale);
  }
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkv(const void* q, const void* kb, const void* vb, const void* idx,
               const void* tok_bias, const void* dout, const void* lse, const void* delta,
               const void* order, const void* offsets, void* ws, void* dkb, void* dvb, int B,
               int Hkv, int G, int M, int NB, int ell, int k_star, cudaStream_t stream) {
  const float scale = (float)(1.0 / sqrt((double)D));
  const int n_blocks = B * Hkv * NB, n_slots = B * Hkv * G * k_star;
  if (n_slots > 0 && M > 0) {
    if constexpr (sizeof(T) == 2) {
      using C = DkvMma<D>;
      auto kern = selection_dkv_mma<D>;
      if (int err = set_smem(kern, C::SMEM)) return err;
      const dim3 grid(n_slots, (ell + C::BK - 1) / C::BK);
      kern<<<grid, C::NT, C::SMEM, stream>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(kb),
          static_cast<const bf16*>(vb), static_cast<const int*>(idx),
          static_cast<const float*>(tok_bias), static_cast<const bf16*>(dout),
          static_cast<const float*>(lse), static_cast<const float*>(delta),
          static_cast<const int*>(order), static_cast<const int*>(offsets),
          static_cast<float*>(ws), n_blocks, n_slots, Hkv, G, M, NB, ell, k_star, scale);
    } else {
      using C = DkvFma<D>;
      auto kern = selection_dkv_fma<D>;
      if (int err = set_smem(kern, C::SMEM)) return err;
      const dim3 grid(n_slots, (ell + C::BK - 1) / C::BK);
      kern<<<grid, C::NT, C::SMEM, stream>>>(
          static_cast<const float*>(q), static_cast<const float*>(kb),
          static_cast<const float*>(vb), static_cast<const int*>(idx),
          static_cast<const float*>(tok_bias), static_cast<const float*>(dout),
          static_cast<const float*>(lse), static_cast<const float*>(delta),
          static_cast<const int*>(order), static_cast<const int*>(offsets),
          static_cast<float*>(ws), n_blocks, n_slots, Hkv, G, M, NB, ell, k_star, scale);
    }
    if (int err = (int)cudaGetLastError()) return err;
  }
  const int per_blk4 = ell * D / 4;
  const size_t n4 = (size_t)n_blocks * per_blk4;
  const dim3 rgrid((unsigned)((n4 + 255) / 256), 2);
  selection_dkv_reduce<T><<<rgrid, 256, 0, stream>>>(
      static_cast<const float*>(ws), static_cast<const int*>(offsets), static_cast<T*>(dkb),
      static_cast<T*>(dvb), n_slots, per_blk4, n4);
  return (int)cudaGetLastError();
}

}  // namespace

// The warp path: rank (B*Hkv*G*k*) and offsets (B*Hkv, NB+1) int32 scratch
// that selection_bwd_ranks fills, ws (2, B*Hkv*G*k*, ell, D) fp32 staging;
// dkb, dvb like kb, written whole.
extern "C" int selection_bwd(const void* q, const void* kb, const void* vb,
                             const void* idx, const void* tok_bias, const void* dout,
                             const void* lse, const void* delta, void* rank, void* offsets,
                             void* ws, void* dq, void* dkb, void* dvb, int B, int Hkv, int G,
                             int M, int NB, int ell, int k_star, int D, int bf16,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B * Hkv * NB == 0) return 0;
  RT_DISPATCH_D128(D, {
    return bf16 ? launch_warp<__nv_bfloat16, kD>(q, kb, vb, idx, tok_bias, dout, lse,
                                                 delta, rank, offsets, ws, dq, dkb, dvb, B,
                                                 Hkv, G, M, NB, ell, k_star, s)
                : launch_warp<float, kD>(q, kb, vb, idx, tok_bias, dout, lse, delta, rank,
                                         offsets, ws, dq, dkb, dvb, B, Hkv, G, M, NB, ell,
                                         k_star, s);
  });
  return 0;
}

// The tiled path's dQ.
extern "C" int selection_dq(const void* q, const void* kb, const void* vb, const void* idx,
                            const void* tok_bias, const void* dout, const void* lse,
                            const void* delta, void* dq, int B, int Hkv, int G, int M,
                            int NB, int ell, int k_star, int D, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B * Hkv * G == 0 || M == 0) return 0;
  RT_DISPATCH_D128(D, {
    return bf16 ? launch_dq<__nv_bfloat16, kD>(q, kb, vb, idx, tok_bias, dout, lse, delta,
                                               dq, B, Hkv, G, M, NB, ell, k_star, s)
                : launch_dq<float, kD>(q, kb, vb, idx, tok_bias, dout, lse, delta, dq, B,
                                       Hkv, G, M, NB, ell, k_star, s);
  });
  return 0;
}

// The tiled path's dK, dV: order / offsets the inverse index of idx
// (kernels/selection.py::scatter_plan; offsets has B*Hkv*NB + 1 entries),
// ws (2, B*Hkv*G*k*, ell, D) fp32 staging; dkb, dvb like kb, written whole.
extern "C" int selection_dkv(const void* q, const void* kb, const void* vb, const void* idx,
                             const void* tok_bias, const void* dout, const void* lse,
                             const void* delta, const void* order, const void* offsets,
                             void* ws, void* dkb, void* dvb, int B, int Hkv, int G, int M,
                             int NB, int ell, int k_star, int D, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B * Hkv * NB == 0) return 0;
  RT_DISPATCH_D128(D, {
    return bf16 ? launch_dkv<__nv_bfloat16, kD>(q, kb, vb, idx, tok_bias, dout, lse, delta,
                                                order, offsets, ws, dkb, dvb, B, Hkv, G, M,
                                                NB, ell, k_star, s)
                : launch_dkv<float, kD>(q, kb, vb, idx, tok_bias, dout, lse, delta, order,
                                        offsets, ws, dkb, dvb, B, Hkv, G, M, NB, ell,
                                        k_star, s);
  });
  return 0;
}
