// Group-selected sparse attention forward: for each (batch, KV head, query
// group), an online softmax over the k* selected blocks of ell keys named by
// idx (-1 = skip), with a token-padding bias inside each block.
//
// Replaces repro/kernels/selection.py::_fwd_kernel (Pallas, TPU).
//
// Layout: q (B, Hkv, G, M, D) with M = g*rep query rows per group,
// kb/vb (B, Hkv, NB, ell, D), idx (B, Hkv, G, k*) int32, tok_bias (B, NB, ell)
// fp32 -> o (B, Hkv, G, M, D), lse (B, Hkv, G, M).
//
// What bounds it on the H100.  Each group reads its k* selected blocks of K
// and V (2*k*ell*D elements) for 4*M*k*ell*D FLOP: at the paper's shapes
// (M = 8 rows, ell = 8, fp32) memory bounds it; at the LM's (M = g*rep = 512
// rows, ell = 64, bf16) a group does 64 FLOP a byte of K/V, so the kernel
// must keep the selected blocks on chip and run its products on the tensor
// cores to get near its bound.
//
// Design.  The TPU scalar-prefetches idx so that its BlockSpecs fetch the
// selected blocks; here a block loads its own group's indices.  Three paths,
// chosen by kernels/selection.py::selection_plan (the wrapper passes
// `path`):
//   groups fp32, M < 16, D <= 64, k*ell <= 32 (shapenet: 8 rows against 4
//          blocks of 8 keys).  A block is one warp and owns one group: it
//          stages the group's valid selections, their K and V rows and
//          token bias and 8 rows of Q into its shared memory (cp.async, 16
//          bytes a copy), then scores all of the group's keys in one pass:
//          one max and one sum a row, no rescale.  S is register-tiled (a
//          lane holds 2 rows x 4 keys, float4 reads of Q and K), P goes
//          through shared memory, and a lane adds P V into 2 rows x D/8
//          dims.  What bounds it is how many groups an SM holds in flight
//          (each waits on an L2 round trip for its picks, then for its
//          rows): 9.6 KB a group at D 32 (unpadded, swizzled rows; P over
//          Q), and a one-warp block frees its memory as soon as it ends.
//   warp   the other M < 16 shapes (bf16, D 128, more keys).  One warp owns
//          one (b, h, group): lanes are (8 rows) x (4 lanes per row), each
//          lane holds D/4 dims of its row's query and accumulator, and a
//          row's dot products are summed across its 4 lanes by shuffles;
//          the k* loop runs inside the warp, keys read from L2.
//   tiles  M >= 16.  One block owns one (b, h, group, tile of 64 rows): it
//          stages its rows of Q once, collects the group's valid selections
//          and walks them in staged chunks of BK keys (cp.async,
//          double-buffered: the next chunk is in flight while the current
//          one is computed), so a selected block is read from L2 once per
//          row tile instead of once per 8 rows.
//            bf16  S = QK^T and O += PV on the tensor cores (mma.sync
//                  m16n8k16, fp32 accumulation), a warp owning 16 rows and
//                  64 keys; P is rounded to bf16 as the A fragment of PV,
//                  and exponentials go to the MUFU unit (__expf).
//            fp32  the FMA pipes, register-tiled: 16 key lanes x NT/16 row
//                  lanes, P through shared memory (no TF32: its 2^-11
//                  operands would miss fp32's tolerances).
// An invalid selection (or an index at or beyond NB) costs nothing; a group
// with no valid selection writes zeros and LSE_EMPTY.  Masked keys (token
// bias NEG_INF) and the key slots past ell in the last chunk get p = 0.
#include "selection.cuh"

namespace {

using bf16 = __nv_bfloat16;
using rt::dot4;
using rt::lane_of;
using rt::load_vec;
using rt::set_smem;
using rt::stage_rows;
using rt::store2;

// ---------------------------------------------------------------------------
// warp: one warp a (b, h, group), 8 rows a pass, keys read from L2.
// ---------------------------------------------------------------------------

constexpr int kWarps = 4;          // (b, h, group) items per block
constexpr int kLanesPerRow = 4;
constexpr int kRowsPerPass = 32 / kLanesPerRow;
constexpr int kChunk = 8;          // keys scored per online-softmax step

template <typename T, int D>
__global__ void __launch_bounds__(32 * kWarps)
selection_fwd_warp(const T* __restrict__ q, const T* __restrict__ kb,
                   const T* __restrict__ vb, const int* __restrict__ idx,
                   const float* __restrict__ tok_bias, T* __restrict__ o,
                   float* __restrict__ lse, int Hkv, int G, int M, int NB, int ell,
                   int k_star, int n_items, float scale) {
  constexpr int DPL = D / kLanesPerRow;      // dims per lane
  const int item = blockIdx.x * kWarps + threadIdx.x / 32;
  if (item >= n_items) return;               // warp-uniform
  const int lane = threadIdx.x % 32;
  const int rsub = lane / kLanesPerRow;
  const int d0 = (lane % kLanesPerRow) * DPL;
  const int bh = item / G;                   // b * Hkv + h
  const int b = bh / Hkv;
  const int* sel = idx + (size_t)item * k_star;

  for (int r0 = 0; r0 < M; r0 += kRowsPerPass) {
    const int row = r0 + rsub;
    const bool has_row = row < M;
    const size_t qrow = (size_t)item * M + row;
    float qv[DPL];
#pragma unroll
    for (int d = 0; d < DPL; ++d)
      qv[d] = has_row ? rt::to_f(q[qrow * D + d0 + d]) : 0.f;
    float m = rt::NEG_INF, l = 0.f, acc[DPL];
#pragma unroll
    for (int d = 0; d < DPL; ++d) acc[d] = 0.f;

    for (int j = 0; j < k_star; ++j) {
      const int blk = sel[j];                // same for every lane
      if (blk < 0 || blk >= NB) continue;
      const T* kp = kb + ((size_t)bh * NB + blk) * ell * D;
      const T* vp = vb + ((size_t)bh * NB + blk) * ell * D;
      const float* tb = tok_bias + ((size_t)b * NB + blk) * ell;
      for (int c0 = 0; c0 < ell; c0 += kChunk) {
        float s[kChunk];
        float cmax = rt::NEG_INF;
#pragma unroll
        for (int c = 0; c < kChunk; ++c) {
          const int key = c0 + c;
          float part = 0.f;
          if (key < ell) {
#pragma unroll
            for (int d = 0; d < DPL; ++d)
              part = fmaf(qv[d], rt::to_f(kp[key * D + d0 + d]), part);
          }
          part += __shfl_xor_sync(0xffffffffu, part, 1);
          part += __shfl_xor_sync(0xffffffffu, part, 2);
          s[c] = key < ell ? part * scale + tb[key] : rt::NEG_INF;
          cmax = fmaxf(cmax, s[c]);
        }
        const float m_new = fmaxf(m, cmax);
        const float m_safe = fmaxf(m_new, rt::NEG_HALF);
        const float alpha = (m <= rt::NEG_HALF) ? 0.f : expf(fminf(m - m_safe, 0.f));
        l *= alpha;
#pragma unroll
        for (int d = 0; d < DPL; ++d) acc[d] *= alpha;
#pragma unroll
        for (int c = 0; c < kChunk; ++c) {
          if (s[c] > rt::NEG_HALF) {
            const float p = expf(s[c] - m_safe);
            l += p;
            const float pv = rt::pv_operand<T>(p);
#pragma unroll
            for (int d = 0; d < DPL; ++d)
              acc[d] = fmaf(pv, rt::to_f(vp[(c0 + c) * D + d0 + d]), acc[d]);
          }
        }
        m = m_new;
      }
    }
    if (!has_row) continue;
    const float inv = 1.f / fmaxf(l, 1e-20f);
#pragma unroll
    for (int d = 0; d < DPL; ++d)
      o[qrow * D + d0 + d] = rt::from_f<T>(l > 0.f ? acc[d] * inv : 0.f);
    if (d0 == 0) {
      const float m_safe = fmaxf(m, rt::NEG_HALF);
      lse[qrow] = l > 0.f ? m_safe + logf(fmaxf(l, 1e-30f)) : rt::LSE_EMPTY;
    }
  }
}

// ---------------------------------------------------------------------------
// groups: fp32, one warp a group, GT warps a block (one: a block frees its
// memory as soon as its group is done), no block barrier.  The warp's region
// of shared memory holds 8 rows of Q, the token bias of its KEYS key slots,
// their K and V rows, its valid picks (in the order of idx) and each slot's
// source row (slot r: valid pick r / ell, key r % ell; -1 past the valid
// keys, whose K and V rows are zero and bias NEG_INF).  At D >= 32 the rows
// of Q, K and V are unpadded and their 16-byte chunks swizzled (chunk c of
// row r at c ^ (r % 8)), and P (8 rows x KEYS) takes the place of Q and the
// bias once S is done: 9.6 KB a warp at D 32, so some 21 one-warp blocks
// fit an SM.  Lane (rp, kx) = (lane / 8, lane % 8): S of rows 2rp, 2rp+1 x
// keys kx + 8i; O of the same rows x the VW-float vectors kx + 8j of D.  A
// row's max and sum run over its 8 lanes (xor 1, 2, 4).
// ---------------------------------------------------------------------------
template <int D>
struct FwdGroups {
  static constexpr int GT = 1, ROWS = 8, KEYS = 32;
  static constexpr bool SWZ = D >= 32;               // swizzled rows (8+ chunks a row)
  static constexpr int LD = SWZ ? D : D + 4, LP = KEYS + 4, KPL = KEYS / 8;
  static constexpr int VW = D >= 32 ? 4 : D / 8, NV = D / (8 * VW);
  // a warp's region, in floats: Q, bias, K, V, then ints: picks, sources;
  // P over Q and the bias where they hold it, else after the ints
  static constexpr int Q_OFF = 0, B_OFF = ROWS * LD, K_OFF = B_OFF + KEYS;
  static constexpr int V_OFF = K_OFF + KEYS * LD, I_OFF = V_OFF + KEYS * LD;
  static constexpr int R_OFF = I_OFF + KEYS, END = R_OFF + KEYS;
  static constexpr bool P_OVER_Q = K_OFF >= ROWS * LP;
  static constexpr int P_OFF = P_OVER_Q ? Q_OFF : END;
  static constexpr int WARP = P_OVER_Q ? END : END + ROWS * LP;   // floats a warp
  static constexpr size_t SMEM = (size_t)GT * WARP * 4;
  // the float offset of 16-byte chunk c of row r of a Q, K or V tile
  __device__ __forceinline__ static int at(int r, int c) {
    return r * LD + (SWZ ? c ^ (r & 7) : c) * 4;
  }
};

template <int D>
__global__ void __launch_bounds__(32 * FwdGroups<D>::GT)
selection_fwd_groups(const float* __restrict__ q, const float* __restrict__ kb,
                     const float* __restrict__ vb, const int* __restrict__ idx,
                     const float* __restrict__ tok_bias, float* __restrict__ o,
                     float* __restrict__ lse, int Hkv, int G, int M, int NB, int ell,
                     int k_star, int n_items, float scale) {
  using C = FwdGroups<D>;
  constexpr int LP = C::LP, KEYS = C::KEYS, KPL = C::KPL, ROWS = C::ROWS;
  constexpr int VW = C::VW, NV = C::NV, CH = D / 4;        // CH: 16-byte chunks a row
  constexpr unsigned FULL = 0xffffffffu;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int item = blockIdx.x * C::GT + warp;              // (b * Hkv + h) * G + group
  if (item >= n_items) return;                             // warp-uniform
  float* sm = reinterpret_cast<float*>(rt::dyn_smem()) + warp * C::WARP;
  float* Qs = sm + C::Q_OFF;
  float* Ks = sm + C::K_OFF;
  float* Vs = sm + C::V_OFF;
  float* Ps = sm + C::P_OFF;
  float* bs = sm + C::B_OFF;
  int* picks = reinterpret_cast<int*>(sm + C::I_OFF);
  int* rows = reinterpret_cast<int*>(sm + C::R_OFF);
  const int bh = item / G, b = bh / Hkv;
  const size_t row0 = (size_t)item * M;
  auto stage_q = [&](int r0) {                             // Q rows r0.. (zero past M)
    for (int c = lane; c < ROWS * CH; c += 32) {
      const int r = c / CH, e = c % CH;
      float* dst = Qs + C::at(r, e);
      if (r0 + r < M)
        rt::cp_async16(dst, q + (row0 + r0 + r) * D + e * 4);
      else
        *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };

  // the valid picks, in the order of idx (k* <= KEYS <= 32)
  const int pick = lane < k_star ? idx[(size_t)item * k_star + lane] : -1;
  const bool ok = pick >= 0 && pick < NB;
  const unsigned valid = __ballot_sync(FULL, ok);
  const int n_keys = __popc(valid) * ell;
  if (n_keys == 0) {                                       // zeros and LSE_EMPTY
    for (int c = lane; c < M * CH; c += 32)
      reinterpret_cast<float4*>(o + row0 * D)[c] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r = lane; r < M; r += 32) lse[row0 + r] = rt::LSE_EMPTY;
    return;
  }
  stage_q(0);
  if (ok) picks[__popc(valid & ((1u << lane) - 1u))] = pick;
  __syncwarp();
  for (int r = lane; r < KEYS; r += 32) {                  // each key slot's source, bias
    const int s = r / ell, c = r - s * ell;
    const int blk = r < n_keys ? picks[s] : -1;
    rows[r] = blk >= 0 ? (bh * NB + blk) * ell + c : -1;
    if (blk >= 0)
      rt::cp_async4(bs + r, tok_bias + ((size_t)b * NB + blk) * ell + c);
    else
      bs[r] = rt::NEG_INF;
  }
  __syncwarp();
  for (int c = lane; c < KEYS * CH; c += 32) {             // K, V rows
    const int r = c / CH, e = c % CH;
    const int src = rows[r];
    float* kd = Ks + C::at(r, e);
    float* vd = Vs + C::at(r, e);
    if (src >= 0) {
      rt::cp_async16(kd, kb + (size_t)src * D + e * 4);
      rt::cp_async16(vd, vb + (size_t)src * D + e * 4);
    } else {
      *reinterpret_cast<float4*>(kd) = make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(vd) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  rt::cp_async_commit();
  rt::cp_async_wait<0>();
  __syncwarp();

  const int rp = lane / 8, kx = lane % 8;
  float bias[KPL];                                         // P may take the bias' place
#pragma unroll
  for (int i = 0; i < KPL; ++i) bias[i] = bs[kx + 8 * i];
  for (int r0 = 0; r0 < M; r0 += ROWS) {
    if (r0 > 0) {                                          // Q rows of a later pass
      __syncwarp();
      stage_q(r0);
      rt::cp_async_commit();
      rt::cp_async_wait<0>();
      __syncwarp();
    }
    // S = Q K^T: rows 2rp + h, keys kx + 8i
    float st[2][KPL];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < KPL; ++i) st[h][i] = 0.f;
#pragma unroll
    for (int d = 0; d < CH; ++d) {
      const float4 q0 = *reinterpret_cast<const float4*>(Qs + C::at(2 * rp, d));
      const float4 q1 = *reinterpret_cast<const float4*>(Qs + C::at(2 * rp + 1, d));
#pragma unroll
      for (int i = 0; i < KPL; ++i) {
        const float4 k4 = *reinterpret_cast<const float4*>(Ks + C::at(kx + 8 * i, d));
        st[0][i] = dot4(q0, k4, st[0][i]);
        st[1][i] = dot4(q1, k4, st[1][i]);
      }
    }
    __syncwarp();                                          // Qs is free for P
    // one softmax pass a row: its max, then p and its sum
    float m[2], l[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = rt::NEG_INF;
#pragma unroll
      for (int i = 0; i < KPL; ++i) {
        st[h][i] = st[h][i] * scale + bias[i];
        mx = fmaxf(mx, st[h][i]);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
      const float ms = fmaxf(mx, rt::NEG_HALF);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < KPL; ++i) {
        const float p = st[h][i] > rt::NEG_HALF ? expf(st[h][i] - ms) : 0.f;
        sum += p;
        Ps[(2 * rp + h) * LP + kx + 8 * i] = p;
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) sum += __shfl_xor_sync(FULL, sum, off);
      m[h] = mx;
      l[h] = sum;
    }
    __syncwarp();
    // O = P V: rows 2rp + h, vectors kx + 8j of D
    float acc[2][NV * VW];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < NV * VW; ++e) acc[h][e] = 0.f;
#pragma unroll
    for (int c0 = 0; c0 < KEYS; c0 += 4) {
      const float4 p0 = *reinterpret_cast<const float4*>(Ps + (2 * rp) * LP + c0);
      const float4 p1 = *reinterpret_cast<const float4*>(Ps + (2 * rp + 1) * LP + c0);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float a0 = lane_of(p0, c), a1 = lane_of(p1, c);
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          float v[VW];
          if constexpr (VW == 4)
            load_vec<VW>(v, Vs + C::at(c0 + c, kx + 8 * j));
          else
            load_vec<VW>(v, Vs + (c0 + c) * C::LD + (kx + 8 * j) * VW);
#pragma unroll
          for (int e = 0; e < VW; ++e) {
            acc[0][j * VW + e] = fmaf(a0, v[e], acc[0][j * VW + e]);
            acc[1][j * VW + e] = fmaf(a1, v[e], acc[1][j * VW + e]);
          }
        }
      }
    }
    float lv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 2 * rp + h;
      lv[h] = l[h] > 0.f ? fmaxf(m[h], rt::NEG_HALF) + logf(fmaxf(l[h], 1e-30f))
                         : rt::LSE_EMPTY;
      if (r >= M) continue;
      const float inv = l[h] > 0.f ? 1.f / l[h] : 0.f;
      float* out = o + (row0 + r) * D;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        float* dst = out + (kx + 8 * j) * VW;
        if constexpr (VW == 4)
          *reinterpret_cast<float4*>(dst) =
              make_float4(acc[h][4 * j] * inv, acc[h][4 * j + 1] * inv,
                          acc[h][4 * j + 2] * inv, acc[h][4 * j + 3] * inv);
        else
          store2<float>(dst, acc[h][2 * j] * inv, acc[h][2 * j + 1] * inv);
      }
    }
    if (M % 4 == 0) {
      // lanes 0, 1 store rows 4t..4t+3 of the pass (held by lanes 16t, 16t + 8)
      const int t = lane & 1;
      const float x0 = __shfl_sync(FULL, lv[0], 16 * t), x1 = __shfl_sync(FULL, lv[1], 16 * t);
      const float x2 = __shfl_sync(FULL, lv[0], 16 * t + 8);
      const float x3 = __shfl_sync(FULL, lv[1], 16 * t + 8);
      if (lane < 2 && r0 + 4 * lane < M)
        *reinterpret_cast<float4*>(lse + row0 + r0 + 4 * lane) = make_float4(x0, x1, x2, x3);
    } else if (kx == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (r0 + 2 * rp + h < M) lse[row0 + r0 + 2 * rp + h] = lv[h];
    }
  }
}

// ---------------------------------------------------------------------------
// tiles, bf16: tensor cores.  4 warps, warp w owns rows 16w..16w+15 of the
// block's 64; per staged chunk of 64 keys a warp computes S (16 rows x 64
// keys), folds it into the running max / sum of its rows, and adds P V into
// its O (16 x D, fp32).
// ---------------------------------------------------------------------------
template <int D>
struct FwdMma {
  static constexpr int BM = 64, BK = 64, NT = 128, LD = D + 8;
  static constexpr int Q_OFF = 0, K_OFF = BM * LD, V_OFF = K_OFF + 2 * BK * LD;
  static constexpr int BF_END = V_OFF + 2 * BK * LD;
  // + the selection list, k* + 1 ints
  static constexpr size_t SMEM = (size_t)BF_END * 2 + (size_t)2 * BK * 4;
};

template <int D>
__global__ void __launch_bounds__(128, 1)
selection_fwd_mma(const bf16* __restrict__ q, const bf16* __restrict__ kb,
                  const bf16* __restrict__ vb, const int* __restrict__ idx,
                  const float* __restrict__ tok_bias, bf16* __restrict__ o,
                  float* __restrict__ lse, int Hkv, int G, int M, int NB, int ell,
                  int k_star, float scale) {
  using C = FwdMma<D>;
  constexpr int BK = C::BK, LD = C::LD;
  bf16* sm = reinterpret_cast<bf16*>(rt::dyn_smem());
  bf16* Qs = sm + C::Q_OFF;
  float* bs = reinterpret_cast<float*>(sm + C::BF_END);     // [2][BK]
  int* list = reinterpret_cast<int*>(bs + 2 * BK);         // [k* + 1]

  const int lane = threadIdx.x % 32, g = lane / 4, tig = lane % 4;
  const int rw = (threadIdx.x / 32) * 16;                   // the warp's first row
  const int item = blockIdx.x;                              // (b * Hkv + h) * G + group
  const int bh = item / G, b = bh / Hkv;
  const int row0 = blockIdx.y * C::BM;
  const int nrows = min(C::BM, M - row0);
  const size_t base = (size_t)item * M + row0;

  const int n_sel = rt::collect_selections(idx + (size_t)item * k_star, k_star, NB, list);
  const int nch = (ell + BK - 1) / BK;                      // chunks a selected block
  const int n_tiles = n_sel * nch;
  stage_rows<bf16, D, LD>(Qs, q + base * D, nrows, C::BM, C::NT);
  auto load_tile = [&](int t, int buf) {
    rt::stage_block_chunk<bf16, D, LD, BK>(sm + C::K_OFF + buf * BK * LD,
                                           sm + C::V_OFF + buf * BK * LD, bs + buf * BK,
                                           kb, vb, tok_bias, bh, b, list[1 + t / nch],
                                           (t % nch) * BK, NB, ell, C::NT);
  };

  float m[2] = {rt::NEG_INF, rt::NEG_INF}, l[2] = {0.f, 0.f};   // rows g, g + 8
  float oa[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) oa[i][e] = 0.f;

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
    float st[BK / 8][4];
#pragma unroll
    for (int i = 0; i < BK / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[i][e] = 0.f;
    // S = Q K^T over D
#pragma unroll
    for (int d0 = 0; d0 < D; d0 += 16) {
      uint32_t qa[4];
      rt::ldmatrix_x4(qa, Qs + (rw + lane % 16) * LD + d0 + (lane / 16) * 8);
#pragma unroll
      for (int np = 0; np < BK / 16; ++np) {
        uint32_t kf[4];
        rt::ldmatrix_x4(kf, Kt + (np * 16 + lane % 8 + 8 * (lane / 16)) * LD + d0 +
                                8 * ((lane / 8) % 2));
        rt::mma_bf16(st[2 * np], qa, kf[0], kf[1]);
        rt::mma_bf16(st[2 * np + 1], qa, kf[2], kf[3]);
      }
    }
    // the online softmax of rows g (h 0) and g + 8 (h 1); a row's 64 keys lie
    // on the 4 lanes of its quad
    float mx[2] = {rt::NEG_INF, rt::NEG_INF};
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        st[nt][e] = st[nt][e] * scale + bt[nt * 8 + tig * 2 + (e % 2)];
        mx[e / 2] = fmaxf(mx[e / 2], st[nt][e]);
      }
    float ms[2], alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      ms[h] = fmaxf(m_new, rt::NEG_HALF);
      alpha[h] = m[h] <= rt::NEG_HALF ? 0.f : __expf(fminf(m[h] - ms[h], 0.f));
      m[h] = m_new;
      l[h] *= alpha[h];
    }
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float s = st[nt][e];
        const float p = s > rt::NEG_HALF ? __expf(s - ms[e / 2]) : 0.f;
        l[e / 2] += p;
        st[nt][e] = p;
      }
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) oa[i][e] *= alpha[e / 2];
    // O += P V over the chunk's keys, P rounded to bf16 as A fragments
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = rt::pack_bf16(st[2 * kk][0], st[2 * kk][1]);
      pa[1] = rt::pack_bf16(st[2 * kk][2], st[2 * kk][3]);
      pa[2] = rt::pack_bf16(st[2 * kk + 1][0], st[2 * kk + 1][1]);
      pa[3] = rt::pack_bf16(st[2 * kk + 1][2], st[2 * kk + 1][3]);
#pragma unroll
      for (int n0 = 0; n0 < D; n0 += 16) {
        uint32_t vf[4];
        rt::ldmatrix_x4_trans(vf, Vt + (kk * 16 + lane % 8 + 8 * ((lane / 8) % 2)) * LD +
                                      n0 + 8 * (lane / 16));
        rt::mma_bf16(oa[n0 / 8], pa, vf[0], vf[1]);
        rt::mma_bf16(oa[n0 / 8 + 1], pa, vf[2], vf[3]);
      }
    }
    __syncthreads();                       // buffer `buf` is free for chunk t+2
  }
  rt::cp_async_wait<0>();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int r = rw + g + 8 * h;
    if (r >= nrows) continue;
    const float inv = l[h] > 0.f ? 1.f / l[h] : 0.f;
    bf16* out = o + (base + r) * D + tig * 2;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
      store2<bf16>(out + nt * 8, oa[nt][2 * h] * inv, oa[nt][2 * h + 1] * inv);
    if (tig == 0)
      lse[base + r] = l[h] > 0.f ? fmaxf(m[h], rt::NEG_HALF) + logf(fmaxf(l[h], 1e-30f))
                                 : rt::LSE_EMPTY;
  }
}

// ---------------------------------------------------------------------------
// tiles, fp32: FMA pipes, register-tiled.  NT threads as 16 key lanes (kx) x
// RY row lanes (ry).  S of a staged chunk: a thread holds rows ry+RY*j
// (j < 64/RY) x keys kx+16i (i < BK/16); a row's max and sum run over its
// 16 key lanes (one half-warp) by shuffles.  P goes to shared memory; then
// the thread adds P V into O of its rows x D/16 dims.
// ---------------------------------------------------------------------------
template <int D>
struct FwdFma {
  static constexpr int BM = 64, BK = 32, NT = D > 64 ? 256 : 128;
  static constexpr int RY = NT / 16, RPT = BM / RY, KPT = BK / 16, DPT = D / 16;
  static constexpr int LD = D + 4, LS = BK + 4;
  static constexpr int Q_OFF = 0, K_OFF = BM * LD, V_OFF = K_OFF + 2 * BK * LD;
  static constexpr int P_OFF = V_OFF + 2 * BK * LD, B_OFF = P_OFF + BM * LS;
  // + the selection list, k* + 1 ints
  static constexpr size_t SMEM = (size_t)(B_OFF + 2 * BK) * 4;
};

template <int D>
__global__ void __launch_bounds__(FwdFma<D>::NT, 1)
selection_fwd_fma(const float* __restrict__ q, const float* __restrict__ kb,
                  const float* __restrict__ vb, const int* __restrict__ idx,
                  const float* __restrict__ tok_bias, float* __restrict__ o,
                  float* __restrict__ lse, int Hkv, int G, int M, int NB, int ell,
                  int k_star, float scale) {
  using C = FwdFma<D>;
  constexpr int BK = C::BK, LD = C::LD, LS = C::LS, RY = C::RY, RPT = C::RPT;
  constexpr int KPT = C::KPT, DPT = C::DPT;
  float* sm = reinterpret_cast<float*>(rt::dyn_smem());
  float* Qs = sm + C::Q_OFF;
  float* Ps = sm + C::P_OFF;
  float* bs = sm + C::B_OFF;                                // [2][BK]
  int* list = reinterpret_cast<int*>(bs + 2 * BK);          // [k* + 1]

  const int kx = threadIdx.x % 16, ry = threadIdx.x / 16;
  const int item = blockIdx.x;
  const int bh = item / G, b = bh / Hkv;
  const int row0 = blockIdx.y * C::BM;
  const int nrows = min(C::BM, M - row0);
  const size_t base = (size_t)item * M + row0;

  const int n_sel = rt::collect_selections(idx + (size_t)item * k_star, k_star, NB, list);
  const int nch = (ell + BK - 1) / BK;
  const int n_tiles = n_sel * nch;
  stage_rows<float, D, LD>(Qs, q + base * D, nrows, C::BM, C::NT);
  auto load_tile = [&](int t, int buf) {
    rt::stage_block_chunk<float, D, LD, BK>(sm + C::K_OFF + buf * BK * LD,
                                            sm + C::V_OFF + buf * BK * LD, bs + buf * BK,
                                            kb, vb, tok_bias, bh, b, list[1 + t / nch],
                                            (t % nch) * BK, NB, ell, C::NT);
  };

  float m[RPT], l[RPT], acc[RPT][DPT];
#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    m[j] = rt::NEG_INF;
    l[j] = 0.f;
#pragma unroll
    for (int d = 0; d < DPT; ++d) acc[j][d] = 0.f;
  }

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
    float st[RPT][KPT];
#pragma unroll
    for (int j = 0; j < RPT; ++j)
#pragma unroll
      for (int i = 0; i < KPT; ++i) st[j][i] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      float4 kk[KPT];
#pragma unroll
      for (int i = 0; i < KPT; ++i)
        kk[i] = *reinterpret_cast<const float4*>(Kt + (kx + 16 * i) * LD + d);
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        const float4 qq = *reinterpret_cast<const float4*>(Qs + (ry + RY * j) * LD + d);
#pragma unroll
        for (int i = 0; i < KPT; ++i) st[j][i] = dot4(qq, kk[i], st[j][i]);
      }
    }
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      float mx = rt::NEG_INF;
#pragma unroll
      for (int i = 0; i < KPT; ++i) {
        st[j][i] = st[j][i] * scale + bt[kx + 16 * i];
        mx = fmaxf(mx, st[j][i]);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[j], mx);
      const float ms = fmaxf(m_new, rt::NEG_HALF);
      const float alpha = m[j] <= rt::NEG_HALF ? 0.f : expf(fminf(m[j] - ms, 0.f));
      m[j] = m_new;
      l[j] *= alpha;
#pragma unroll
      for (int i = 0; i < KPT; ++i) {
        const float p = st[j][i] > rt::NEG_HALF ? expf(st[j][i] - ms) : 0.f;
        l[j] += p;
        Ps[(ry + RY * j) * LS + kx + 16 * i] = p;
      }
#pragma unroll
      for (int d = 0; d < DPT; ++d) acc[j][d] *= alpha;
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
          for (int d = 0; d < DPT; ++d) acc[j][d] = fmaf(pv, vd[d], acc[j][d]);
        }
      }
    }
    __syncthreads();                       // buffers free for the next loads
  }
  rt::cp_async_wait<0>();
#pragma unroll
  for (int j = 0; j < RPT; ++j) {
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) l[j] += __shfl_xor_sync(0xffffffffu, l[j], off);
    const int row = ry + RY * j;
    if (row >= nrows) continue;
    const float inv = l[j] > 0.f ? 1.f / l[j] : 0.f;
    float* out = o + (base + row) * D + kx * DPT;
#pragma unroll
    for (int d = 0; d < DPT; ++d) out[d] = acc[j][d] * inv;
    if (kx == 0)
      lse[base + row] = l[j] > 0.f ? fmaxf(m[j], rt::NEG_HALF) + logf(fmaxf(l[j], 1e-30f))
                                   : rt::LSE_EMPTY;
  }
}

// ---------------------------------------------------------------------------

template <typename T, int D>
int launch_warp(const void* q, const void* kb, const void* vb, const void* idx,
                const void* tok_bias, void* o, void* lse, int B, int Hkv, int G, int M,
                int NB, int ell, int k_star, cudaStream_t stream) {
  const int n_items = B * Hkv * G;
  const int blocks = (n_items + kWarps - 1) / kWarps;
  selection_fwd_warp<T, D><<<blocks, 32 * kWarps, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kb), static_cast<const T*>(vb),
      static_cast<const int*>(idx), static_cast<const float*>(tok_bias),
      static_cast<T*>(o), static_cast<float*>(lse), Hkv, G, M, NB, ell, k_star,
      n_items, (float)(1.0 / sqrt((double)D)));
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_tiles(const void* q, const void* kb, const void* vb, const void* idx,
                 const void* tok_bias, void* o, void* lse, int B, int Hkv, int G, int M,
                 int NB, int ell, int k_star, cudaStream_t stream) {
  const float scale = (float)(1.0 / sqrt((double)D));
  const size_t list_bytes = (size_t)(k_star + 1) * sizeof(int);
  if constexpr (sizeof(T) == 2) {
    using C = FwdMma<D>;
    auto kern = selection_fwd_mma<D>;
    const size_t smem = C::SMEM + list_bytes;
    if (int err = set_smem(kern, smem)) return err;
    const dim3 grid(B * Hkv * G, (M + C::BM - 1) / C::BM);
    kern<<<grid, C::NT, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(kb), static_cast<const bf16*>(vb),
        static_cast<const int*>(idx), static_cast<const float*>(tok_bias),
        static_cast<bf16*>(o), static_cast<float*>(lse), Hkv, G, M, NB, ell, k_star, scale);
  } else {
    using C = FwdFma<D>;
    auto kern = selection_fwd_fma<D>;
    const size_t smem = C::SMEM + list_bytes;
    if (int err = set_smem(kern, smem)) return err;
    const dim3 grid(B * Hkv * G, (M + C::BM - 1) / C::BM);
    kern<<<grid, C::NT, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(kb),
        static_cast<const float*>(vb), static_cast<const int*>(idx),
        static_cast<const float*>(tok_bias), static_cast<float*>(o),
        static_cast<float*>(lse), Hkv, G, M, NB, ell, k_star, scale);
  }
  return (int)cudaGetLastError();
}

template <int D>
int launch_groups(const void* q, const void* kb, const void* vb, const void* idx,
                  const void* tok_bias, void* o, void* lse, int B, int Hkv, int G, int M,
                  int NB, int ell, int k_star, cudaStream_t stream) {
  if constexpr (D > 64) {                 // built for D 16, 32, 64 only
    return (int)cudaErrorInvalidValue;
  } else {
    using C = FwdGroups<D>;
    if (M >= 16 || k_star * ell > C::KEYS) return (int)cudaErrorInvalidValue;
    const int n_items = B * Hkv * G;
    auto kern = selection_fwd_groups<D>;
    if (int err = set_smem(kern, C::SMEM)) return err;
    kern<<<(n_items + C::GT - 1) / C::GT, 32 * C::GT, C::SMEM, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(kb),
        static_cast<const float*>(vb), static_cast<const int*>(idx),
        static_cast<const float*>(tok_bias), static_cast<float*>(o),
        static_cast<float*>(lse), Hkv, G, M, NB, ell, k_star, n_items,
        (float)(1.0 / sqrt((double)D)));
    return (int)cudaGetLastError();
  }
}

}  // namespace

// path: 0 = warp, 1 = tiles, 2 = groups (fp32, D <= 64 only), as
// kernels/selection.py::selection_plan names them
extern "C" int selection_fwd(const void* q, const void* kb, const void* vb,
                             const void* idx, const void* tok_bias, void* o,
                             void* lse, int B, int Hkv, int G, int M, int NB,
                             int ell, int k_star, int D, int bf16, int path,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B * Hkv * G == 0 || M == 0) return 0;
  RT_DISPATCH_D128(D, {
    if (path == 2)                        // fp32 only
      return bf16 ? (int)cudaErrorInvalidValue
                  : launch_groups<kD>(q, kb, vb, idx, tok_bias, o, lse, B, Hkv, G, M, NB,
                                      ell, k_star, s);
    if (path == 1)
      return bf16 ? launch_tiles<__nv_bfloat16, kD>(q, kb, vb, idx, tok_bias, o, lse, B,
                                                    Hkv, G, M, NB, ell, k_star, s)
                  : launch_tiles<float, kD>(q, kb, vb, idx, tok_bias, o, lse, B, Hkv, G,
                                            M, NB, ell, k_star, s);
    return bf16 ? launch_warp<__nv_bfloat16, kD>(q, kb, vb, idx, tok_bias, o, lse, B,
                                                 Hkv, G, M, NB, ell, k_star, s)
                : launch_warp<float, kD>(q, kb, vb, idx, tok_bias, o, lse, B, Hkv, G, M,
                                         NB, ell, k_star, s);
  });
  return 0;
}
