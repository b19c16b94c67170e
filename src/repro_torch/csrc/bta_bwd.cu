// Ball-Tree Attention backward: dQ, dK, dV of full softmax attention inside
// each contiguous ball of m keys, recomputed from the forward's lse.
//
// Replaces repro/kernels/bta.py::_bwd_kernel (Pallas, TPU).
//
// Layout (GQA-native): q, dO (B*Hkv, rep, N, D), k/v (B*Hkv, N, D), key_bias
// (B, N) fp32, live (B, N/m) int32, lse and delta = rowsum(dO*O) (B*Hkv, rep,
// N) fp32 -> dq like q, dk/dv like k.
//
// Bound on the H100: the five products (S = QK^T, dP = dO V^T, dV += P^T dO,
// dK += dS^T Q, dQ = dS K) are 10*m*D FLOP per query row against a few
// D-wide rows of bytes, so the products bound it: on the bf16 tensor cores in
// bf16 (seamless's encoder: m = 256, D = 64), on the fp32 FMA pipes at the
// paper's shapes (m = 256, D = 32, fp32).
//
// Design.  The ball is the tile, so a ball's gradients depend on that ball
// alone: no block touches another ball's dQ, dK, dV (no atomics, no staging
// buffer, a fixed order of sums, so two calls give equal bits).  Three
// paths, one rule (kernels/bta.py::bta_plan):
//   mma   bf16, m a multiple of 64, D 16-128: one launch, two block roles
//         side by side in one grid (blockIdx.x < m/64: dK/dV, the rest: dQ;
//         (m/64 + rep*m/64, N/m, B*Hkv) blocks of 4 warps), tiles staged in
//         bf16 by cp.async and double-buffered, every product on mma.sync
//         m16n8k16 with fp32 accumulation, exponentials on the MUFU unit:
//     dK/dV  a block owns 64 of the ball's keys (K, V staged once) and walks
//            the ball's rep*m query rows in tiles of RT (64; 32 at D 128),
//            Q, dO, lse, delta staged; a warp owns 16 keys and, per 32 rows,
//            computes S^T and dP^T, turns them into P^T and dS^T fragments
//            and adds P^T dO and dS^T Q into its dV, dK (16 keys x D, fp32),
//            so the GQA group's sum over its rep heads stays in registers.
//     dQ     a block owns 64 rows of one query head (Q, dO staged once) and
//            walks the ball's m/64 key tiles; a warp owns 16 rows: S, dP,
//            dS and dQ += dS K.
//         S and dP are computed in both roles (seven products a pair, not
//         five): the price of owning every output in one block.  A tile of
//         rows whose lse are all LSE_EMPTY is skipped, and so is a dK/dV
//         block whose 64 keys are all masked.
//   fma   fp32, m a multiple of 64 up to 256, D 16 or 32 (shapenet): one
//         block a ball produces all three in a single pass, as the TPU
//         kernel does: the
//         ball's K, V and bias are staged once (cp.async; 72 KB at m 256, D
//         32), the ball's dK and dV stay in registers for the whole block (256
//         threads, a thread holding 8 keys x D/8 dims of each: 64 floats at
//         D 32), and the block walks the ball's rep*m query rows in tiles of
//         32, Q, dO, lse and delta double-buffered by cp.async.  Per tile,
//         register micro-tiles on the FMA pipes:
//           A  S^T and dP^T (a thread: 4 keys x 8 rows, 24 float4 loads a
//              step of four dims feed 256 FMAs), P = exp(s - lse) and
//              dS = P (dP - delta) scale, both to shared memory (keys x rows);
//           B  dV += P^T dO and dK += dS^T Q into the registers;
//           C  dQ = dS K of the tile's rows: each 64-key chunk's part in
//              registers (4 rows x D/8 dims a thread), the chunks summed in a
//              fixed order through shared memory and stored.
//         Five products per (row, key), none recomputed.  The shared memory
//         (184 KB at D 32) holds one block an SM.  (512 threads, 128
//         registers each, spilled at D 32 and were no faster.)
//   rows  fp32 at D 64 and balls that are no multiple of 64: one block a
//         ball; one thread per query row runs the ball's keys for dQ (K, V
//         staged as fp32), then one thread per key runs the query rows,
//         staged one rep head at a time, for dK and dV (s and dO.v computed
//         in both passes).
// p and dS are rounded to the operand dtype before their products (bf16 in,
// bf16 operands, fp32 sums).  Masked keys and rows with lse = LSE_EMPTY give
// p = 0; a dead ball (live = 0) writes exact zeros without reading K or V.
#include "mma_bwd.cuh"

namespace {

using rt::dot4;
using rt::lane_of;
using rt::load_vec;
using rt::set_smem;
using rt::stage_rows;
using rt::stage_vals;

template <typename T>
__device__ __forceinline__ void zero_ball(T* dq, T* dk, T* dv, int bh, int ball, int rep,
                                          int N, int m, int D) {
  for (int r = 0; r < rep; ++r)
    rt::store_zeros(dq + (((size_t)bh * rep + r) * N + (size_t)ball * m) * D, m * D);
  const size_t kv0 = ((size_t)bh * N + (size_t)ball * m) * D;
  rt::store_zeros(dk + kv0, m * D);
  rt::store_zeros(dv + kv0, m * D);
}

// ---------------------------------------------------------------------------
// rows: two passes, one query row then one key per thread.
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(256)
bta_bwd_rows(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const float* __restrict__ key_bias,
             const int* __restrict__ live, const T* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv, int rep,
             int N, int m, int n_heads, float scale) {
  extern __shared__ float4 smem4[];
  float* A = reinterpret_cast<float*>(smem4);   // pass 1: K      pass 2: Q
  float* Bm = A + m * D;                        // pass 1: V      pass 2: dO
  float* c1 = Bm + m * D;                       // pass 1: bias   pass 2: lse
  float* c2 = c1 + m;                           //                pass 2: delta

  const int bh = blockIdx.y;
  const int ball = blockIdx.x;
  const int b = bh / n_heads;
  const int rows = rep * m;
  const size_t kv0 = ((size_t)bh * N + (size_t)ball * m) * D;

  if (live[b * (N / m) + ball] == 0) {          // all keys masked: p == 0
    zero_ball(dq, dk, dv, bh, ball, rep, N, m, D);
    return;
  }

  // ---- pass 1: dQ, one query row per thread
  rt::stage(k + kv0, A, m * D);
  rt::stage(v + kv0, Bm, m * D);
  rt::stage(key_bias + (size_t)b * N + (size_t)ball * m, c1, m);
  __syncthreads();
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    const size_t qrow = ((size_t)bh * rep + r / m) * N + (size_t)ball * m + r % m;
    float qr[D], dor[D], acc[D];
    rt::load_row<T, D>(q + qrow * D, qr);
    rt::load_row<T, D>(dout + qrow * D, dor);
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] = 0.f;
    const float l = lse[qrow], dl = delta[qrow];
    if (l < rt::LSE_HALF) {
      for (int j = 0; j < m; ++j) {
        const float p = rt::p_from_lse(rt::dot_row<D>(qr, A + j * D) * scale + c1[j], l);
        if (p == 0.f) continue;
        const float ds = p * (rt::dot_row<D>(dor, Bm + j * D) - dl) * scale;
        rt::axpy_row<D>(acc, rt::pv_operand<T>(ds), A + j * D);
      }
    }
    rt::store_row<T, D>(acc, dq + qrow * D);
  }

  // ---- pass 2: dK, dV, one key per thread, query rows staged per rep head
  for (int j0 = 0; j0 < m; j0 += blockDim.x) {
    const int j = j0 + threadIdx.x;
    const bool has_key = j < m;
    float kr[D], vr[D], dka[D], dva[D];
    float bj = 0.f;
    if (has_key) {
      rt::load_row<T, D>(k + kv0 + (size_t)j * D, kr);
      rt::load_row<T, D>(v + kv0 + (size_t)j * D, vr);
      bj = key_bias[(size_t)b * N + (size_t)ball * m + j];
    }
#pragma unroll
    for (int d = 0; d < D; ++d) dka[d] = dva[d] = 0.f;
    for (int r = 0; r < rep; ++r) {
      const size_t row0 = ((size_t)bh * rep + r) * N + (size_t)ball * m;
      __syncthreads();                        // previous contents consumed
      rt::stage(q + row0 * D, A, m * D);
      rt::stage(dout + row0 * D, Bm, m * D);
      rt::stage(lse + row0, c1, m);
      rt::stage(delta + row0, c2, m);
      __syncthreads();
      if (!has_key || bj <= rt::NEG_HALF) continue;
      for (int i = 0; i < m; ++i) {
        const float l = c1[i];
        if (l >= rt::LSE_HALF) continue;      // empty row: p == 0
        const float p = rt::p_from_lse(rt::dot_row<D>(kr, A + i * D) * scale + bj, l);
        if (p == 0.f) continue;
        rt::axpy_row<D>(dva, rt::pv_operand<T>(p), Bm + i * D);
        const float ds = p * (rt::dot_row<D>(vr, Bm + i * D) - c2[i]) * scale;
        rt::axpy_row<D>(dka, rt::pv_operand<T>(ds), A + i * D);
      }
    }
    if (has_key) {
      rt::store_row<T, D>(dka, dk + kv0 + (size_t)j * D);
      rt::store_row<T, D>(dva, dv + kv0 + (size_t)j * D);
    }
  }
}

// ---------------------------------------------------------------------------
// fma, fp32: one block a ball, register tiles on the FMA pipes.  NT threads,
// W = NT/32 warps; MMAX keys at most (the registers hold MMAX*D*2/NT floats
// of dK, dV a thread).  Shared memory (floats): K, V (MMAX rows of stride
// LD), bias, Q and dO [2][BM rows], lse and delta [2][BM], P^T and dS^T
// (MMAX keys x BM rows, stride LP), the dQ parts [NC chunks][BM][D].
//   A  warp (wk, wr) = (w % 8, w / 8): keys 32wk + kx + 8i (i < 4), rows
//      16... : lane (kx, ry) = (lane % 8, lane / 8), rows BM/WR*wr + ry + 4j
//      (j < RJ); a warp reads 8 keys and 4 rows a load (no bank conflicts).
//   B  warp w: keys KB*w + kq + 4i (i < KI), lane (kq, dy) = (lane % 4,
//      lane / 4), dims dy*DPT..
//   C  warp w: key chunk w / (BM/16) of CK keys, lane (dg, rg): dims dg*DPT,
//      rows 4rg..4rg+3 of the tile.
// ---------------------------------------------------------------------------
template <int D>
struct BwdFma {
  static constexpr int MMAX = 256, BM = 32, NT = 256;
  static constexpr int W = NT / 32, WR = W / 8, RJ = BM / (4 * WR), KB = MMAX / W;
  static constexpr int KI = KB / 4, DPT = D / 8, NC = W / (BM / 16), CK = MMAX / NC;
  static constexpr int LD = D + 4, LP = BM + 4;
  static constexpr int K_OFF = 0, V_OFF = MMAX * LD, B_OFF = 2 * MMAX * LD;
  static constexpr int Q_OFF = B_OFF + MMAX, DO_OFF = Q_OFF + 2 * BM * LD;
  static constexpr int L_OFF = DO_OFF + 2 * BM * LD, DL_OFF = L_OFF + 2 * BM;
  static constexpr int P_OFF = DL_OFF + 2 * BM, S_OFF = P_OFF + MMAX * LP;
  static constexpr int DQ_OFF = S_OFF + MMAX * LP;
  static constexpr size_t SMEM = (size_t)(DQ_OFF + NC * BM * D) * 4;
};

template <int D>
__global__ void __launch_bounds__(BwdFma<D>::NT, 1)
bta_bwd_fma(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ key_bias,
            const int* __restrict__ live, const float* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv, int rep,
            int N, int m, int n_heads, float scale) {
  using C = BwdFma<D>;
  constexpr int BM = C::BM, NT = C::NT, LD = C::LD, LP = C::LP, DPT = C::DPT;
  constexpr int RJ = C::RJ, KI = C::KI, CK = C::CK;
  float* sm = reinterpret_cast<float*>(rt::dyn_smem());
  const float* Ks = sm + C::K_OFF;
  const float* Vs = sm + C::V_OFF;
  const float* bs = sm + C::B_OFF;
  float* Ps = sm + C::P_OFF;
  float* Ss = sm + C::S_OFF;
  float* parts = sm + C::DQ_OFF;

  const int bh = blockIdx.y, ball = blockIdx.x;
  const int b = bh / n_heads;
  if (live[b * (N / m) + ball] == 0) {          // all keys masked: p == 0
    zero_ball(dq, dk, dv, bh, ball, rep, N, m, D);
    return;
  }
  const size_t kv0 = ((size_t)bh * N + (size_t)ball * m) * D;
  stage_rows<float, D, LD>(sm + C::K_OFF, k + kv0, m, m, NT);
  stage_rows<float, D, LD>(sm + C::V_OFF, v + kv0, m, m, NT);
  stage_vals(sm + C::B_OFF, key_bias + (size_t)b * N + (size_t)ball * m, m, m, rt::NEG_INF,
             NT);
  // tile it: rows [it*BM, it*BM + BM) of the ball's rep*m, in one query head
  auto first_row = [&](int it) {
    const int row0 = it * BM;
    return ((size_t)bh * rep + row0 / m) * N + (size_t)ball * m + row0 % m;
  };
  auto load_tile = [&](int it, int buf) {
    const size_t g0 = first_row(it);
    stage_rows<float, D, LD>(sm + C::Q_OFF + buf * BM * LD, q + g0 * D, BM, BM, NT);
    stage_rows<float, D, LD>(sm + C::DO_OFF + buf * BM * LD, dout + g0 * D, BM, BM, NT);
    stage_vals(sm + C::L_OFF + buf * BM, lse + g0, BM, BM, rt::LSE_EMPTY, NT);
    stage_vals(sm + C::DL_OFF + buf * BM, delta + g0, BM, BM, 0.f, NT);
  };

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  // A
  const int ka = (warp % 8) * 32 + lane % 8, ra = (warp / 8) * (BM / C::WR) + lane / 8;
  // B
  const int kb0 = warp * C::KB + lane % 4, db = (lane / 4) * DPT;
  // C
  const int chunk = warp / (BM / 16), dc = (lane % 8) * DPT;
  const int rc = ((warp % (BM / 16)) * 4 + lane / 8) * 4;
  const int n_chunks = m / CK;

  float dka[KI][DPT], dva[KI][DPT];
#pragma unroll
  for (int i = 0; i < KI; ++i)
#pragma unroll
    for (int d = 0; d < DPT; ++d) dka[i][d] = dva[i][d] = 0.f;

  const int n_tiles = rep * m / BM;
  load_tile(0, 0);                              // joins K, V and bias's group
  rt::cp_async_commit();
  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_tiles) load_tile(it + 1, buf ^ 1);
    rt::cp_async_commit();
    rt::cp_async_wait<1>();
    __syncthreads();
    const float* Qt = sm + C::Q_OFF + buf * BM * LD;
    const float* Dt = sm + C::DO_OFF + buf * BM * LD;
    const float* lt = sm + C::L_OFF + buf * BM;
    const float* dlt = sm + C::DL_OFF + buf * BM;

    // ---- A: S^T, dP^T (4 keys x RJ rows), then P and dS to shared memory
    if (ka - lane % 8 < m) {                    // warp-uniform: the warp's keys exist
      float st[4][RJ], dp[4][RJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < RJ; ++j) st[i][j] = dp[i][j] = 0.f;
#pragma unroll 1
      for (int d = 0; d < D; d += 4) {
        float4 kk[4], vv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          kk[i] = *reinterpret_cast<const float4*>(Ks + (ka + 8 * i) * LD + d);
          vv[i] = *reinterpret_cast<const float4*>(Vs + (ka + 8 * i) * LD + d);
        }
#pragma unroll
        for (int j = 0; j < RJ; ++j) {
          const float4 qq = *reinterpret_cast<const float4*>(Qt + (ra + 4 * j) * LD + d);
          const float4 oo = *reinterpret_cast<const float4*>(Dt + (ra + 4 * j) * LD + d);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            st[i][j] = dot4(kk[i], qq, st[i][j]);
            dp[i][j] = dot4(vv[i], oo, dp[i][j]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < RJ; ++j) {
        const int row = ra + 4 * j;
        const float l = lt[row], dl = dlt[row];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = ka + 8 * i;
          const float p = rt::p_from_lse(st[i][j] * scale + bs[key], l);
          Ps[key * LP + row] = p;
          Ss[key * LP + row] = p * (dp[i][j] - dl) * scale;
        }
      }
    }
    __syncthreads();

    // ---- B: dV += P^T dO, dK += dS^T Q (KI keys x DPT dims)
    if (kb0 - lane % 4 < m) {                   // warp-uniform
#pragma unroll 1
      for (int r = 0; r < BM; r += 4) {
        float4 pp[KI], ss[KI];
#pragma unroll
        for (int i = 0; i < KI; ++i) {
          pp[i] = *reinterpret_cast<const float4*>(Ps + (kb0 + 4 * i) * LP + r);
          ss[i] = *reinterpret_cast<const float4*>(Ss + (kb0 + 4 * i) * LP + r);
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float od[DPT], qd[DPT];
          load_vec<DPT>(od, Dt + (r + c) * LD + db);
          load_vec<DPT>(qd, Qt + (r + c) * LD + db);
#pragma unroll
          for (int i = 0; i < KI; ++i) {
            const float pv = lane_of(pp[i], c), sv = lane_of(ss[i], c);
#pragma unroll
            for (int d = 0; d < DPT; ++d) {
              dva[i][d] = fmaf(pv, od[d], dva[i][d]);
              dka[i][d] = fmaf(sv, qd[d], dka[i][d]);
            }
          }
        }
      }
    }

    // ---- C: this chunk's part of dQ = dS K (4 rows x DPT dims), then the
    // chunks summed in order
    if (chunk < n_chunks) {                     // warp-uniform
      float acc[4][DPT];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int d = 0; d < DPT; ++d) acc[r][d] = 0.f;
#pragma unroll 4
      for (int key = chunk * CK; key < chunk * CK + CK; ++key) {
        const float4 sd = *reinterpret_cast<const float4*>(Ss + key * LP + rc);
        float kd[DPT];
        load_vec<DPT>(kd, Ks + key * LD + dc);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float sv = lane_of(sd, r);
#pragma unroll
          for (int d = 0; d < DPT; ++d) acc[r][d] = fmaf(sv, kd[d], acc[r][d]);
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float* dst = parts + (chunk * BM + rc + r) * D + dc;
#pragma unroll
        for (int d = 0; d < DPT; ++d) dst[d] = acc[r][d];
      }
    }
    __syncthreads();
    const size_t g0 = first_row(it);
    for (int e = threadIdx.x; e < BM * D; e += NT) {
      float sum = parts[e];
      for (int c = 1; c < n_chunks; ++c) sum += parts[c * BM * D + e];
      dq[g0 * D + e] = sum;
    }
  }
  rt::cp_async_wait<0>();

  if (kb0 - lane % 4 < m) {
#pragma unroll
    for (int i = 0; i < KI; ++i) {
      const size_t off = kv0 + (size_t)(kb0 + 4 * i) * D + db;
#pragma unroll
      for (int d = 0; d < DPT; ++d) {
        dk[off + d] = dka[i][d];
        dv[off + d] = dva[i][d];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// mma, bf16: tensor cores, two block roles in one grid, each on the tile
// step it shares with local_bwd.cu (mma_bwd.cuh).  Shared memory (bf16
// elements, row stride LD; then fp32):
//   dK/dV  K, V [BK rows], Q, dO [2][RT rows] | lse, delta [2][RT], bias [BK]
//   dQ     Q, dO [BM rows], K, V [2][BK rows] | bias [2][BK]
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;
using rt::store2;

template <int D>
struct BwdMma {
  static constexpr int BM = 64, BK = 64, RT = D > 64 ? 32 : 64, NT = 128;
  static constexpr int LD = D + 8;   // bf16 row stride: ldmatrix rows on distinct banks
  static constexpr int KV_Q_OFF = 2 * BK * LD, KV_DO_OFF = KV_Q_OFF + 2 * RT * LD;
  static constexpr int KV_END = KV_DO_OFF + 2 * RT * LD;
  static constexpr int DQ_K_OFF = 2 * BM * LD, DQ_V_OFF = DQ_K_OFF + 2 * BK * LD;
  static constexpr int DQ_END = DQ_V_OFF + 2 * BK * LD;
  static constexpr size_t KV_SMEM = (size_t)KV_END * 2 + (size_t)(4 * RT + BK) * 4;
  static constexpr size_t DQ_SMEM = (size_t)DQ_END * 2 + (size_t)2 * BK * 4;
  static constexpr size_t SMEM = KV_SMEM > DQ_SMEM ? KV_SMEM : DQ_SMEM;
};

// dK, dV of keys [kt*BK, kt*BK + BK) of ball `ball` of bh, over the ball's
// rep*m query rows.
template <int D>
__device__ __forceinline__ void bta_dkv_block(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const float* __restrict__ key_bias, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta, bf16* __restrict__ dk,
    bf16* __restrict__ dv, int bh, int ball, int kt, int rep, int N, int m, int n_heads,
    float scale) {
  using C = BwdMma<D>;
  constexpr int RT = C::RT, BK = C::BK, LD = C::LD;
  bf16* sm = reinterpret_cast<bf16*>(rt::dyn_smem());
  const bf16* Ks = sm;
  const bf16* Vs = sm + BK * LD;
  float* ls = reinterpret_cast<float*>(sm + C::KV_END);    // [2][RT]
  float* dls = ls + 2 * RT;                                 // [2][RT]
  float* bs = dls + 2 * RT;                                 // [BK]

  const int lane = threadIdx.x % 32, g = lane / 4, tig = lane % 4;
  const int kw = (threadIdx.x / 32) * 16;                   // the warp's first key
  const int b = bh / n_heads;
  const int j0 = ball * m + kt * BK;                        // the block's first key
  const size_t kv0 = ((size_t)bh * N + j0) * D;

  stage_rows<bf16, D, LD>(sm, k + kv0, BK, BK, C::NT);
  stage_rows<bf16, D, LD>(sm + BK * LD, v + kv0, BK, BK, C::NT);
  bool key_live = false;
  if (threadIdx.x < BK) {
    bs[threadIdx.x] = key_bias[(size_t)b * N + j0 + threadIdx.x];
    key_live = bs[threadIdx.x] > rt::NEG_HALF;
  }
  // tile it: rows (it % per_head)*RT.. of query head it / per_head
  const int per_head = m / RT;
  const int n_tiles = __syncthreads_or(key_live) ? rep * per_head : 0;
  auto load_tile = [&](int it, int buf) {
    const size_t row0 =
        ((size_t)bh * rep + it / per_head) * N + (size_t)ball * m + (it % per_head) * RT;
    stage_rows<bf16, D, LD>(sm + C::KV_Q_OFF + buf * RT * LD, q + row0 * D, RT, RT, C::NT);
    stage_rows<bf16, D, LD>(sm + C::KV_DO_OFF + buf * RT * LD, dout + row0 * D, RT, RT,
                            C::NT);
    stage_vals(ls + buf * RT, lse + row0, RT, RT, rt::LSE_EMPTY, C::NT);
    stage_vals(dls + buf * RT, delta + row0, RT, RT, 0.f, C::NT);
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
    const float* lt = ls + buf * RT;
    const float* dlt = dls + buf * RT;
    const bool row_live = threadIdx.x < RT && lt[threadIdx.x] < rt::LSE_HALF;
    if (__syncthreads_or(row_live))              // the tile has a row that sees a key
      rt::mma_dkv_tile<D, RT, LD>(Ks, Vs, bs, sm + C::KV_Q_OFF + buf * RT * LD,
                                  sm + C::KV_DO_OFF + buf * RT * LD, lt, dlt, kw, scale,
                                  [](int, int) { return true; }, dka, dva);
    __syncthreads();                       // buffer `buf` is free for tile it+2
  }
  rt::cp_async_wait<0>();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const size_t off = kv0 + (size_t)(kw + g + 8 * h) * D + tig * 2;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      store2<bf16>(dk + off + nt * 8, dka[nt][2 * h], dka[nt][2 * h + 1]);
      store2<bf16>(dv + off + nt * 8, dva[nt][2 * h], dva[nt][2 * h + 1]);
    }
  }
}

// dQ of rows [qt*BM, qt*BM + BM) of ball `ball`'s rep*m rows of bh (one
// query head's, since BM divides m), over the ball's m keys.
template <int D>
__device__ __forceinline__ void bta_dq_block(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const float* __restrict__ key_bias, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta, bf16* __restrict__ dq,
    int bh, int ball, int qt, int rep, int N, int m, int n_heads, float scale) {
  using C = BwdMma<D>;
  constexpr int BM = C::BM, BK = C::BK, LD = C::LD;
  bf16* sm = reinterpret_cast<bf16*>(rt::dyn_smem());
  const bf16* Qs = sm;
  const bf16* Ds = sm + BM * LD;
  float* bs = reinterpret_cast<float*>(sm + C::DQ_END);    // [2][BK]

  const int lane = threadIdx.x % 32, g = lane / 4, tig = lane % 4;
  const int rw = (threadIdx.x / 32) * 16;                   // the warp's first row
  const int b = bh / n_heads;
  const int row0 = qt * BM;
  const size_t base = ((size_t)bh * rep + row0 / m) * N + (size_t)ball * m + row0 % m;
  const bool row_live = threadIdx.x < BM && lse[base + threadIdx.x] < rt::LSE_HALF;
  if (!__syncthreads_or(row_live)) {                        // dq == 0
    rt::store_zeros(dq + base * D, BM * D);
    return;
  }
  stage_rows<bf16, D, LD>(sm, q + base * D, BM, BM, C::NT);
  stage_rows<bf16, D, LD>(sm + BM * LD, dout + base * D, BM, BM, C::NT);
  const bf16* kb = k + ((size_t)bh * N + (size_t)ball * m) * D;
  const bf16* vb = v + ((size_t)bh * N + (size_t)ball * m) * D;
  const float* biasb = key_bias + (size_t)b * N + (size_t)ball * m;
  auto load_tile = [&](int kt, int buf) {
    const int j0 = kt * BK;
    stage_rows<bf16, D, LD>(sm + C::DQ_K_OFF + buf * BK * LD, kb + (size_t)j0 * D, BK, BK,
                            C::NT);
    stage_rows<bf16, D, LD>(sm + C::DQ_V_OFF + buf * BK * LD, vb + (size_t)j0 * D, BK, BK,
                            C::NT);
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

  const int n_kt = m / BK;
  load_tile(0, 0);
  rt::cp_async_commit();
  for (int kt = 0; kt < n_kt; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < n_kt) load_tile(kt + 1, buf ^ 1);
    rt::cp_async_commit();
    rt::cp_async_wait<1>();
    __syncthreads();
    rt::mma_dq_tile<D, BK, LD>(Qs, Ds, sm + C::DQ_K_OFF + buf * BK * LD,
                               sm + C::DQ_V_OFF + buf * BK * LD, bs + buf * BK, rw, l, dl, scale,
                               [](int, int) { return true; }, dqa);
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

// blockIdx = (role tile, ball, bh): x < m/BK a dK/dV block of key tile x,
// else a dQ block of row tile x - m/BK.
template <int D>
__global__ void __launch_bounds__(BwdMma<D>::NT, 1)
bta_bwd_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
            const bf16* __restrict__ v, const float* __restrict__ key_bias,
            const int* __restrict__ live, const bf16* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            bf16* __restrict__ dq, bf16* __restrict__ dk, bf16* __restrict__ dv, int rep,
            int N, int m, int n_heads, float scale) {
  using C = BwdMma<D>;
  const int bh = blockIdx.z, ball = blockIdx.y;
  const int n_kt = m / C::BK;
  const bool dkv = (int)blockIdx.x < n_kt;
  if (live[bh / n_heads * (N / m) + ball] == 0) {          // all keys masked: p == 0
    if (dkv) {
      const size_t kv0 = ((size_t)bh * N + (size_t)ball * m + blockIdx.x * C::BK) * D;
      rt::store_zeros(dk + kv0, C::BK * D);
      rt::store_zeros(dv + kv0, C::BK * D);
    } else {
      const int row0 = (blockIdx.x - n_kt) * C::BM;
      rt::store_zeros(dq + (((size_t)bh * rep + row0 / m) * N + (size_t)ball * m + row0 % m) * D,
                      C::BM * D);
    }
    return;
  }
  if (dkv)
    bta_dkv_block<D>(q, k, v, key_bias, dout, lse, delta, dk, dv, bh, ball, blockIdx.x, rep, N,
                     m, n_heads, scale);
  else
    bta_dq_block<D>(q, k, v, key_bias, dout, lse, delta, dq, bh, ball, blockIdx.x - n_kt, rep,
                    N, m, n_heads, scale);
}

// ---------------------------------------------------------------------------

template <typename T, int D>
int launch_rows(const void* q, const void* k, const void* v, const void* key_bias,
                const void* live, const void* dout, const void* lse, const void* delta,
                void* dq, void* dk, void* dv, int BH, int rep, int N, int m, int n_heads,
                float scale, cudaStream_t stream) {
  const int rows = rep * m;
  const int threads = rows < 256 ? ((rows + 31) / 32) * 32 : 256;
  const dim3 grid(N / m, BH);
  const size_t smem = (size_t)(2 * m * D + 2 * m) * sizeof(float);
  auto kern = bta_bwd_rows<T, D>;
  if (int err = set_smem(kern, smem)) return err;
  kern<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(key_bias), static_cast<const int*>(live),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dq), static_cast<T*>(dk),
      static_cast<T*>(dv), rep, N, m, n_heads, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_fma(const void* q, const void* k, const void* v, const void* key_bias,
               const void* live, const void* dout, const void* lse, const void* delta,
               void* dq, void* dk, void* dv, int BH, int rep, int N, int m, int n_heads,
               float scale, cudaStream_t stream) {
  using C = BwdFma<D>;
  if (m % 64 != 0 || m > C::MMAX) return (int)cudaErrorInvalidValue;
  auto kern = bta_bwd_fma<D>;
  if (int err = set_smem(kern, C::SMEM)) return err;
  kern<<<dim3(N / m, BH), C::NT, C::SMEM, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(key_bias),
      static_cast<const int*>(live), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), static_cast<float*>(dk), static_cast<float*>(dv), rep, N, m,
      n_heads, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, const void* key_bias,
               const void* live, const void* dout, const void* lse, const void* delta,
               void* dq, void* dk, void* dv, int BH, int rep, int N, int m, int n_heads,
               float scale, cudaStream_t stream) {
  using C = BwdMma<D>;
  if (m % C::BK != 0) return (int)cudaErrorInvalidValue;
  auto kern = bta_bwd_mma<D>;
  if (int err = set_smem(kern, C::SMEM)) return err;
  const dim3 grid(m / C::BK + rep * m / C::BM, N / m, BH);
  kern<<<grid, C::NT, C::SMEM, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(key_bias), static_cast<const int*>(live),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), rep, N, m, n_heads, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// path: kernels/bta.py::bta_plan's (PATH_CODES: 0 rows, 1 fma: fp32 at D 16 or
// 32, 2 mma: bf16, m a multiple of 64)
extern "C" int bta_bwd(const void* q, const void* k, const void* v,
                       const void* key_bias, const void* live, const void* dout,
                       const void* lse, const void* delta, void* dq, void* dk,
                       void* dv, int BH, int rep, int N, int D, int m, int n_heads,
                       int bf16, int path, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N % m != 0) return (int)cudaErrorInvalidValue;
  if (BH == 0 || rep == 0 || N == 0) return 0;
  const float scale = (float)(1.0 / sqrt((double)D));
  if (path == 2) {
    if (!bf16) return (int)cudaErrorInvalidValue;
    RT_DISPATCH_D128(D, {
      return launch_mma<kD>(q, k, v, key_bias, live, dout, lse, delta, dq, dk, dv, BH, rep, N,
                            m, n_heads, scale, s);
    });
  }
  if (path == 1) {
    if (bf16) return (int)cudaErrorInvalidValue;
    switch (D) {
      case 16: return launch_fma<16>(q, k, v, key_bias, live, dout, lse, delta, dq, dk, dv,
                                     BH, rep, N, m, n_heads, scale, s);
      case 32: return launch_fma<32>(q, k, v, key_bias, live, dout, lse, delta, dq, dk, dv,
                                     BH, rep, N, m, n_heads, scale, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (path != 0) return (int)cudaErrorInvalidValue;
  RT_DISPATCH_D(D, {
    return bf16 ? launch_rows<__nv_bfloat16, kD>(q, k, v, key_bias, live, dout, lse, delta,
                                                 dq, dk, dv, BH, rep, N, m, n_heads, scale, s)
                : launch_rows<float, kD>(q, k, v, key_bias, live, dout, lse, delta, dq, dk,
                                         dv, BH, rep, N, m, n_heads, scale, s);
  });
  return 0;
}
