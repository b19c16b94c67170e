// The backward tile steps of the bf16 tensor-core attention kernels whose
// blocks own 64 rows (dQ) or 64 keys (dK/dV) and walk staged tiles of the
// other side: local_dq_mma / local_dkv_mma (local_bwd.cu) and bta_bwd_mma's
// two block roles (bta_bwd.cu).  A block has 4 warps; every product runs on
// mma.sync m16n8k16 with bf16 operands and fp32 accumulation (fragment
// layouts in mma.cuh), p is recomputed from the row's lse on the MUFU unit
// (__expf), and p and dS are rounded to bf16 as the next product's A
// fragment.  visible(key, row) says whether a key of the block or tile sees
// a row of the tile or block (an index mask; the key bias masks besides): a
// pair it hides, like a masked key or a row with lse = LSE_EMPTY, gives
// p = 0 and adds exactly 0.
#pragma once

#include "tiles.cuh"

namespace rt {

// dQ += dS K of a warp's 16 rows (rw.. of the block's staged Q, dO; row
// stride LD) over one staged tile of BK keys (Kt, Vt; bt: their bias): S
// and dP = dO V^T, dS = p (dP - delta) scale.  l, dl: lse and delta of the
// lane's rows g (h 0) and g + 8 (h 1); dqa: the rows' dQ in the
// accumulator's layout.
template <int D, int BK, int LD, typename Visible>
__device__ __forceinline__ void mma_dq_tile(const __nv_bfloat16* Qs, const __nv_bfloat16* Ds,
                                            const __nv_bfloat16* Kt, const __nv_bfloat16* Vt,
                                            const float* bt, int rw, const float (&l)[2],
                                            const float (&dl)[2], float scale,
                                            Visible visible, float (&dqa)[D / 8][4]) {
  const int lane = threadIdx.x % 32, g = lane / 4, tig = lane % 4;
  float st[BK / 8][4], dp[BK / 8][4];
#pragma unroll
  for (int a = 0; a < BK / 8; ++a)
#pragma unroll
    for (int e = 0; e < 4; ++e) st[a][e] = dp[a][e] = 0.f;
  // S = Q K^T, dP = dO V^T over D
#pragma unroll
  for (int d0 = 0; d0 < D; d0 += 16) {
    uint32_t qa[4], da[4];
    const int aoff = (rw + lane % 16) * LD + d0 + (lane / 16) * 8;
    ldmatrix_x4(qa, Qs + aoff);
    ldmatrix_x4(da, Ds + aoff);
#pragma unroll
    for (int np = 0; np < BK / 16; ++np) {
      const int boff = (np * 16 + lane % 8 + 8 * (lane / 16)) * LD + d0 + 8 * ((lane / 8) % 2);
      uint32_t kf[4], vf[4];
      ldmatrix_x4(kf, Kt + boff);
      ldmatrix_x4(vf, Vt + boff);
      mma_bf16(st[2 * np], qa, kf[0], kf[1]);
      mma_bf16(st[2 * np + 1], qa, kf[2], kf[3]);
      mma_bf16(dp[2 * np], da, vf[0], vf[1]);
      mma_bf16(dp[2 * np + 1], da, vf[2], vf[3]);
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
      if (visible(key, rw + g + 8 * h)) p = p_from_lse_fast(st[nt][e] * scale + bt[key], l[h]);
      dp[nt][e] = p * (dp[nt][e] - dl[h]) * scale;
    }
  }
  uint32_t sa[BK / 16][4];
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    sa[kk][0] = pack_bf16(dp[2 * kk][0], dp[2 * kk][1]);
    sa[kk][1] = pack_bf16(dp[2 * kk][2], dp[2 * kk][3]);
    sa[kk][2] = pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
    sa[kk][3] = pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
  }
  // dQ += dS K over the tile's keys
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
    for (int n0 = 0; n0 < D; n0 += 16) {
      const int boff = (kk * 16 + lane % 8 + 8 * ((lane / 8) % 2)) * LD + n0 + 8 * (lane / 16);
      uint32_t kf[4];
      ldmatrix_x4_trans(kf, Kt + boff);
      mma_bf16(dqa[n0 / 8], sa[kk], kf[0], kf[1]);
      mma_bf16(dqa[n0 / 8 + 1], sa[kk], kf[2], kf[3]);
    }
  }
}

// dV += P^T dO and dK += dS^T Q of a warp's 16 keys (kw.. of the block's
// staged K, V; bs: their bias) over one staged tile of RT rows (Qt, Dt; lt,
// dlt: their lse and delta), in sub-tiles of 32 rows that bound the S^T /
// dP^T registers; dka, dva: the keys' dK, dV in the accumulator's layout.
template <int D, int RT, int LD, typename Visible>
__device__ __forceinline__ void mma_dkv_tile(const __nv_bfloat16* Ks, const __nv_bfloat16* Vs,
                                             const float* bs, const __nv_bfloat16* Qt,
                                             const __nv_bfloat16* Dt, const float* lt,
                                             const float* dlt, int kw, float scale,
                                             Visible visible, float (&dka)[D / 8][4],
                                             float (&dva)[D / 8][4]) {
  const int lane = threadIdx.x % 32, g = lane / 4, tig = lane % 4;
#pragma unroll 1
  for (int r0 = 0; r0 < RT; r0 += 32) {
    float st[4][4], dp[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[a][e] = dp[a][e] = 0.f;
    // S^T = K Q^T, dP^T = V dO^T over D
#pragma unroll
    for (int d0 = 0; d0 < D; d0 += 16) {
      uint32_t ka[4], va[4];
      const int aoff = (kw + lane % 16) * LD + d0 + (lane / 16) * 8;
      ldmatrix_x4(ka, Ks + aoff);
      ldmatrix_x4(va, Vs + aoff);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        const int boff =
            (r0 + np * 16 + lane % 8 + 8 * (lane / 16)) * LD + d0 + 8 * ((lane / 8) % 2);
        uint32_t qb[4], db[4];
        ldmatrix_x4(qb, Qt + boff);
        ldmatrix_x4(db, Dt + boff);
        mma_bf16(st[2 * np], ka, qb[0], qb[1]);
        mma_bf16(st[2 * np + 1], ka, qb[2], qb[3]);
        mma_bf16(dp[2 * np], va, db[0], db[1]);
        mma_bf16(dp[2 * np + 1], va, db[2], db[3]);
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
        if (visible(key, row)) p = p_from_lse_fast(st[nt][e] * scale + bs[key], lt[row]);
        dp[nt][e] = p * (dp[nt][e] - dlt[row]) * scale;
        st[nt][e] = p;
      }
    }
    uint32_t pa[2][4], sa[2][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      pa[kk][0] = pack_bf16(st[2 * kk][0], st[2 * kk][1]);
      pa[kk][1] = pack_bf16(st[2 * kk][2], st[2 * kk][3]);
      pa[kk][2] = pack_bf16(st[2 * kk + 1][0], st[2 * kk + 1][1]);
      pa[kk][3] = pack_bf16(st[2 * kk + 1][2], st[2 * kk + 1][3]);
      sa[kk][0] = pack_bf16(dp[2 * kk][0], dp[2 * kk][1]);
      sa[kk][1] = pack_bf16(dp[2 * kk][2], dp[2 * kk][3]);
      sa[kk][2] = pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
      sa[kk][3] = pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
    }
    // dV += P^T dO, dK += dS^T Q over the sub-tile's rows
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
      for (int n0 = 0; n0 < D; n0 += 16) {
        const int boff =
            (r0 + kk * 16 + lane % 8 + 8 * ((lane / 8) % 2)) * LD + n0 + 8 * (lane / 16);
        uint32_t db[4], qb[4];
        ldmatrix_x4_trans(db, Dt + boff);
        ldmatrix_x4_trans(qb, Qt + boff);
        mma_bf16(dva[n0 / 8], pa[kk], db[0], db[1]);
        mma_bf16(dva[n0 / 8 + 1], pa[kk], db[2], db[3]);
        mma_bf16(dka[n0 / 8], sa[kk], qb[0], qb[1]);
        mma_bf16(dka[n0 / 8 + 1], sa[kk], qb[2], qb[3]);
      }
    }
  }
}

}  // namespace rt
