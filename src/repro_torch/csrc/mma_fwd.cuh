// The forward step of the bf16 tensor-core attention kernels (flash_fwd_mma
// in flash_fwd.cu, local_fwd_mma in local_fwd.cu): a walk over staged key
// tiles that folds each into a warp's 16 query rows by S = QK^T -> online
// softmax -> O += PV, and the store of (o, lse) at its end.
//
// A block of 4 warps owns 64 staged query rows; warp w owns rows
// 16w..16w+15.  K/V tiles of BK keys (row stride LD) are staged by cp.async
// and double-buffered; S and PV run on mma.sync m16n8k16 with fp32
// accumulation.  The online softmax runs in the accumulator's layout (lane
// 4g + tig holds rows g and g + 8 of its warp's 16, keys 8nt + 2tig..+1 of
// each 8-key column), so a row's max and sum take two quad shuffles; the
// exponentials run on the MUFU unit (__expf), and P is rounded to bf16 as
// PV's A fragment.  Masking follows common.cuh: a masked logit is NEG_INF,
// a row that sees no unmasked key gets o = 0 and lse = LSE_EMPTY.
#pragma once

#include "tiles.cuh"

namespace rt {

// Online-softmax state of a warp's 16 rows in the accumulator's layout: the
// running max m and sum l of rows g (h 0) and g + 8 (h 1) over the lane's
// keys (the quad's sum is taken at the store), and O's columns
// 8nt + 2tig..+1 of both rows.
template <int D>
struct MmaRows {
  float m[2], l[2], o[D / 8][4];
  __device__ __forceinline__ MmaRows() {
#pragma unroll
    for (int h = 0; h < 2; ++h) m[h] = NEG_INF, l[h] = 0.f;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  }
};

// Fold one staged tile kt of BK keys (Kt, Vt: BK rows of stride LD; bt: the
// keys' additive bias) into the warp's rows.  Qs: the block's staged Q (row
// stride LD); rw: the warp's first row.  masked(kt, key, row) says that key
// `key` of the tile is hidden from row `row` of the block by an index mask.
template <int D, int BK, int LD, typename Masked>
__device__ __forceinline__ void mma_fwd_tile(const __nv_bfloat16* Qs,
                                             const __nv_bfloat16* Kt,
                                             const __nv_bfloat16* Vt, const float* bt,
                                             int rw, int kt, float scale, Masked masked,
                                             MmaRows<D>& st) {
  const int lane = threadIdx.x % 32, g = lane / 4, tig = lane % 4;
  float s[BK / 8][4];
#pragma unroll
  for (int i = 0; i < BK / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
  // S = Q K^T over D
#pragma unroll
  for (int d0 = 0; d0 < D; d0 += 16) {
    uint32_t qa[4];
    ldmatrix_x4(qa, Qs + (rw + lane % 16) * LD + d0 + (lane / 16) * 8);
#pragma unroll
    for (int np = 0; np < BK / 16; ++np) {
      uint32_t kf[4];
      ldmatrix_x4(kf, Kt + (np * 16 + lane % 8 + 8 * (lane / 16)) * LD + d0 +
                          8 * ((lane / 8) % 2));
      mma_bf16(s[2 * np], qa, kf[0], kf[1]);
      mma_bf16(s[2 * np + 1], qa, kf[2], kf[3]);
    }
  }
  // logits, then the online softmax of rows g (h 0) and g + 8 (h 1), whose
  // BK keys lie on the 4 lanes of their quad
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = nt * 8 + tig * 2 + (e % 2);
      float x = s[nt][e] * scale + bt[key];
      if (masked(kt, key, rw + g + 8 * (e / 2))) x = NEG_INF;
      s[nt][e] = x;
      mx[e / 2] = fmaxf(mx[e / 2], x);
    }
  float ms[2], alpha[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float m_new = fmaxf(st.m[h], mx[h]);
    ms[h] = fmaxf(m_new, NEG_HALF);
    alpha[h] = st.m[h] <= NEG_HALF ? 0.f : __expf(fminf(st.m[h] - ms[h], 0.f));
    st.m[h] = m_new;
    st.l[h] *= alpha[h];
  }
#pragma unroll
  for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = s[nt][e];
      const float p = x > NEG_HALF ? __expf(x - ms[e / 2]) : 0.f;
      st.l[e / 2] += p;
      s[nt][e] = p;
    }
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) st.o[i][e] *= alpha[e / 2];
  // O += P V over the tile's keys, P rounded to bf16 as A fragments
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    uint32_t pa[4];
    pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
    pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
    pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
    for (int n0 = 0; n0 < D; n0 += 16) {
      uint32_t vf[4];
      ldmatrix_x4_trans(vf, Vt + (kk * 16 + lane % 8 + 8 * ((lane / 8) % 2)) * LD + n0 +
                                8 * (lane / 16));
      mma_bf16(st.o[n0 / 8], pa, vf[0], vf[1]);
      mma_bf16(st.o[n0 / 8 + 1], pa, vf[2], vf[3]);
    }
  }
}

// The walk over n_kt >= 1 key tiles: load_tile(kt, buf) stages tile kt into
// buffer buf (Ks / Vs + buf * BK * LD, bs + buf * BK) by cp.async without
// committing; Q's copies, issued before the call, join tile 0's group.
template <int D, int BK, int LD, typename Load, typename Masked>
__device__ __forceinline__ void mma_fwd_walk(const __nv_bfloat16* Qs,
                                             const __nv_bfloat16* Ks,
                                             const __nv_bfloat16* Vs, const float* bs,
                                             int n_kt, float scale, Load load_tile,
                                             Masked masked, MmaRows<D>& st) {
  const int rw = (threadIdx.x / 32) * 16;
  load_tile(0, 0);
  cp_async_commit();
  for (int kt = 0; kt < n_kt; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < n_kt) load_tile(kt + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    mma_fwd_tile<D, BK, LD>(Qs, Ks + buf * BK * LD, Vs + buf * BK * LD, bs + buf * BK, rw,
                            kt, scale, masked, st);
    __syncthreads();                       // buffer `buf` is free for tile kt+2
  }
  cp_async_wait<0>();
}

// o = O / l (zeros where l = 0) and lse = max(m, NEG_HALF) + log l
// (LSE_EMPTY where l = 0) of the warp's rows below n; o and lse point at the
// block's first row.
template <int D>
__device__ __forceinline__ void mma_fwd_store(MmaRows<D>& st, __nv_bfloat16* o, float* lse,
                                              int n) {
  const int lane = threadIdx.x % 32, g = lane / 4, tig = lane % 4;
  const int rw = (threadIdx.x / 32) * 16;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = st.l[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int r = rw + g + 8 * h;
    if (r >= n) continue;
    const float inv = l > 0.f ? 1.f / l : 0.f;
    __nv_bfloat16* out = o + (size_t)r * D + tig * 2;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
      store2<__nv_bfloat16>(out + nt * 8, st.o[nt][2 * h] * inv, st.o[nt][2 * h + 1] * inv);
    if (tig == 0)
      lse[r] = l > 0.f ? fmaxf(st.m[h], NEG_HALF) + logf(fmaxf(l, 1e-30f)) : LSE_EMPTY;
  }
}

}  // namespace rt
