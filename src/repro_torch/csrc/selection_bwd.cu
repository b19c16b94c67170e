// Group-selected sparse attention backward: for each (batch, KV head, query
// group), dQ accumulated over the group's k* selected blocks, and each
// selected block's dK, dV added into the blocked gradients, recomputed from
// the forward's lse.
//
// Replaces repro/kernels/selection.py::_bwd_kernel (Pallas, TPU) and the jnp
// scatter that follows it (selection.py::_scatter_blocks).
//
// Layout: q, dO (B, Hkv, G, M, D) with M = g*rep rows per group, kb/vb
// (B, Hkv, NB, ell, D), idx (B, Hkv, G, k*) int32 (-1 = skip), tok_bias
// (B, NB, ell) fp32, lse and delta = rowsum(dO*O) (B, Hkv, G, M) fp32
// -> dq like q, dkb/dvb (B, Hkv, NB, ell, D) fp32, zeroed by the caller.
//
// Design.  As in the forward, one warp owns one (b, h, group): lanes are
// (8 rows) x (4 lanes per row), each lane holds D/4 dims of its row's q,
// dO and dq; a row's dot products (q.k, dO.v) are summed over its 4 lanes
// by shuffles.  For each valid selection and each of its ell keys:
//   p = exp(s - lse), dS = p*(dO.v - delta)*scale, dq += dS*k (lane-local),
//   dk_key = sum_rows dS*q, dv_key = sum_rows p*dO  (summed over the 8 row
//   groups of lanes by shuffles, then added atomically, one dim per lane).
// The TPU kernel wrote per-selection tiles to a staging buffer that jnp then
// scatter-added; here the atomic fp32 adds are the scatter, and a block
// picked by several groups sums their contributions in place.  p and dS are
// rounded to the operand dtype before their products.  Invalid selections,
// masked keys and rows with lse = LSE_EMPTY contribute nothing; a group with
// no valid selection writes dq = 0.
//
// Bound on the H100: each group reads k* blocks of K and V (2*k*ell*D
// elements) and adds as many gradient elements for 10*M*k*ell*D FLOP, so
// memory bounds it; the fp32 atomics resolve in L2.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;          // (b, h, group) items per block
constexpr int kLanesPerRow = 4;
constexpr int kRowsPerPass = 32 / kLanesPerRow;

template <typename T, int D>
__global__ void __launch_bounds__(32 * kWarps)
selection_bwd_kernel(const T* __restrict__ q, const T* __restrict__ kb,
                     const T* __restrict__ vb, const int* __restrict__ idx,
                     const float* __restrict__ tok_bias, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dq, float* __restrict__ dkb,
                     float* __restrict__ dvb, int Hkv, int G, int M, int NB, int ell,
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
      if (blk < 0 || blk >= NB) continue;
      const size_t blk0 = ((size_t)bh * NB + blk) * ell;
      const T* kp = kb + blk0 * D;
      const T* vp = vb + blk0 * D;
      const float* tb = tok_bias + ((size_t)b * NB + blk) * ell;
      for (int c = 0; c < ell; ++c) {
        if (tb[c] <= rt::NEG_HALF) continue;  // masked key: p == 0 on every row
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
        float* dkp = dkb + (blk0 + c) * D + d0;
        float* dvp = dvb + (blk0 + c) * D + d0;
#pragma unroll
        for (int d = 0; d < DPL; ++d) {
          acc[d] = fmaf(dsa, kc[d], acc[d]);
          // sum over the 8 row groups of lanes (lane bits 2..4)
          float gk = dsa * qv[d], gv = pa * dov[d];
#pragma unroll
          for (int o = kLanesPerRow; o < 32; o <<= 1) {
            gk += __shfl_xor_sync(0xffffffffu, gk, o);
            gv += __shfl_xor_sync(0xffffffffu, gv, o);
          }
          if (d % kRowsPerPass == rsub) {    // one lane adds each dim
            atomicAdd(dkp + d, gk);
            atomicAdd(dvp + d, gv);
          }
        }
      }
    }
    if (!has_row) continue;
#pragma unroll
    for (int d = 0; d < DPL; ++d) dq[qrow * D + d0 + d] = rt::from_f<T>(acc[d]);
  }
}

template <typename T, int D>
int launch(const void* q, const void* kb, const void* vb, const void* idx,
           const void* tok_bias, const void* dout, const void* lse, const void* delta,
           void* dq, void* dkb, void* dvb, int B, int Hkv, int G, int M, int NB,
           int ell, int k_star, cudaStream_t stream) {
  const int n_items = B * Hkv * G;
  const int blocks = (n_items + kWarps - 1) / kWarps;
  if (blocks == 0) return 0;
  selection_bwd_kernel<T, D><<<blocks, 32 * kWarps, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kb), static_cast<const T*>(vb),
      static_cast<const int*>(idx), static_cast<const float*>(tok_bias),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dq),
      static_cast<float*>(dkb), static_cast<float*>(dvb), Hkv, G, M, NB, ell,
      k_star, n_items, (float)(1.0 / sqrt((double)D)));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int selection_bwd(const void* q, const void* kb, const void* vb,
                             const void* idx, const void* tok_bias, const void* dout,
                             const void* lse, const void* delta, void* dq, void* dkb,
                             void* dvb, int B, int Hkv, int G, int M, int NB, int ell,
                             int k_star, int D, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  RT_DISPATCH_D128(D, {
    return bf16 ? launch<__nv_bfloat16, kD>(q, kb, vb, idx, tok_bias, dout, lse,
                                            delta, dq, dkb, dvb, B, Hkv, G, M, NB,
                                            ell, k_star, s)
                : launch<float, kD>(q, kb, vb, idx, tok_bias, dout, lse, delta, dq,
                                    dkb, dvb, B, Hkv, G, M, NB, ell, k_star, s);
  });
  return 0;
}
