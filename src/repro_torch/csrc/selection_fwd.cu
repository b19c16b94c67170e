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
// Design.  The TPU scalar-prefetches idx so that its BlockSpecs fetch the
// selected blocks; here each warp loads its own group's indices.  At the
// paper's shapes a group is M = 8 rows against ell = 8 keys per block, far
// below a tensor-core tile, so one warp owns one (b, h, group): lanes are
// (8 rows) x (4 lanes per row), each lane holds D/4 dims of its row's query
// and accumulator, and a row's dot products are summed across its 4 lanes by
// shuffles.  The k* loop runs inside the warp.  An invalid selection costs
// nothing; a group with no valid selection writes zeros and LSE_EMPTY.
// Indices at or beyond NB are skipped as well, so a bad index never reads
// out of bounds.
//
// Bound on the H100: each group reads k* blocks of K and V (2*k*ell*D
// elements) for 4*M*k*ell*D FLOP, so it moves more bytes than it computes
// and memory bounds it; the blocks a group gathers are re-read through L2.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;          // (b, h, group) items per block
constexpr int kLanesPerRow = 4;
constexpr int kRowsPerPass = 32 / kLanesPerRow;
constexpr int kChunk = 8;          // keys scored per online-softmax step

template <typename T, int D>
__global__ void __launch_bounds__(32 * kWarps)
selection_fwd_kernel(const T* __restrict__ q, const T* __restrict__ kb,
                     const T* __restrict__ vb, const int* __restrict__ idx,
                     const float* __restrict__ tok_bias, T* __restrict__ o,
                     float* __restrict__ lse, int Hkv, int G, int M, int NB,
                     int ell, int k_star, int n_items, float scale) {
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

template <typename T, int D>
int launch(const void* q, const void* kb, const void* vb, const void* idx,
           const void* tok_bias, void* o, void* lse, int B, int Hkv, int G, int M,
           int NB, int ell, int k_star, cudaStream_t stream) {
  const int n_items = B * Hkv * G;
  const int blocks = (n_items + kWarps - 1) / kWarps;
  selection_fwd_kernel<T, D><<<blocks, 32 * kWarps, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kb), static_cast<const T*>(vb),
      static_cast<const int*>(idx), static_cast<const float*>(tok_bias),
      static_cast<T*>(o), static_cast<float*>(lse), Hkv, G, M, NB, ell, k_star,
      n_items, (float)(1.0 / sqrt((double)D)));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int selection_fwd(const void* q, const void* kb, const void* vb,
                             const void* idx, const void* tok_bias, void* o,
                             void* lse, int B, int Hkv, int G, int M, int NB,
                             int ell, int k_star, int D, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  RT_DISPATCH_D128(D, {
    return bf16 ? launch<__nv_bfloat16, kD>(q, kb, vb, idx, tok_bias, o, lse, B,
                                            Hkv, G, M, NB, ell, k_star, s)
                : launch<float, kD>(q, kb, vb, idx, tok_bias, o, lse, B, Hkv, G,
                                    M, NB, ell, k_star, s);
  });
  return 0;
}
