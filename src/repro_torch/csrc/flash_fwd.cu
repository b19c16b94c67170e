// Streaming-softmax attention forward of N queries against L keys of any
// length, with an additive key bias and optional index masks.
//
// Replaces repro/kernels/flash.py::_fwd_kernel (Pallas, TPU), masks as in
// flash.py::_mask_logits:
//   causal        key j visible to query t iff j <= t,
//   block_causal  coarse key j visible iff (j+1)*ell - 1 < t.
//
// Layout (GQA-native): q (B*Hkv, rep, N, D), k/v (B*Hkv, L, D), key_bias
// (B, L) fp32, q_valid (B, N) uint8 or NULL -> o like q, lse (B*Hkv, rep, N).
//
// Design.  The TPU kernel carries its running max / sum / accumulator in
// scratch across sequential grid steps over K tiles; Hopper blocks run in no
// order, so here the K loop is a loop inside the block.  One thread block
// owns 128 query rows of one (batch*KV-head); it stages K/V tiles of 64 keys
// (32 at D = 128) into shared memory as fp32 and every thread folds its row through an
// online softmax (rt::fold_keys).  The ragged edge (L = 480 is not a tile
// multiple) is masked here, so the caller pads nothing.  A block none of
// whose rows is a valid query (q_valid) writes zeros / LSE_EMPTY and stops:
// those rows are unspecified by the JAX contract (repro/kernels/ops.py).
//
// Bound on the H100: at the compression branch's shapes (N = 3840,
// L = N/8 = 480, D = 32, fp32) the work is 4*L*D FLOP per query row, so the
// fp32 FMA rate bounds it.  This first kernel uses the fp32 pipes only.
#include "common.cuh"

namespace {

constexpr int kRows = 128;   // query rows (threads) per block

template <typename T, int D>
__global__ void __launch_bounds__(kRows)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ key_bias,
                 const uint8_t* __restrict__ q_valid, T* __restrict__ o,
                 float* __restrict__ lse, int rep, int N, int L, int n_heads,
                 int causal, int block_causal, int ell, float scale) {
  constexpr int kTile = rt::kTileRows<D>;   // keys per shared-memory tile
  __shared__ __align__(16) float Ks[kTile * D];
  __shared__ __align__(16) float Vs[kTile * D];
  __shared__ float bs[kTile];

  const int bh = blockIdx.y;
  const int b = bh / n_heads;
  const int row = blockIdx.x * kRows + threadIdx.x;        // in [0, rep*N)
  const bool has_row = row < rep * N;
  const int t = row % N;                                    // query position
  const size_t qrow = (size_t)bh * rep * N + row;

  if (q_valid != nullptr) {
    const bool mine = has_row && q_valid[(size_t)b * N + t] != 0;
    if (!__syncthreads_or(mine)) {         // whole tile is padding
      if (has_row) rt::write_empty_row<T, D>(o + qrow * D, lse + qrow);
      return;
    }
  }
  float qr[D];
  if (has_row) rt::load_row<T, D>(q + qrow * D, qr);
  rt::Row<D> st;
  const T* kb = k + (size_t)bh * L * D;
  const T* vb = v + (size_t)bh * L * D;
  const float* biasb = key_bias + (size_t)b * L;
  for (int j0 = 0; j0 < L; j0 += kTile) {
    const int n = min(kTile, L - j0);
    __syncthreads();                       // previous tile fully consumed
    rt::stage(kb + (size_t)j0 * D, Ks, n * D);
    rt::stage(vb + (size_t)j0 * D, Vs, n * D);
    rt::stage(biasb + j0, bs, n);
    __syncthreads();
    if (!has_row) continue;
    auto visible = [=](int j) {
      const int key = j0 + j;
      if (block_causal) return (key + 1) * ell - 1 < t;
      if (causal) return key <= t;
      return true;
    };
    rt::fold_keys<T, D>(qr, Ks, Vs, bs, n, scale, visible, st);
  }
  if (has_row) rt::write_row<T, D>(st, o + qrow * D, lse + qrow);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* key_bias,
           const void* q_valid, void* o, void* lse, int BH, int rep, int N, int L,
           int n_heads, int causal, int block_causal, int ell,
           cudaStream_t stream) {
  const dim3 grid((rep * N + kRows - 1) / kRows, BH);
  flash_fwd_kernel<T, D><<<grid, kRows, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(key_bias), static_cast<const uint8_t*>(q_valid),
      static_cast<T*>(o), static_cast<float*>(lse), rep, N, L, n_heads, causal,
      block_causal, ell, (float)(1.0 / sqrt((double)D)));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         const void* key_bias, const void* q_valid, void* o,
                         void* lse, int BH, int rep, int N, int L, int D,
                         int n_heads, int causal, int block_causal, int ell,
                         int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  RT_DISPATCH_D128(D, {
    return bf16 ? launch<__nv_bfloat16, kD>(q, k, v, key_bias, q_valid, o, lse,
                                            BH, rep, N, L, n_heads, causal,
                                            block_causal, ell, s)
                : launch<float, kD>(q, k, v, key_bias, q_valid, o, lse, BH, rep,
                                    N, L, n_heads, causal, block_causal, ell, s);
  });
  return 0;
}
