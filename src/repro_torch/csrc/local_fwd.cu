// Blocked local causal attention forward (the causal LM's local branch).
//
// Replaces repro/kernels/local.py::_fwd_kernel (Pallas, TPU).  Query block i
// (w positions) attends causally within block i (key <= query, both counted
// from the block start) and fully to block i-1, with an additive key bias.
//
// Layout (GQA-native): q (B*Hkv, rep, N, D), k/v (B*Hkv, N, D), key_bias
// (B, N) fp32, live (B, N/w, 2) int32 -> o like q, lse (B*Hkv, rep, N) fp32.
// live[b, i, 0] says the prev half of block i carries weight (i > 0, block
// i-1 of the same segment, some key of it unmasked); live[b, i, 1] the self
// half (kernels/occupancy.py::local_half_live).  The segment rule of packed
// batches is folded into live[.., 0], so the kernel reads no segment ids.
//
// Design.  The TPU holds one grid cell's fused (rep*w, D) query tile and the
// two (w, D) key halves in VMEM and runs two pl.when-guarded softmax steps.
// Here one thread block owns up to 128 query positions of one (b*h, r,
// block i) and every thread folds one row through an online softmax
// (rt::fold_keys): first the prev half, then the self half with the causal
// rule; K/V are staged through shared memory in tiles of 64 keys (32 at
// D = 128) as fp32.
// A dead half is skipped exactly (its keys would all be masked), and a block
// with both halves dead writes zeros and LSE_EMPTY, the oracle's all-masked
// row.  The self half stops at the block's last row's position, so a block
// of rows reads only the keys it can see.
//
// Bound on the H100: at the tinyllama prefill shapes (w = 256, rep 8, D 64)
// each row does 4*D FLOP against ~w*1.5 visible keys while q, k, v, o are
// read or written once, so the arithmetic bounds it.  This first kernel uses
// the fp32 pipes only (bf16 tensor cores would be ~15x the rate).
#include "common.cuh"

namespace {

constexpr int kRows = 128;   // query rows (threads) per block

template <typename T, int D>
__global__ void __launch_bounds__(kRows)
local_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ key_bias,
                 const int* __restrict__ live, T* __restrict__ o,
                 float* __restrict__ lse, int rep, int N, int w, int n_heads,
                 int chunks, float scale) {
  constexpr int kTile = rt::kTileRows<D>;   // keys per shared-memory tile
  __shared__ __align__(16) float Ks[kTile * D];
  __shared__ __align__(16) float Vs[kTile * D];
  __shared__ float bs[kTile];

  const int nb = N / w;
  const int c = blockIdx.x % chunks;                 // row chunk inside the block
  const int i = (blockIdx.x / chunks) % nb;          // query block
  const int r = blockIdx.x / (chunks * nb);          // query head of the group
  const int bh = blockIdx.y;
  const int b = bh / n_heads;
  const int tin = c * kRows + threadIdx.x;           // position inside block i
  const bool has_row = tin < w;
  const size_t qrow = ((size_t)bh * rep + r) * N + (size_t)i * w + tin;

  const int* lv = live + ((size_t)b * nb + i) * 2;
  const bool live_prev = lv[0] != 0;
  const bool live_self = lv[1] != 0;
  if (!live_prev && !live_self) {                    // block-uniform
    if (has_row) rt::write_empty_row<T, D>(o + qrow * D, lse + qrow);
    return;
  }
  float qr[D];
  if (has_row) rt::load_row<T, D>(q + qrow * D, qr);
  rt::Row<D> st;
  const T* kb = k + (size_t)bh * N * D;
  const T* vb = v + (size_t)bh * N * D;
  const float* biasb = key_bias + (size_t)b * N;

  // half 0: block i-1, fully visible; half 1: block i, key <= tin
  for (int half = 0; half < 2; ++half) {
    if (half == 0 ? !live_prev : !live_self) continue;     // block-uniform
    const int base = (i - 1 + half) * w;
    const int limit = half == 0 ? w : min(w, (c + 1) * kRows);
    for (int j0 = 0; j0 < limit; j0 += kTile) {
      const int n = min(kTile, limit - j0);
      __syncthreads();                     // previous tile fully consumed
      rt::stage(kb + (size_t)(base + j0) * D, Ks, n * D);
      rt::stage(vb + (size_t)(base + j0) * D, Vs, n * D);
      rt::stage(biasb + base + j0, bs, n);
      __syncthreads();
      if (!has_row) continue;
      const bool causal = half == 1;
      auto visible = [=](int j) { return !causal || j0 + j <= tin; };
      rt::fold_keys<T, D>(qr, Ks, Vs, bs, n, scale, visible, st);
    }
  }
  if (has_row) rt::write_row<T, D>(st, o + qrow * D, lse + qrow);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* key_bias,
           const void* live, void* o, void* lse, int BH, int rep, int N, int w,
           int n_heads, cudaStream_t stream) {
  const int chunks = (w + kRows - 1) / kRows;
  const dim3 grid(rep * (N / w) * chunks, BH);
  local_fwd_kernel<T, D><<<grid, kRows, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(key_bias), static_cast<const int*>(live),
      static_cast<T*>(o), static_cast<float*>(lse), rep, N, w, n_heads, chunks,
      (float)(1.0 / sqrt((double)D)));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int local_fwd(const void* q, const void* k, const void* v,
                         const void* key_bias, const void* live, void* o,
                         void* lse, int BH, int rep, int N, int D, int w,
                         int n_heads, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (BH == 0 || N == 0) return 0;
  RT_DISPATCH_D128(D, {
    return bf16 ? launch<__nv_bfloat16, kD>(q, k, v, key_bias, live, o, lse, BH,
                                            rep, N, w, n_heads, s)
                : launch<float, kD>(q, k, v, key_bias, live, o, lse, BH, rep, N,
                                    w, n_heads, s);
  });
  return 0;
}
