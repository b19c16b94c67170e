// Ball-Tree Attention forward: full softmax attention inside each contiguous
// ball of m keys, with an additive key bias.
//
// Replaces repro/kernels/bta.py::_fwd_kernel (Pallas, TPU).
//
// Layout (GQA-native, as on the TPU): q (B*Hkv, rep, N, D), k/v (B*Hkv, N, D),
// key_bias (B, N) fp32, live (B, N/m) int32 -> o like q, lse (B*Hkv, rep, N).
// The rep query heads of a KV head share the block's K/V tile.
//
// Design.  One thread block per (batch*KV-head, ball, tile of query rows):
// the ball's K and V are staged once into shared memory as fp32 (m = 256,
// D = 32: 64 KB) and every thread carries one query row through an online
// softmax over the ball's keys (rt::fold_keys), reading keys as shared-memory
// broadcasts.  A dead ball (no valid key, `live` = 0) skips the loads and the
// arithmetic and writes zeros with lse = LSE_EMPTY, as the TPU kernel does.
//
// Bound on the H100: at the paper's shapes (m = 256, D = 32, fp32) the work
// is 4*m*D FLOP per query row against 2*D*4 bytes of q/o per row, so the
// fp32 FMA rate bounds it, not memory.  This first kernel runs on the fp32
// pipes (no tensor cores); mma.sync/wgmma tiles are a later PR's work.
#include "common.cuh"

namespace {

template <typename T, int D>
__global__ void bta_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                               const T* __restrict__ v,
                               const float* __restrict__ key_bias,
                               const int* __restrict__ live, T* __restrict__ o,
                               float* __restrict__ lse, int rep, int N, int m,
                               int n_heads, float scale) {
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + m * D;
  float* bs = Vs + m * D;

  const int bh = blockIdx.z;
  const int ball = blockIdx.y;
  const int b = bh / n_heads;
  const int n_balls = N / m;
  const int row = blockIdx.x * blockDim.x + threadIdx.x;   // in [0, rep*m)
  const bool has_row = row < rep * m;
  const int r = row / m;
  const int pos = ball * m + row % m;
  const size_t qrow = ((size_t)bh * rep + r) * N + pos;

  if (live[b * n_balls + ball] == 0) {      // all keys masked: exact zeros
    if (has_row) rt::write_empty_row<T, D>(o + qrow * D, lse + qrow);
    return;
  }
  const size_t kv0 = ((size_t)bh * N + (size_t)ball * m) * D;
  rt::stage(k + kv0, Ks, m * D);
  rt::stage(v + kv0, Vs, m * D);
  rt::stage(key_bias + (size_t)b * N + (size_t)ball * m, bs, m);
  __syncthreads();
  if (!has_row) return;

  float qr[D];
  rt::load_row<T, D>(q + qrow * D, qr);
  rt::Row<D> st;
  rt::fold_keys<T, D>(qr, Ks, Vs, bs, m, scale, [](int) { return true; }, st);
  rt::write_row<T, D>(st, o + qrow * D, lse + qrow);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* key_bias,
           const void* live, void* o, void* lse, int BH, int rep, int N, int m,
           int n_heads, cudaStream_t stream) {
  const int rows = rep * m;
  const int threads = rows < 256 ? ((rows + 31) / 32) * 32 : 256;
  const dim3 grid((rows + threads - 1) / threads, N / m, BH);
  const size_t smem = (size_t)(2 * m * D + m) * sizeof(float);
  auto kern = bta_fwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(key_bias), static_cast<const int*>(live),
      static_cast<T*>(o), static_cast<float*>(lse), rep, N, m, n_heads,
      (float)(1.0 / sqrt((double)D)));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int bta_fwd(const void* q, const void* k, const void* v,
                       const void* key_bias, const void* live, void* o, void* lse,
                       int BH, int rep, int N, int D, int m, int n_heads, int bf16,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N % m != 0) return (int)cudaErrorInvalidValue;
  RT_DISPATCH_D(D, {
    return bf16 ? launch<__nv_bfloat16, kD>(q, k, v, key_bias, live, o, lse, BH,
                                            rep, N, m, n_heads, s)
                : launch<float, kD>(q, k, v, key_bias, live, o, lse, BH, rep, N,
                                    m, n_heads, s);
  });
  return 0;
}
