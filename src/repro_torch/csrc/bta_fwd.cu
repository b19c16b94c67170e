// Ball-Tree Attention forward: full softmax attention inside each contiguous
// ball of m keys, with an additive key bias.
//
// Replaces repro/kernels/bta.py::_fwd_kernel (Pallas, TPU).
//
// Layout (GQA-native, as on the TPU): q (B*Hkv, rep, N, D), k/v (B*Hkv, N, D),
// key_bias (B, N) fp32, live (B, N/m) int32 -> o like q, lse (B*Hkv, rep, N).
// The rep query heads of a KV head share the ball's keys.
//
// Bound on the H100: the work is 4*m*D FLOP per query row against 2*D
// elements of q/o per row and the ball's K/V read once per KV head, so the
// products bound it: on the bf16 tensor cores in bf16 (seamless's encoder: m
// = 256, D = 64), on the fp32 FMA pipes at the paper's shapes (m = 256, D =
// 32, fp32).
//
// Design.  Three paths, one rule (kernels/bta.py::bta_plan):
//   mma   bf16, m a multiple of 64, D 16-128: one block of 4 warps per
//         (batch*KV-head, ball, tile of 64 of the ball's rep*m rows; 64
//         divides m, so a tile lies in one query head) walks the ball's m/64
//         key tiles with flash_fwd_mma's step (mma_fwd.cuh): K/V tiles
//         staged in bf16 by cp.async and double-buffered, S = QK^T and
//         O += PV on mma.sync m16n8k16 with fp32 accumulation, the online
//         softmax in the accumulator's layout, P rounded to bf16.  The ball
//         is the key range, so the grid is (rep*m/64, N/m, B*Hkv) and no host
//         plan is needed; no tile holds a ball whole, so no ball size is too
//         large and D 128 fits (a block's shared memory: 52 KB at D 128).
//   fma   fp32, m a multiple of 64 up to 256, D 16 or 32 (shapenet): one
//         block per (batch*KV-head, ball, tile of 64 of the ball's rep*m
//         rows) walks the ball's m/32 key tiles, staged by cp.async and
//         double-buffered, with flash_fwd_fma's register-tiled step
//         (fma_fwd.cuh): 8 key lanes x 16 row lanes, a thread holding 4 rows
//         x 4 keys of S (eight float4 loads a step feed 64 FMAs; 16 key
//         lanes would need ten) and 4 rows x D/8 dims of O.
//   rows  fp32 at D 64 and balls that are no multiple of 64: one thread per
//         query row carries an online softmax over the ball's keys
//         (rt::fold_keys), K and V staged whole as fp32 (m = 256, D = 32:
//         64 KB) and read as broadcasts.
// No index mask: the key bias alone masks.  A dead ball (no valid key,
// `live` = 0) skips the loads and the arithmetic and writes zeros with lse =
// LSE_EMPTY, as the TPU kernel does; a walked row whose keys are all masked
// ends with l = 0 and gets the same.
#include "fma_fwd.cuh"
#include "mma_fwd.cuh"

namespace {

using rt::set_smem;
using rt::stage_rows;
using rt::stage_vals;

// ---------------------------------------------------------------------------
// rows: one thread a query row, the ball's K and V staged whole.
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void bta_fwd_rows(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, const float* __restrict__ key_bias,
                             const int* __restrict__ live, T* __restrict__ o,
                             float* __restrict__ lse, int rep, int N, int m, int n_heads,
                             float scale) {
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

// ---------------------------------------------------------------------------
// fma, fp32: register tiles on the FMA pipes.  blockIdx.x: the row tile of
// the ball's rep*m rows (64 rows of one query head, since 64 divides m).
// ---------------------------------------------------------------------------
template <int D>
struct FwdFma {
  static constexpr int BM = 64, BK = 32, KX = 8, NT = 128;
  static constexpr int RY = NT / KX, RPT = BM / RY, KPT = BK / KX, DPT = D / KX;
  static constexpr int LD = D + 4, LS = BK + 8;
  static constexpr int Q_OFF = 0, K_OFF = BM * LD, V_OFF = K_OFF + 2 * BK * LD;
  static constexpr int P_OFF = V_OFF + 2 * BK * LD, B_OFF = P_OFF + BM * LS;
  static constexpr size_t SMEM = (size_t)(B_OFF + 2 * BK) * 4;
};

template <int D>
__global__ void __launch_bounds__(FwdFma<D>::NT)
bta_fwd_fma(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ key_bias,
            const int* __restrict__ live, float* __restrict__ o, float* __restrict__ lse,
            int rep, int N, int m, int n_heads, float scale) {
  using C = FwdFma<D>;
  constexpr int BK = C::BK, LD = C::LD;
  float* sm = reinterpret_cast<float*>(rt::dyn_smem());
  float* bs = sm + C::B_OFF;                                // [2][BK]

  const int bh = blockIdx.z, ball = blockIdx.y;
  const int b = bh / n_heads;
  const int row0 = blockIdx.x * C::BM;                      // in the ball's rep*m rows
  const size_t base = ((size_t)bh * rep + row0 / m) * N + (size_t)ball * m + row0 % m;
  if (live[b * (N / m) + ball] == 0) {      // all keys masked: exact zeros
    rt::write_empty_tile<float, D>(o + base * D, lse + base, C::BM);
    return;
  }
  stage_rows<float, D, LD>(sm + C::Q_OFF, q + base * D, C::BM, C::BM, C::NT);
  const float* kb = k + ((size_t)bh * N + (size_t)ball * m) * D;
  const float* vb = v + ((size_t)bh * N + (size_t)ball * m) * D;
  const float* biasb = key_bias + (size_t)b * N + (size_t)ball * m;
  auto load_tile = [&](int kt, int buf) {
    const int j0 = kt * BK;
    stage_rows<float, D, LD>(sm + C::K_OFF + buf * BK * LD, kb + (size_t)j0 * D, BK, BK, C::NT);
    stage_rows<float, D, LD>(sm + C::V_OFF + buf * BK * LD, vb + (size_t)j0 * D, BK, BK, C::NT);
    stage_vals(bs + buf * BK, biasb + j0, BK, BK, rt::NEG_INF, C::NT);
  };
  rt::FmaRows<C::RPT, C::DPT> st;
  rt::fma_fwd_walk<C, D>(sm + C::Q_OFF, sm + C::K_OFF, sm + C::V_OFF, bs, sm + C::P_OFF,
                         m / BK, scale, load_tile, [](int, int, int) { return false; }, st);
  rt::fma_fwd_store<C, D>(st, o + base * D, lse + base, C::BM);
}

// ---------------------------------------------------------------------------
// mma, bf16: tensor cores.  4 warps, warp w owns rows 16w..16w+15 of the
// block's 64; per staged tile of 64 keys a warp computes S (16 rows x 64
// keys), folds it into the running max / sum of its rows and adds P V into
// its O (16 x D, fp32): rt::mma_fwd_walk.  blockIdx.x: the row tile of the
// ball's rep*m rows (64 rows of one query head, since 64 divides m).
// ---------------------------------------------------------------------------
template <int D>
struct FwdMma {
  static constexpr int BM = 64, BK = 64, NT = 128, LD = D + 8;
  // three blocks an SM where the registers allow it without spills
  static constexpr int MIN_BLOCKS = D > 64 ? 2 : 3;
  static constexpr int Q_OFF = 0, K_OFF = BM * LD, V_OFF = K_OFF + 2 * BK * LD;
  static constexpr int BF_END = V_OFF + 2 * BK * LD;
  static constexpr size_t SMEM = (size_t)BF_END * 2 + (size_t)2 * BK * 4;
};

template <int D>
__global__ void __launch_bounds__(FwdMma<D>::NT, FwdMma<D>::MIN_BLOCKS)
bta_fwd_mma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
            const __nv_bfloat16* __restrict__ v, const float* __restrict__ key_bias,
            const int* __restrict__ live, __nv_bfloat16* __restrict__ o,
            float* __restrict__ lse, int rep, int N, int m, int n_heads, float scale) {
  using bf16 = __nv_bfloat16;
  using C = FwdMma<D>;
  constexpr int BK = C::BK, LD = C::LD;
  bf16* sm = reinterpret_cast<bf16*>(rt::dyn_smem());
  float* bs = reinterpret_cast<float*>(sm + C::BF_END);    // [2][BK]

  const int bh = blockIdx.z, ball = blockIdx.y;
  const int b = bh / n_heads;
  const int row0 = blockIdx.x * C::BM;                      // in the ball's rep*m rows
  const size_t base = ((size_t)bh * rep + row0 / m) * N + (size_t)ball * m + row0 % m;
  if (live[b * (N / m) + ball] == 0) {      // all keys masked: exact zeros
    rt::write_empty_tile<bf16, D>(o + base * D, lse + base, C::BM);
    return;
  }
  stage_rows<bf16, D, LD>(sm + C::Q_OFF, q + base * D, C::BM, C::BM, C::NT);
  const bf16* kb = k + ((size_t)bh * N + (size_t)ball * m) * D;
  const bf16* vb = v + ((size_t)bh * N + (size_t)ball * m) * D;
  const float* biasb = key_bias + (size_t)b * N + (size_t)ball * m;
  auto load_tile = [&](int kt, int buf) {
    const int j0 = kt * BK;
    stage_rows<bf16, D, LD>(sm + C::K_OFF + buf * BK * LD, kb + (size_t)j0 * D, BK, BK, C::NT);
    stage_rows<bf16, D, LD>(sm + C::V_OFF + buf * BK * LD, vb + (size_t)j0 * D, BK, BK, C::NT);
    stage_vals(bs + buf * BK, biasb + j0, BK, BK, rt::NEG_INF, C::NT);
  };
  rt::MmaRows<D> st;
  rt::mma_fwd_walk<D, BK, LD>(sm + C::Q_OFF, sm + C::K_OFF, sm + C::V_OFF, bs, m / BK, scale,
                              load_tile, [](int, int, int) { return false; }, st);
  rt::mma_fwd_store<D>(st, o + base * D, lse + base, C::BM);
}

// ---------------------------------------------------------------------------

template <typename T, int D>
int launch_rows(const void* q, const void* k, const void* v, const void* key_bias,
                const void* live, void* o, void* lse, int BH, int rep, int N, int m,
                int n_heads, float scale, cudaStream_t stream) {
  const int rows = rep * m;
  const int threads = rows < 256 ? ((rows + 31) / 32) * 32 : 256;
  const dim3 grid((rows + threads - 1) / threads, N / m, BH);
  const size_t smem = (size_t)(2 * m * D + m) * sizeof(float);
  auto kern = bta_fwd_rows<T, D>;
  if (int err = set_smem(kern, smem)) return err;
  kern<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(key_bias), static_cast<const int*>(live),
      static_cast<T*>(o), static_cast<float*>(lse), rep, N, m, n_heads, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_fma(const void* q, const void* k, const void* v, const void* key_bias,
               const void* live, void* o, void* lse, int BH, int rep, int N, int m,
               int n_heads, float scale, cudaStream_t stream) {
  using C = FwdFma<D>;
  if (m % C::BM != 0) return (int)cudaErrorInvalidValue;
  auto kern = bta_fwd_fma<D>;
  if (int err = set_smem(kern, C::SMEM)) return err;
  const dim3 grid(rep * m / C::BM, N / m, BH);
  kern<<<grid, C::NT, C::SMEM, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(key_bias),
      static_cast<const int*>(live), static_cast<float*>(o), static_cast<float*>(lse), rep,
      N, m, n_heads, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, const void* key_bias,
               const void* live, void* o, void* lse, int BH, int rep, int N, int m,
               int n_heads, float scale, cudaStream_t stream) {
  using C = FwdMma<D>;
  if (m % C::BM != 0) return (int)cudaErrorInvalidValue;
  auto kern = bta_fwd_mma<D>;
  if (int err = set_smem(kern, C::SMEM)) return err;
  const dim3 grid(rep * m / C::BM, N / m, BH);
  kern<<<grid, C::NT, C::SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(key_bias),
      static_cast<const int*>(live), static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse),
      rep, N, m, n_heads, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// path: kernels/bta.py::bta_plan's (PATH_CODES: 0 rows, 1 fma: fp32 at D 16 or
// 32, 2 mma: bf16, m a multiple of 64)
extern "C" int bta_fwd(const void* q, const void* k, const void* v,
                       const void* key_bias, const void* live, void* o, void* lse,
                       int BH, int rep, int N, int D, int m, int n_heads, int bf16,
                       int path, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N % m != 0) return (int)cudaErrorInvalidValue;
  if (BH == 0 || rep == 0 || N == 0) return 0;
  const float scale = (float)(1.0 / sqrt((double)D));
  if (path == 2) {
    if (!bf16) return (int)cudaErrorInvalidValue;
    RT_DISPATCH_D128(D, {
      return launch_mma<kD>(q, k, v, key_bias, live, o, lse, BH, rep, N, m, n_heads, scale, s);
    });
  }
  if (path == 1) {
    if (bf16) return (int)cudaErrorInvalidValue;
    switch (D) {
      case 16: return launch_fma<16>(q, k, v, key_bias, live, o, lse, BH, rep, N, m, n_heads,
                                     scale, s);
      case 32: return launch_fma<32>(q, k, v, key_bias, live, o, lse, BH, rep, N, m, n_heads,
                                     scale, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (path != 0) return (int)cudaErrorInvalidValue;
  RT_DISPATCH_D(D, {
    return bf16 ? launch_rows<__nv_bfloat16, kD>(q, k, v, key_bias, live, o, lse, BH, rep,
                                                 N, m, n_heads, scale, s)
                : launch_rows<float, kD>(q, k, v, key_bias, live, o, lse, BH, rep, N, m,
                                         n_heads, scale, s);
  });
  return 0;
}
