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
// What bounds it on the H100.  Each visible (row, key) pair costs 4*D FLOP
// against one read of q, k, v and one write of o: at the tinyllama prefill
// shapes (w 256, rep 8, D 64, bf16) a row sees ~w*1.5 keys, so the products
// bound it on the tensor cores, with the bytes close behind.
//
// Design.  The TPU holds one grid cell's fused (rep*w, D) query tile and the
// two (w, D) key halves in VMEM and runs two pl.when-guarded softmax steps.
// Hopper blocks run in no order, so the halves are a loop inside the block.
// Two paths, one rule (kernels/local.py::local_plan; the wrapper passes
// `tiles`), the rule of local_bwd.cu:
//   tiles  bf16, w a multiple of 64: local_fwd_mma.  A block of 4 warps owns
//          64 rows (chunk c) of one (b*h, query head r, block i) and walks
//          exactly local_dq_mma's key tiles (kernels/local.py::dq_walk):
//          the prev half's w/64 tiles when live[b, i, 0], then the self
//          half's tiles 0..c when live[b, i, 1], only the diagonal tile c
//          masked (key <= row).  blockIdx.x runs r fastest, so the rep heads
//          that share a K/V tile run side by side and hit L2, and the late
//          (heavy) chunks launch first.  The tile step is mma_fwd.cuh's,
//          shared with flash_fwd_mma: K/V tiles of 64 keys staged by
//          cp.async, double-buffered, S = QK^T and O += PV on mma.sync
//          m16n8k16 with fp32 accumulation, the online softmax in the
//          accumulator's layout (__expf), P rounded to bf16 as PV's A
//          fragment (the rows path's pv_operand).
//   rows   fp32, and w not a multiple of 64: local_fwd_rows.  A block owns
//          up to 128 query positions of one (b*h, r, block i) and every
//          thread folds one row through an online softmax (rt::fold_keys):
//          first the prev half, then the self half with the causal rule;
//          K/V are staged through shared memory in tiles of 64 keys (32 at
//          D = 128) as fp32; the self half stops at the block's last row.
// A dead half is skipped exactly (its keys would all be masked), and a block
// with both halves dead writes zeros and LSE_EMPTY without reading K or V,
// the oracle's all-masked row.  A row whose visible keys are all masked
// (the padded tail) gets o = 0 and LSE_EMPTY too.
#include "mma_fwd.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// rows: one thread a row on the FMA pipes
// ---------------------------------------------------------------------------
constexpr int kRows = 128;   // query rows (threads) per block

template <typename T, int D>
__global__ void __launch_bounds__(kRows)
local_fwd_rows(const T* __restrict__ q, const T* __restrict__ k,
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

// ---------------------------------------------------------------------------
// tiles, bf16: tensor cores.  4 warps, warp w owns rows 16w..16w+15 of the
// block's 64; per staged tile of 64 keys a warp computes S (16 rows x 64
// keys), folds it into the running max / sum of its rows and adds P V into
// its O (16 x D, fp32): rt::mma_fwd_walk.
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
local_fwd_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const float* __restrict__ key_bias,
              const int* __restrict__ live, bf16* __restrict__ o, float* __restrict__ lse,
              int BH, int rep, int N, int w, int n_heads, float scale) {
  using C = FwdMma<D>;
  constexpr int BM = C::BM, BK = C::BK, LD = C::LD;
  bf16* sm = reinterpret_cast<bf16*>(rt::dyn_smem());
  bf16* Qs = sm + C::Q_OFF;
  float* bs = reinterpret_cast<float*>(sm + C::BF_END);    // [2][BK]

  // blockIdx.x = ((chunks - 1 - c) * BH + bh) * nb + i) * rep + r: the late
  // (heavy) row chunks of every block first, the rep heads side by side
  const int nb = N / w, chunks = w / BM;
  int x = blockIdx.x;
  const int r = x % rep;
  x /= rep;
  const int i = x % nb;
  x /= nb;
  const int bh = x % BH, c = chunks - 1 - x / BH;
  const int b = bh / n_heads;
  const size_t base = ((size_t)bh * rep + r) * N + (size_t)i * w + c * BM;
  const int* lv = live + ((size_t)b * nb + i) * 2;
  const int n_prev = lv[0] != 0 ? w / BK : 0;               // block i-1, every key
  const int n_self = lv[1] != 0 ? c + 1 : 0;                // block i up to the diagonal
  const int n_kt = n_prev + n_self;
  if (n_kt == 0) {                                          // both halves dead
    rt::write_empty_tile<bf16, D>(o + base * D, lse + base, BM);
    return;
  }

  rt::stage_rows<bf16, D, LD>(Qs, q + base * D, BM, BM, C::NT);
  const bf16* kb = k + (size_t)bh * N * D;
  const bf16* vb = v + (size_t)bh * N * D;
  const float* biasb = key_bias + (size_t)b * N;
  auto load_tile = [&](int kt, int buf) {
    const int j0 = kt < n_prev ? (i - 1) * w + kt * BK : i * w + (kt - n_prev) * BK;
    rt::stage_rows<bf16, D, LD>(sm + C::K_OFF + buf * BK * LD, kb + (size_t)j0 * D, BK, BK,
                                C::NT);
    rt::stage_rows<bf16, D, LD>(sm + C::V_OFF + buf * BK * LD, vb + (size_t)j0 * D, BK, BK,
                                C::NT);
    rt::stage_vals(bs + buf * BK, biasb + j0, BK, BK, rt::NEG_INF, C::NT);
  };
  // the self half's tile c is the diagonal: key <= row, both from the chunk start
  auto masked = [&](int kt, int key, int row) {
    return n_self > 0 && kt == n_kt - 1 && key > row;
  };
  rt::MmaRows<D> st;
  rt::mma_fwd_walk<D, BK, LD>(Qs, sm + C::K_OFF, sm + C::V_OFF, bs, n_kt, scale, load_tile,
                              masked, st);
  rt::mma_fwd_store<D>(st, o + base * D, lse + base, BM);
}

// ---------------------------------------------------------------------------

template <typename T, int D>
int launch_rows(const void* q, const void* k, const void* v, const void* key_bias,
                const void* live, void* o, void* lse, int BH, int rep, int N, int w,
                int n_heads, cudaStream_t stream) {
  const int chunks = (w + kRows - 1) / kRows;
  const dim3 grid(rep * (N / w) * chunks, BH);
  local_fwd_rows<T, D><<<grid, kRows, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(key_bias), static_cast<const int*>(live),
      static_cast<T*>(o), static_cast<float*>(lse), rep, N, w, n_heads, chunks,
      (float)(1.0 / sqrt((double)D)));
  return (int)cudaGetLastError();
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, const void* key_bias,
               const void* live, void* o, void* lse, int BH, int rep, int N, int w,
               int n_heads, cudaStream_t stream) {
  using C = FwdMma<D>;
  auto kern = local_fwd_mma<D>;
  if (int err = rt::set_smem(kern, C::SMEM)) return err;
  const unsigned blocks = (unsigned)(w / C::BM) * BH * (N / w) * rep;
  kern<<<blocks, C::NT, C::SMEM, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(key_bias), static_cast<const int*>(live),
      static_cast<bf16*>(o), static_cast<float*>(lse), BH, rep, N, w, n_heads,
      (float)(1.0 / sqrt((double)D)));
  return (int)cudaGetLastError();
}

}  // namespace

// tiles: 1 = the tiled path (bf16, w a multiple of 64), 0 = the rows path;
// kernels/local.py::local_plan picks
extern "C" int local_fwd(const void* q, const void* k, const void* v,
                         const void* key_bias, const void* live, void* o,
                         void* lse, int BH, int rep, int N, int D, int w,
                         int n_heads, int bf16, int tiles, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (BH == 0 || rep == 0 || N == 0) return 0;
  if (tiles && (!bf16 || w % 64 != 0)) return (int)cudaErrorInvalidValue;
  RT_DISPATCH_D128(D, {
    if (tiles)
      return launch_mma<kD>(q, k, v, key_bias, live, o, lse, BH, rep, N, w, n_heads, s);
    return bf16 ? launch_rows<__nv_bfloat16, kD>(q, k, v, key_bias, live, o, lse, BH, rep,
                                                 N, w, n_heads, s)
                : launch_rows<float, kD>(q, k, v, key_bias, live, o, lse, BH, rep, N, w,
                                         n_heads, s);
  });
  return 0;
}
