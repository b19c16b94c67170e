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
// What bounds it on the H100.  Per visible (row, key) pair it does 4*D FLOP
// against one read of q and one write of o: at the LM prefill (one
// 32,768-token sequence, 32 / 4 heads of 64 against 512 pooled keys, bf16)
// the Q and O bytes bound it (0.08 ms) and the products sit just below them
// on the bf16 tensor cores; at the compression branch of shapenet (N 3840
// against L 480, D 32, fp32) the FMA pipes do.
//
// Design.  The TPU kernel carries its running max / sum / accumulator in
// scratch across sequential grid steps over K tiles; Hopper blocks run in no
// order, so the K loop is a loop inside the block.  A block owns a tile of
// BM positions of one query head r of one (batch*KV head) bh
// (kernels/flash.py::flash_fwd_plan); the grid runs the late position tiles
// first, since in the causal modes they walk the most keys.  A tile walks
// the key tiles up to the last one its last row sees (block-causal: keys
// j < t_last/ell; causal: j <= t_last) and masks per element only a key
// tile that some row of it does not see whole.  A tile that sees no key, or
// none of whose rows is a valid query (q_valid), writes zeros and LSE_EMPTY
// and stops: in block-causal mode every row t < ell sees nothing, and the
// padding rows are unspecified by the JAX contract (repro/kernels/ops.py).
// The ragged key edge (L = 480 is not a tile multiple) is masked here
// (keys past L carry NEG_INF bias), so the caller pads nothing.
//   mma   bf16: K/V tiles of 64 keys staged by cp.async, double-buffered;
//         S = QK^T and O += PV on the tensor cores (mma.sync m16n8k16, fp32
//         accumulation), a warp owning 16 rows; the online softmax runs in
//         registers in the accumulator's layout, exponentials on the MUFU
//         unit (__expf), and P is rounded to bf16 as PV's A fragment: the
//         walk and the tile step are mma_fwd.cuh's, shared with local_fwd_mma.
//   fma   fp32: the same walk on the FMA pipes, register-tiled (8 key lanes
//         x 16 row lanes, 16 x 16 at D 128; P through shared memory), so no
//         thread holds a row of D: D 128 builds without spills.  The tiles
//         (FwdFma), tile step and walk are fma_fwd.cuh's, shared with
//         varlen_fwd_fma (bta_fwd_fma shares the step and walk).  (It
//         replaced one thread a row over all L keys, which spilled at D 128
//         and was slower at shapenet's shape.)
#include "fma_fwd.cuh"
#include "mma_fwd.cuh"

namespace {

using bf16 = __nv_bfloat16;
using rt::FwdFma;
using rt::Mask;
using rt::set_smem;
using rt::stage_rows;
using rt::stage_vals;
using rt::write_empty_tile;

// The positions [t0, t0 + n) of query head r of bh that a tiled block owns:
// blockIdx.x = ((P - 1 - tile) * BH + bh) * rep + r over the P position
// tiles of bm rows, so the late tiles launch first.
struct RowTile {
  int bh, r, t0, n;
};

__device__ __forceinline__ RowTile row_tile(int BH, int rep, int N, int bm) {
  const int P = (N + bm - 1) / bm;
  int x = blockIdx.x;
  const int r = x % rep;
  x /= rep;
  const int bh = x % BH;
  const int t0 = (P - 1 - x / BH) * bm;
  return {bh, r, t0, min(bm, N - t0)};
}

// The keys [0, kmax) a tile walks: those its last row sees.  0 when it sees
// none, or when none of its rows is a valid query (q_valid; block-uniform).
__device__ __forceinline__ int tile_kmax(const uint8_t* q_valid, int b, int N, int L,
                                         const RowTile& tile, Mask mask) {
  if (q_valid != nullptr) {
    const bool mine =
        threadIdx.x < tile.n && q_valid[(size_t)b * N + tile.t0 + threadIdx.x] != 0;
    if (!__syncthreads_or(mine)) return 0;
  }
  return min(L, mask.keys_seen(tile.t0 + tile.n - 1));
}

// ---------------------------------------------------------------------------
// mma, bf16: tensor cores.  4 warps, warp w owns rows 16w..16w+15 of the
// block's 64; per staged tile of 64 keys a warp computes S (16 rows x 64
// keys), folds it into the running max / sum of its rows, and adds P V into
// its O (16 x D, fp32): rt::mma_fwd_walk.
// ---------------------------------------------------------------------------
template <int D>
struct FwdMma {
  static constexpr int BM = 64, BK = 64, NT = 128, LD = D + 8;
  static constexpr int Q_OFF = 0, K_OFF = BM * LD, V_OFF = K_OFF + 2 * BK * LD;
  static constexpr int BF_END = V_OFF + 2 * BK * LD;
  static constexpr size_t SMEM = (size_t)BF_END * 2 + (size_t)2 * BK * 4;
};

template <int D>
__global__ void __launch_bounds__(128, 1)
flash_fwd_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const float* __restrict__ key_bias,
              const uint8_t* __restrict__ q_valid, bf16* __restrict__ o,
              float* __restrict__ lse, int BH, int rep, int N, int L, int n_heads,
              Mask mask, float scale) {
  using C = FwdMma<D>;
  constexpr int BK = C::BK, LD = C::LD;
  bf16* sm = reinterpret_cast<bf16*>(rt::dyn_smem());
  bf16* Qs = sm + C::Q_OFF;
  float* bs = reinterpret_cast<float*>(sm + C::BF_END);     // [2][BK]

  const RowTile tile = row_tile(BH, rep, N, C::BM);
  const int b = tile.bh / n_heads;
  const size_t base = ((size_t)tile.bh * rep + tile.r) * N + tile.t0;
  const int kmax = tile_kmax(q_valid, b, N, L, tile, mask);
  if (kmax <= 0) {
    write_empty_tile<bf16, D>(o + base * D, lse + base, tile.n);
    return;
  }
  const int seen0 = mask.keys_seen(tile.t0);                // keys the first row sees

  stage_rows<bf16, D, LD>(Qs, q + base * D, tile.n, C::BM, C::NT);
  const bf16* kb = k + (size_t)tile.bh * L * D;
  const bf16* vb = v + (size_t)tile.bh * L * D;
  const float* biasb = key_bias + (size_t)b * L;
  auto load_tile = [&](int kt, int buf) {
    const int j0 = kt * BK, n = min(BK, L - j0);
    stage_rows<bf16, D, LD>(sm + C::K_OFF + buf * BK * LD, kb + (size_t)j0 * D, n, BK, C::NT);
    stage_rows<bf16, D, LD>(sm + C::V_OFF + buf * BK * LD, vb + (size_t)j0 * D, n, BK, C::NT);
    stage_vals(bs + buf * BK, biasb + j0, n, BK, rt::NEG_INF, C::NT);
  };
  // per element only where some row does not see the whole tile
  auto masked = [&](int kt, int key, int row) {
    return seen0 < (kt + 1) * BK && !mask.visible(kt * BK + key, tile.t0 + row);
  };
  rt::MmaRows<D> st;
  rt::mma_fwd_walk<D, BK, LD>(Qs, sm + C::K_OFF, sm + C::V_OFF, bs, (kmax + BK - 1) / BK,
                              scale, load_tile, masked, st);
  rt::mma_fwd_store<D>(st, o + base * D, lse + base, tile.n);
}

// ---------------------------------------------------------------------------
// fma, fp32: FMA pipes, register-tiled, on the tiles of rt::FwdFma
// (csrc/fma_fwd.cuh, shared with varlen_fwd_fma): rt::fma_fwd_walk, the tile
// step shared with bta_fwd_fma and varlen_fwd_fma.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(FwdFma<D>::NT, 1)
flash_fwd_fma(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ key_bias,
              const uint8_t* __restrict__ q_valid, float* __restrict__ o,
              float* __restrict__ lse, int BH, int rep, int N, int L, int n_heads,
              Mask mask, float scale) {
  using C = FwdFma<D>;
  constexpr int BK = C::BK, LD = C::LD;
  float* sm = reinterpret_cast<float*>(rt::dyn_smem());
  float* bs = sm + C::B_OFF;                                // [2][BK]

  const RowTile tile = row_tile(BH, rep, N, C::BM);
  const int b = tile.bh / n_heads;
  const size_t base = ((size_t)tile.bh * rep + tile.r) * N + tile.t0;
  const int kmax = tile_kmax(q_valid, b, N, L, tile, mask);
  if (kmax <= 0) {
    write_empty_tile<float, D>(o + base * D, lse + base, tile.n);
    return;
  }
  const int seen0 = mask.keys_seen(tile.t0);                // keys the first row sees

  stage_rows<float, D, LD>(sm + C::Q_OFF, q + base * D, tile.n, C::BM, C::NT);
  const float* kb = k + (size_t)tile.bh * L * D;
  const float* vb = v + (size_t)tile.bh * L * D;
  const float* biasb = key_bias + (size_t)b * L;
  auto load_tile = [&](int kt, int buf) {
    const int j0 = kt * BK, n = min(BK, L - j0);
    stage_rows<float, D, LD>(sm + C::K_OFF + buf * BK * LD, kb + (size_t)j0 * D, n, BK, C::NT);
    stage_rows<float, D, LD>(sm + C::V_OFF + buf * BK * LD, vb + (size_t)j0 * D, n, BK, C::NT);
    stage_vals(bs + buf * BK, biasb + j0, n, BK, rt::NEG_INF, C::NT);
  };
  // per element only where some row does not see the whole tile
  auto masked = [&](int kt, int key, int row) {
    return seen0 < (kt + 1) * BK && !mask.visible(kt * BK + key, tile.t0 + row);
  };
  rt::FmaRows<C::RPT, C::DPT> st;
  rt::fma_fwd_walk<C, D>(sm + C::Q_OFF, sm + C::K_OFF, sm + C::V_OFF, bs, sm + C::P_OFF,
                         (kmax + BK - 1) / BK, scale, load_tile, masked, st);
  rt::fma_fwd_store<C, D>(st, o + base * D, lse + base, tile.n);
}

// ---------------------------------------------------------------------------

template <int D>
int launch_mma(const void* q, const void* k, const void* v, const void* key_bias,
               const void* q_valid, void* o, void* lse, int BH, int rep, int N, int L,
               int n_heads, Mask mask, float scale, cudaStream_t stream) {
  using C = FwdMma<D>;
  auto kern = flash_fwd_mma<D>;
  if (int err = set_smem(kern, C::SMEM)) return err;
  const unsigned blocks = (unsigned)((N + C::BM - 1) / C::BM) * BH * rep;
  kern<<<blocks, C::NT, C::SMEM, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(key_bias), static_cast<const uint8_t*>(q_valid),
      static_cast<bf16*>(o), static_cast<float*>(lse), BH, rep, N, L, n_heads, mask, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_fma(const void* q, const void* k, const void* v, const void* key_bias,
               const void* q_valid, void* o, void* lse, int BH, int rep, int N, int L,
               int n_heads, Mask mask, float scale, cudaStream_t stream) {
  using C = FwdFma<D>;
  auto kern = flash_fwd_fma<D>;
  if (int err = set_smem(kern, C::SMEM)) return err;
  const unsigned blocks = (unsigned)((N + C::BM - 1) / C::BM) * BH * rep;
  kern<<<blocks, C::NT, C::SMEM, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(key_bias), static_cast<const uint8_t*>(q_valid),
      static_cast<float*>(o), static_cast<float*>(lse), BH, rep, N, L, n_heads, mask, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// kernels/flash.py::flash_fwd_plan: bf16 takes mma, fp32 fma
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         const void* key_bias, const void* q_valid, void* o,
                         void* lse, int BH, int rep, int N, int L, int D,
                         int n_heads, int causal, int block_causal, int ell,
                         int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (BH == 0 || rep == 0 || N == 0) return 0;
  const Mask mask{causal, block_causal, ell};
  const float scale = (float)(1.0 / sqrt((double)D));
  RT_DISPATCH_D128(D, {
    return bf16 ? launch_mma<kD>(q, k, v, key_bias, q_valid, o, lse, BH, rep, N, L, n_heads,
                                 mask, scale, s)
                : launch_fma<kD>(q, k, v, key_bias, q_valid, o, lse, BH, rep, N, L, n_heads,
                                 mask, scale, s);
  });
  return 0;
}
