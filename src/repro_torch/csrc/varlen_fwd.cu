// Packed-varlen streaming-softmax attention forward: T packed query rows
// against L packed keys, a query seeing only the keys of its own segment.
//
// Replaces repro/kernels/varlen.py::_fwd_kernel (Pallas, TPU).
//
// Layout (GQA-native): q (Hkv, rep, T, D), k/v (Hkv, L, D), key_bias (1, L)
// fp32 -> o like q, lse (Hkv, rep, T) fp32.  The segments come from the host
// offsets, as a plan (fma) or as per-position ids (rows): qseg (T) / kseg (L)
// int32 segment ids, k_bounds (S+2) int32, segment s owning keys
// [k_bounds[s], k_bounds[s+1]) (the capacity tail is segment S).
//
// Bound on the H100: the work is sum_i T_i * L_i (row, key) pairs of 4*D
// FLOP, so the fp32 FMA rate bounds it.
//
// Design.  The TPU kernel walks the full (q-tile, k-tile) grid and skips the
// cells whose per-tile segment ranges do not overlap (scalar-prefetched
// ranges).  Here the skip is planned on the host.  Two paths
// (kernels/varlen.py::varlen_plan):
//   fma   fp32.  A host plan (kernels/occupancy.py::varlen_row_tiles) cuts
//         each segment's rows into tiles of 64 (the segment's last tile
//         ragged; no tile crosses a segment boundary) and gives each tile
//         its segment's keys: an int32 table (tiles, 4) of (first row, rows,
//         first key, end key).  Grid (tiles, rep, Hkv): a block runs
//         flash_fwd_fma's register-tiled block (rt::FwdFma and the walk of
//         csrc/fma_fwd.cuh) on its rows against its keys in 32-key tiles.
//         Every pair it visits is of one segment, so no segment test is
//         left: the key bias masks the invalid pooled keys (keys past the
//         range in the last staged tile take NEG_INF).  A tile whose key
//         range holds no valid key (the capacity tail's, or an empty range)
//         writes zeros and LSE_EMPTY without walking; so does any row that
//         sees no valid key, through the step's own rule.
//   rows  bf16 (no main path runs it).  One thread block owns 128
//         consecutive query rows of one (KV head, query head of its group),
//         reads the segment ids of its first and last row (ids are monotone
//         along the axis) and folds only keys [k_bounds[s_first],
//         k_bounds[s_last+1]), in tiles of 64 staged into shared memory as
//         fp32; every thread folds its row through an online softmax
//         (rt::fold_keys), masking keys of another segment (qseg != kseg) to
//         NEG_INF on top of the key bias.  A key tile with no valid key is
//         skipped whole.  A row that saw no valid key writes zeros and
//         lse = LSE_EMPTY.
#include "fma_fwd.cuh"

namespace {

using rt::FwdFma;

constexpr int kRows = 128;   // rows: query rows (threads) per block
constexpr int kTile = 64;    // rows: keys per shared-memory tile

template <typename T, int D>
__global__ void __launch_bounds__(kRows)
varlen_fwd_rows(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ key_bias,
                const int* __restrict__ qseg, const int* __restrict__ kseg,
                const int* __restrict__ k_bounds, T* __restrict__ o,
                float* __restrict__ lse, int rep, int Tq, int L, float scale) {
  __shared__ __align__(16) float Ks[kTile * D];
  __shared__ __align__(16) float Vs[kTile * D];
  __shared__ float bs[kTile];
  __shared__ int ss[kTile];

  const int h = blockIdx.z;
  const int t0 = blockIdx.x * kRows;
  const int t = t0 + threadIdx.x;                           // query position
  const bool has_row = t < Tq;
  const size_t qrow = ((size_t)h * rep + blockIdx.y) * Tq + t;
  const int my_seg = has_row ? qseg[t] : -1;
  const int j_lo = k_bounds[qseg[t0]];
  const int j_hi = k_bounds[qseg[min(t0 + kRows, Tq) - 1] + 1];

  float qr[D];
  if (has_row) rt::load_row<T, D>(q + qrow * D, qr);
  rt::Row<D> st;
  const T* kh = k + (size_t)h * L * D;
  const T* vh = v + (size_t)h * L * D;
  for (int j0 = j_lo; j0 < j_hi; j0 += kTile) {
    const int n = min(kTile, j_hi - j0);
    __syncthreads();                       // previous tile fully consumed
    if (threadIdx.x < n) {
      bs[threadIdx.x] = key_bias[j0 + threadIdx.x];
      ss[threadIdx.x] = kseg[j0 + threadIdx.x];
    }
    const bool live = threadIdx.x < n && key_bias[j0 + threadIdx.x] > rt::NEG_HALF;
    if (!__syncthreads_or(live)) continue;  // no valid key in the tile
    rt::stage(kh + (size_t)j0 * D, Ks, n * D);
    rt::stage(vh + (size_t)j0 * D, Vs, n * D);
    __syncthreads();
    if (!has_row) continue;
    auto visible = [&](int j) { return ss[j] == my_seg; };
    rt::fold_keys<T, D>(qr, Ks, Vs, bs, n, scale, visible, st);
  }
  if (has_row) rt::write_row<T, D>(st, o + qrow * D, lse + qrow);
}

// fma, fp32: flash_fwd_fma's block on one planned tile.  tiles: (n_tiles)
// int4 of (first row, rows, first key, end key).
template <int D>
__global__ void __launch_bounds__(FwdFma<D>::NT, 1)
varlen_fwd_fma(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ key_bias,
               const int4* __restrict__ tiles, float* __restrict__ o,
               float* __restrict__ lse, int rep, int Tq, int L, float scale) {
  using C = FwdFma<D>;
  constexpr int BK = C::BK, LD = C::LD;
  float* sm = reinterpret_cast<float*>(rt::dyn_smem());
  float* bs = sm + C::B_OFF;                                // [2][BK]

  const int4 t = tiles[blockIdx.x];
  const int h = blockIdx.z, nk = t.w - t.z;
  const size_t base = ((size_t)h * rep + blockIdx.y) * Tq + t.x;
  const float* biasb = key_bias + t.z;
  bool live = false;                       // a valid key in the range
  for (int j = threadIdx.x; j < nk && !live; j += C::NT) live = biasb[j] > rt::NEG_HALF;
  if (!__syncthreads_or(live)) {
    rt::write_empty_tile<float, D>(o + base * D, lse + base, t.y);
    return;
  }

  rt::stage_rows<float, D, LD>(sm + C::Q_OFF, q + base * D, t.y, C::BM, C::NT);
  const float* kb = k + ((size_t)h * L + t.z) * D;
  const float* vb = v + ((size_t)h * L + t.z) * D;
  auto load_tile = [&](int kt, int buf) {
    const int j0 = kt * BK, n = min(BK, nk - j0);
    rt::stage_rows<float, D, LD>(sm + C::K_OFF + buf * BK * LD, kb + (size_t)j0 * D, n, BK,
                                 C::NT);
    rt::stage_rows<float, D, LD>(sm + C::V_OFF + buf * BK * LD, vb + (size_t)j0 * D, n, BK,
                                 C::NT);
    rt::stage_vals(bs + buf * BK, biasb + j0, n, BK, rt::NEG_INF, C::NT);
  };
  rt::FmaRows<C::RPT, C::DPT> st;
  rt::fma_fwd_walk<C, D>(sm + C::Q_OFF, sm + C::K_OFF, sm + C::V_OFF, bs, sm + C::P_OFF,
                         (nk + BK - 1) / BK, scale, load_tile,
                         [](int, int, int) { return false; }, st);
  rt::fma_fwd_store<C, D>(st, o + base * D, lse + base, t.y);
}

template <int D>
int launch_rows(const void* q, const void* k, const void* v, const void* key_bias,
                const void* qseg, const void* kseg, const void* k_bounds, void* o,
                void* lse, int H, int rep, int Tq, int L, cudaStream_t stream) {
  using T = __nv_bfloat16;
  const dim3 grid((Tq + kRows - 1) / kRows, rep, H);
  varlen_fwd_rows<T, D><<<grid, kRows, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(key_bias), static_cast<const int*>(qseg),
      static_cast<const int*>(kseg), static_cast<const int*>(k_bounds),
      static_cast<T*>(o), static_cast<float*>(lse), rep, Tq, L,
      (float)(1.0 / sqrt((double)D)));
  return (int)cudaGetLastError();
}

template <int D>
int launch_fma(const void* q, const void* k, const void* v, const void* key_bias,
               const void* tiles, void* o, void* lse, int H, int rep, int Tq, int L,
               int n_tiles, cudaStream_t stream) {
  using C = FwdFma<D>;
  auto kern = varlen_fwd_fma<D>;
  if (int err = rt::set_smem(kern, C::SMEM)) return err;
  const dim3 grid(n_tiles, rep, H);
  kern<<<grid, C::NT, C::SMEM, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(key_bias),
      static_cast<const int4*>(tiles), static_cast<float*>(o), static_cast<float*>(lse), rep,
      Tq, L, (float)(1.0 / sqrt((double)D)));
  return (int)cudaGetLastError();
}

}  // namespace

// fp32 (the fma path): tiles the (n_tiles, 4) int32 plan of
// kernels/occupancy.py::varlen_row_tiles, whose tiles cover [0, T); qseg,
// kseg and k_bounds unused.  bf16 (the rows path): tiles and n_tiles unused.
extern "C" int varlen_fwd(const void* q, const void* k, const void* v,
                          const void* key_bias, const void* qseg, const void* kseg,
                          const void* k_bounds, const void* tiles, void* o, void* lse, int H,
                          int rep, int Tq, int L, int n_tiles, int D, int bf16,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H == 0 || rep == 0 || Tq == 0) return 0;
  if (!bf16 && (tiles == nullptr || n_tiles < 1)) return (int)cudaErrorInvalidValue;
  RT_DISPATCH_D(D, {
    return bf16 ? launch_rows<kD>(q, k, v, key_bias, qseg, kseg, k_bounds, o, lse, H, rep, Tq,
                                  L, s)
                : launch_fma<kD>(q, k, v, key_bias, tiles, o, lse, H, rep, Tq, L, n_tiles, s);
  });
  return 0;
}
