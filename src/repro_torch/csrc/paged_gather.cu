// Paged-KV-cache row gather: out[m] = pool[rows[m]], for one pool or for a
// pair of pools (the K and the V pool) sharing one row list.
//
// Replaces repro/kernels/paged.py::_copy_kernel (Pallas, TPU), which copies
// one pool row per grid cell with the row index scalar-prefetched into its
// BlockSpec.  Indices follow jnp indexing under jit (and the Pallas kernel
// in interpret mode): a negative index counts from the end (r + R), then
// anything still outside [0, R) reads the nearest edge row.  No index reads
// out of bounds.
//
// Layout: pools (R, row_bytes) of any element type, rows (M,) int32 or
// int64 (idx64) -> outs (M, row_bytes).  The kernel moves bytes and knows
// no dtype; it reads either index type itself, so a call is one launch.
//
// Bound on the H100: pure data movement (M rows of each pool read once and
// written once, the indices read once), so memory bounds the copy; at the
// decode's sizes (8 to 4,096 rows of 0.1 to 2 KB) it takes a few
// microseconds of device time, and the call around it -- the wrapper's host
// work and the launch -- is most of the cost.  A decode step gathered the
// K and the V pool with the same rows in two calls, four times a layer (the
// phi-block's rows, the compressed row it completes, the local window, the
// compressed rows of every block): eight calls whose host work outweighed
// their copies.  So one launch takes both pools: the row index is loaded
// and clamped once, and each lane copies its vector of the K row and of the
// V row, both loads issued before the stores.  The single-pool entry stays
// for callers with one pool; both run the same kernel.
//
// Design.  One warp per output row: the lanes copy the row's Hkv*D
// contiguous elements as 16-byte vectors (4- or 1-byte words when the row
// length or an address is not 16-byte aligned), neighbouring lanes on
// neighbouring addresses.  Eight warps a block.  At the decode's sizes the
// copy is bound by latency (the index load, then the row's), so a warp
// that took several rows with all its loads issued before its stores
// measured slower at every size, and one row a warp stays.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;

// P pools gathered with one row list: sources and destinations
template <typename V, int P>
struct Pools {
  const V* src[P];
  V* dst[P];
};

// the row an index reads: from the end when negative, then clamped
template <typename I>
__device__ __forceinline__ size_t pool_row(I r, int R) {
  if (r < 0) r += R;                               // from the end, as jnp
  return (size_t)(r < 0 ? 0 : (r >= R ? R - 1 : r));
}

template <typename V, typename I, int P>
__global__ void __launch_bounds__(32 * kWarps)
paged_gather_kernel(const Pools<V, P> io, const I* __restrict__ rows, int R, int M,
                    int vec_per_row) {
  const int m = blockIdx.x * kWarps + threadIdx.x / 32;
  if (m >= M) return;
  const int lane = threadIdx.x % 32;
  const size_t src = pool_row(rows[m], R) * vec_per_row;
  const size_t dst = (size_t)m * vec_per_row;
  for (int e = lane; e < vec_per_row; e += 32) {
    V x[P];
#pragma unroll
    for (int p = 0; p < P; ++p) x[p] = __ldg(io.src[p] + src + e);
#pragma unroll
    for (int p = 0; p < P; ++p) io.dst[p][dst + e] = x[p];
  }
}

template <typename V, typename I, int P>
int launch(const void* const* pools, const void* rows, void* const* outs, int R, int M,
           int row_bytes, cudaStream_t stream) {
  Pools<V, P> io;
  for (int p = 0; p < P; ++p) {
    io.src[p] = static_cast<const V*>(pools[p]);
    io.dst[p] = static_cast<V*>(outs[p]);
  }
  const dim3 grid((M + kWarps - 1) / kWarps);
  paged_gather_kernel<V, I, P><<<grid, 32 * kWarps, 0, stream>>>(
      io, static_cast<const I*>(rows), R, M, row_bytes / (int)sizeof(V));
  return (int)cudaGetLastError();
}

// the widest word that the row length and every address allow
template <typename I, int P>
int launch_aligned(const void* const* pools, const void* rows, void* const* outs, int R,
                   int M, int row_bytes, cudaStream_t stream) {
  uintptr_t addr = 0;
  for (int p = 0; p < P; ++p)
    addr |= reinterpret_cast<uintptr_t>(pools[p]) | reinterpret_cast<uintptr_t>(outs[p]);
  if (row_bytes % 16 == 0 && addr % 16 == 0)
    return launch<uint4, I, P>(pools, rows, outs, R, M, row_bytes, stream);
  if (row_bytes % 4 == 0 && addr % 4 == 0)
    return launch<uint32_t, I, P>(pools, rows, outs, R, M, row_bytes, stream);
  return launch<uint8_t, I, P>(pools, rows, outs, R, M, row_bytes, stream);
}

template <int P>
int gather(const void* const* pools, const void* rows, void* const* outs, int R, int M,
           int row_bytes, int idx64, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M == 0) return 0;
  if (R <= 0 || row_bytes <= 0) return (int)cudaErrorInvalidValue;
  return idx64 ? launch_aligned<long long, P>(pools, rows, outs, R, M, row_bytes, s)
               : launch_aligned<int, P>(pools, rows, outs, R, M, row_bytes, s);
}

}  // namespace

// idx64: 1 = rows are int64, 0 = int32
extern "C" int paged_gather(const void* pool, const void* rows, void* out, int R,
                            int M, int row_bytes, int idx64, void* stream) {
  const void* pools[1] = {pool};
  void* outs[1] = {out};
  return gather<1>(pools, rows, outs, R, M, row_bytes, idx64, stream);
}

// k_out = k_pool[rows], v_out = v_pool[rows]: two pools of one shape
extern "C" int paged_gather_pair(const void* k_pool, const void* v_pool, const void* rows,
                                 void* k_out, void* v_out, int R, int M, int row_bytes,
                                 int idx64, void* stream) {
  const void* pools[2] = {k_pool, v_pool};
  void* outs[2] = {k_out, v_out};
  return gather<2>(pools, rows, outs, R, M, row_bytes, idx64, stream);
}
