// Paged-KV-cache row gather: out[m] = pool[rows[m]].
//
// Replaces repro/kernels/paged.py::_copy_kernel (Pallas, TPU), which copies
// one pool row per grid cell with the row index scalar-prefetched into its
// BlockSpec.  Indices follow jnp indexing under jit (and the Pallas kernel
// in interpret mode): a negative index counts from the end (r + R), then
// anything still outside [0, R) reads the nearest edge row.  No index reads
// out of bounds.
//
// Layout: pool (R, row_bytes) of any element type, rows (M,) int32 or int64
// (idx64) -> out (M, row_bytes).  The kernel moves bytes and knows no dtype;
// it reads either index type itself, so a call is one launch.
//
// Design.  One warp per output row: the lanes copy the row's Hkv*D
// contiguous elements as 16-byte vectors (4- or 1-byte words when the row
// length or an address is not 16-byte aligned), neighbouring lanes on
// neighbouring addresses, so each row is one or two coalesced transactions
// per lane group.  Eight warps a block.  At the decode's sizes (8 to 4,096
// rows) the copy is bound by latency (the index load, then the row's), so
// a warp that took several rows with all its loads issued before its
// stores measured slower at every size, and one row a warp stays.
//
// Bound on the H100: pure data movement (M rows read once and written once,
// the indices read once), so memory bounds it; at the decode shapes (M =
// 8..4096 rows of 1 KB) the launch (a few microseconds) is most of its time.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;

template <typename V, typename I>
__global__ void __launch_bounds__(32 * kWarps)
paged_gather_kernel(const V* __restrict__ pool, const I* __restrict__ rows,
                    V* __restrict__ out, int R, int M, int vec_per_row) {
  const int m = blockIdx.x * kWarps + threadIdx.x / 32;
  if (m >= M) return;
  const int lane = threadIdx.x % 32;
  I r = rows[m];
  if (r < 0) r += R;                               // from the end, as jnp
  r = r < 0 ? 0 : (r >= R ? R - 1 : r);
  const V* src = pool + (size_t)r * vec_per_row;
  V* dst = out + (size_t)m * vec_per_row;
  for (int e = lane; e < vec_per_row; e += 32) dst[e] = src[e];
}

template <typename V, typename I>
int launch(const void* pool, const void* rows, void* out, int R, int M, int row_bytes,
           cudaStream_t stream) {
  const dim3 grid((M + kWarps - 1) / kWarps);
  paged_gather_kernel<V, I><<<grid, 32 * kWarps, 0, stream>>>(
      static_cast<const V*>(pool), static_cast<const I*>(rows), static_cast<V*>(out), R, M,
      row_bytes / (int)sizeof(V));
  return (int)cudaGetLastError();
}

template <typename I>
int launch_aligned(const void* pool, const void* rows, void* out, int R, int M,
                   int row_bytes, cudaStream_t stream) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(pool) |
                         reinterpret_cast<uintptr_t>(out);
  if (row_bytes % 16 == 0 && addr % 16 == 0)
    return launch<uint4, I>(pool, rows, out, R, M, row_bytes, stream);
  if (row_bytes % 4 == 0 && addr % 4 == 0)
    return launch<uint32_t, I>(pool, rows, out, R, M, row_bytes, stream);
  return launch<uint8_t, I>(pool, rows, out, R, M, row_bytes, stream);
}

}  // namespace

// idx64: 1 = rows are int64, 0 = int32
extern "C" int paged_gather(const void* pool, const void* rows, void* out, int R,
                            int M, int row_bytes, int idx64, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M == 0) return 0;
  if (R <= 0 || row_bytes <= 0) return (int)cudaErrorInvalidValue;
  return idx64 ? launch_aligned<long long>(pool, rows, out, R, M, row_bytes, s)
               : launch_aligned<int>(pool, rows, out, R, M, row_bytes, s);
}
