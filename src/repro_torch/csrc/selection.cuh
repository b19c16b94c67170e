// Shared device code of the selection kernels' tiled path (selection_fwd.cu,
// selection_bwd.cu): a group's valid selections, and one chunk of a selected
// block staged into shared memory.
#pragma once

#include "tiles.cuh"

namespace rt {

// The valid selections of one group (0 <= idx < NB, in the order of idx)
// into shared list[1..], their count into list[0]; every thread of the block
// gets the count.  list holds k_star + 1 ints.
__device__ __forceinline__ int collect_selections(const int* __restrict__ sel, int k_star,
                                                  int NB, int* list) {
  if (threadIdx.x == 0) {
    int n = 0;
    for (int j = 0; j < k_star; ++j) {
      const int blk = sel[j];
      if (blk >= 0 && blk < NB) list[1 + n++] = blk;
    }
    list[0] = n;
  }
  __syncthreads();
  return list[0];
}

// Keys [c0, c0 + BK) of selected block `blk` (of ell keys, head bh, batch b):
// K and V rows into shared tiles of BK rows (row stride LD; rows past the
// block are zero) and their token bias (NEG_INF past the block).  cp.async.
template <typename T, int D, int LD, int BK>
__device__ __forceinline__ void stage_block_chunk(T* Ks, T* Vs, float* bs, const T* kb,
                                                  const T* vb, const float* tok_bias,
                                                  size_t bh, int b, int blk, int c0,
                                                  int NB, int ell, int nthreads) {
  const int n = min(BK, ell - c0);
  const size_t r0 = ((size_t)bh * NB + blk) * ell + c0;
  stage_rows<T, D, LD>(Ks, kb + r0 * D, n, BK, nthreads);
  stage_rows<T, D, LD>(Vs, vb + r0 * D, n, BK, nthreads);
  stage_vals(bs, tok_bias + ((size_t)b * NB + blk) * ell + c0, n, BK, NEG_INF, nthreads);
}

}  // namespace rt
