// The fold shared by the blocked-QR kernels (trailing_update.cu,
// panel_cross.cu, pad_cross.cu, all on panel_cross.cuh's sweep).
//
// Bitwise contracts the three kernels keep with each other:
//   * every element of A_new = A - Q.W is A minus one f32 register summed
//     over l = 0..b-1 in order with __fmaf_rn (slab_tiles.cuh), so it does
//     not depend on the trailing width or on which CTA computes it;
//   * every element of a cross partial S[i][j] = sum_r X[r][i] X[r][j] is
//     one f32 register summed over the rows of its split in order with
//     __fmaf_rn (panel_cross.cuh's sweep), and the splits are folded in index
//     order (fold_rect).  The split is a function of (batch, m) only
//     (_launch.cross_split), so pad_cross's real columns equal panel_cross,
//     trailing_update's S is panel_cross's sweep of the stored A_new, and a
//     wider trailing block (extra zero columns) leaves the real columns'
//     bits unchanged.
// The tile shapes do not enter the arithmetic order.
#pragma once

#include "cqr2_tiles.cuh"

namespace cross {

using cqr2::kThreads;

// s[b][i][j] = sum over splits in order of part[b][split][i][j].
__global__ void fold_rect(const float* __restrict__ part, float* __restrict__ s, int batch,
                          int splits, int rows, int cols) {
  const long long per = (long long)rows * cols;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= batch * per) return;
  const long long b = idx / per, rem = idx % per;
  const float* p = part + b * splits * per + rem;
  float sum = 0.0f;
  for (int k = 0; k < splits; ++k) sum = __fadd_rn(sum, p[k * per]);
  s[idx] = sum;
}

inline cudaError_t launch_fold_rect(const float* part, float* s, int batch, int splits, int rows,
                                    int cols, cudaStream_t stream) {
  const long long total = (long long)batch * rows * cols;
  const int blocks = (int)((total + kThreads - 1) / kThreads);
  fold_rect<<<blocks, kThreads, 0, stream>>>(part, s, batch, splits, rows, cols);
  return cudaGetLastError();
}

}  // namespace cross
