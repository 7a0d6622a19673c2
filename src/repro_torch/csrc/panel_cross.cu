// Blocked-QR pipeline prime: S = A[:, :split]^T A of a batch of tall blocks,
// f32 accumulation, in one sweep over A.
//
// Replaces the TPU kernel src/repro/kernels/trailing_update.py:panel_cross
// (_cross_kernel) and its Pallas-Triton lowering in
// src/repro/kernels/gpu.py:panel_cross.
//
// What bounds it on an H100: f32 FMAs.  At split = 128, n = 512 it needs
// m split (split + 1) operations for the symmetric split x split block and
// 2 m split (n - split) for the rest, against 4 m n bytes of A: 56 flop/byte,
// far above the card's ~20 flop/byte balance without tensor cores.  f32
// stays f32 (no TF32): S holds the next panel's Gram, whose Cholesky
// squares kappa.
//
// Arithmetic (the contract of cross_tiles.cuh): each partial S[i][j] is one
// f32 register summed with __fmaf_rn over its split's rows in row order;
// the rows are split by _launch.cross_split (a function of (batch, m) only)
// and the splits folded in index order by fold_rect.  No atomics.
//
// Design: panel_cross.cuh, whose sweep trailing_update.cu also runs.
#include "panel_cross.cuh"

// a: (batch, m, n) with row stride lda and batch stride a_bs (elements);
// part: (batch, splits, split, n) f32 scratch; s: (batch, split, n) f32.
// Split k covers rows [k * rows_per_split, ...).  Returns the launch's
// cudaError_t.
extern "C" int repro_panel_cross(const void* a, void* part, void* s, int is_bf16, int batch,
                                 int m, int n, int split, long long lda, long long a_bs,
                                 int rows_per_split, int splits, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  float* out = static_cast<float*>(s);
  if (is_bf16)
    return cross::panel_cross(static_cast<const __nv_bfloat16*>(a), p, out, batch, m, n, split,
                              lda, a_bs, rows_per_split, splits, st);
  return cross::panel_cross(static_cast<const float*>(a), p, out, batch, m, n, split, lda, a_bs,
                            rows_per_split, splits, st);
}
