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
// Design.  The TPU kernel accumulates S in one VMEM block that its
// sequential grid revisits; on Hopper's parallel grid that is a race.  Here
// the rows are split over CTAs (grid.y, _launch.cross_split: a function of
// (batch, m) only) and every (row tile I of S, column tile J of A) pair is
// its own CTA (grid.x), streaming its split's rows in 32-row chunks through
// shared memory into a register tile of at most 128 x 128 (8 x 8 a thread).
// Each CTA writes an f32 partial; fold_rect sums the splits in index order.
// No atomics: every run gives the same bits.  A's rows may be strided (a
// column slice of a wider matrix goes in without a copy); ragged rows are
// masked while loading.  bf16 inputs are converted to f32 on load.
#include "cross_tiles.cuh"

namespace {

template <typename S, int T>
__global__ void __launch_bounds__(cqr2::kThreads)
    cross_partial_kernel(const S* __restrict__ a, float* __restrict__ part, int m, int n,
                         int split, long long lda, long long a_bs, int rows_per_split) {
  __shared__ __align__(16) float Xi[cqr2::kRows][T];
  __shared__ __align__(16) float Xj[cqr2::kRows][T];
  const int nj = (n + T - 1) / T;
  const int ti = blockIdx.x / nj, tj = blockIdx.x % nj;
  const int sp = blockIdx.y, b = blockIdx.z;
  const S* src = a + (long long)b * a_bs;
  const int r_begin = sp * rows_per_split;
  const int r_end = min(m, r_begin + rows_per_split);

  float acc[T / 16][T / 16];
  cross::zero_acc<T>(acc);
  for (int r0 = r_begin; r0 < r_end; r0 += cqr2::kRows) {
    cross::load_strided<S, T>(Xj, src, r_end, n, lda, r0, tj * T);
    if (ti != tj) cross::load_strided<S, T>(Xi, src, r_end, n, lda, r0, ti * T);
    __syncthreads();
    cqr2::gram_accumulate<T>(ti == tj ? Xj : Xi, Xj, acc);
    __syncthreads();
  }
  float* out = part + ((long long)b * gridDim.y + sp) * split * n;
  cross::store_rect<T>(out, split, n, ti, tj, acc);
}

template <typename S, int T>
cudaError_t launch(const S* a, float* part, float* s, int batch, int m, int n, int split,
                   long long lda, long long a_bs, int rows_per_split, int splits,
                   cudaStream_t stream) {
  const int ni = (split + T - 1) / T, nj = (n + T - 1) / T;
  const dim3 grid(ni * nj, splits, batch);
  cross_partial_kernel<S, T>
      <<<grid, cqr2::kThreads, 0, stream>>>(a, part, m, n, split, lda, a_bs, rows_per_split);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return cross::launch_fold_rect(part, s, batch, splits, split, n, stream);
}

template <typename S>
cudaError_t dispatch(const S* a, float* part, float* s, int batch, int m, int n, int split,
                     long long lda, long long a_bs, int rows_per_split, int splits,
                     cudaStream_t stream) {
  switch (cqr2::tile_for(n)) {
    case 32:
      return launch<S, 32>(a, part, s, batch, m, n, split, lda, a_bs, rows_per_split, splits,
                           stream);
    case 64:
      return launch<S, 64>(a, part, s, batch, m, n, split, lda, a_bs, rows_per_split, splits,
                           stream);
    default:
      return launch<S, 128>(a, part, s, batch, m, n, split, lda, a_bs, rows_per_split, splits,
                            stream);
  }
}

}  // namespace

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
    return dispatch(static_cast<const __nv_bfloat16*>(a), p, out, batch, m, n, split, lda, a_bs,
                    rows_per_split, splits, st);
  return dispatch(static_cast<const float*>(a), p, out, batch, m, n, split, lda, a_bs,
                  rows_per_split, splits, st);
}
