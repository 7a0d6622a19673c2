// Gram matrix G = A^T A of a batch of tall-skinny blocks, f32 accumulation.
//
// Replaces the TPU kernel src/repro/kernels/gram.py:gram (_gram_kernel) and
// its Pallas-Triton lowering in src/repro/kernels/gpu.py:gram.
//
// What bounds it on an H100: at the main path's widths it is f32-FMA bound
// from n = 128 up (G is symmetric, so m n (n + 1) operations against 4 m n
// bytes: 32 flop/byte at n = 128, against the card's ~20 flop/byte balance
// without tensor cores) and memory bound at n = 32 (8 flop/byte).  TF32
// tensor cores are not used: CholeskyQR squares kappa(A), so f32 stays f32.
//
// Design.  The TPU kernel accumulates into one output block that a
// sequential grid revisits; on Hopper's parallel grid that is a race.  Here
// the rows are split over CTAs (grid.y), each CTA streams its rows in
// 32-row chunks through shared memory and keeps one output tile of at most
// 128 x 128 in registers (8 x 8 per thread), so n up to 512 fits however
// large the Gram.  Only the upper-triangle tiles are computed (grid.x).
// Each CTA writes an f32 partial per split; fold_partials sums the splits
// in index order and mirrors the triangle.  No atomics: every run gives
// the same bits.  Ragged row tiles are masked while loading; no padded copy
// of A is made.  bf16 inputs are converted to f32 on load.
#include "cqr2_tiles.cuh"

namespace {

template <typename S, int T>
__global__ void __launch_bounds__(cqr2::kThreads)
    gram_partial_kernel(const S* __restrict__ a, float* __restrict__ part, int m, int n,
                        int rows_per_split) {
  __shared__ __align__(16) float Xi[cqr2::kRows][T];
  __shared__ __align__(16) float Xj[cqr2::kRows][T];
  const int nt = (n + T - 1) / T;
  int ti, tj;
  cqr2::tile_pair(blockIdx.x, nt, ti, tj);
  const int split = blockIdx.y, b = blockIdx.z;
  const S* src = a + (long long)b * m * n;
  const int r_begin = split * rows_per_split;
  const int r_end = min(m, r_begin + rows_per_split);

  float acc[T / 16][T / 16];
#pragma unroll
  for (int i = 0; i < T / 16; ++i)
#pragma unroll
    for (int j = 0; j < T / 16; ++j) acc[i][j] = 0.0f;

  for (int r0 = r_begin; r0 < r_end; r0 += cqr2::kRows) {
    cqr2::load_tile<S, T>(Xi, src, r_end, n, r0, ti * T);
    if (ti != tj) cqr2::load_tile<S, T>(Xj, src, r_end, n, r0, tj * T);
    __syncthreads();
    cqr2::gram_accumulate<T>(Xi, ti == tj ? Xi : Xj, acc);
    __syncthreads();
  }
  float* out = part + ((long long)b * gridDim.y + split) * n * n;
  cqr2::store_partial<T>(out, n, ti, tj, acc);
}

template <typename S, int T>
cudaError_t launch(const S* a, float* part, float* g, int batch, int m, int n,
                   int rows_per_split, int splits, cudaStream_t stream) {
  const int nt = (n + T - 1) / T;
  const dim3 grid(nt * (nt + 1) / 2, splits, batch);
  gram_partial_kernel<S, T><<<grid, cqr2::kThreads, 0, stream>>>(a, part, m, n, rows_per_split);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return cqr2::launch_fold(part, g, batch, splits, n, stream);
}

template <typename S>
cudaError_t dispatch(const S* a, float* part, float* g, int batch, int m, int n,
                     int rows_per_split, int splits, cudaStream_t stream) {
  switch (cqr2::tile_for(n)) {
    case 32: return launch<S, 32>(a, part, g, batch, m, n, rows_per_split, splits, stream);
    case 64: return launch<S, 64>(a, part, g, batch, m, n, rows_per_split, splits, stream);
    default: return launch<S, 128>(a, part, g, batch, m, n, rows_per_split, splits, stream);
  }
}

}  // namespace

// a: (batch, m, n) f32 or bf16; part: (batch, splits, n, n) f32 scratch;
// g: (batch, n, n) f32.  Split s covers rows [s * rows_per_split, ...).
// Returns the launch's cudaError_t.
extern "C" int repro_gram(const void* a, void* part, void* g, int is_bf16, int batch, int m,
                          int n, int rows_per_split, int splits, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  float* out = static_cast<float*>(g);
  if (is_bf16)
    return dispatch(static_cast<const __nv_bfloat16*>(a), p, out, batch, m, n, rows_per_split,
                    splits, st);
  return dispatch(static_cast<const float*>(a), p, out, batch, m, n, rows_per_split, splits, st);
}
