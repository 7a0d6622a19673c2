// Gram-combine of two square factors, G = R1^T R1 + R2^T R2, f32 accumulation.
//
// Replaces the TPU kernel src/repro/kernels/combine_gram.py:combine_gram
// (_combine_kernel), the Gram-butterfly's combine of two R factors.  The
// inputs are general (n x n) matrices, not only triangular ones, as in the
// reference.
//
// What bounds it on an H100: two symmetric n x n Grams, n^2 (n + 1) operations
// each, plus n^2 adds, against 3 n^2 * 4 bytes: about n / 6 operations a byte,
// so f32-FMA bound from n of about 128 up (the card balances near 20 without
// tensor cores).  TF32 tensor cores are not used: the combined Gram feeds a
// Cholesky, which squares the condition number.
//
// Design.  One CTA per (matrix, upper-triangle output tile) with T x T tiles
// (T = 32 up to n = 32, else 64), 4 x 4 (or 2 x 2) outputs per thread.  Every
// element is two in-order __fmaf_rn chains over k, one over R1's rows and
// one over R2's, streamed in 32-row chunks through shared memory with
// cqr2_tiles.cuh's load_tile / gram_accumulate, and a single rounded add of
// the two; the value is written to (i, j) and (j, i), so G is exactly
// symmetric.  n <= 512 needs no split over k: no partials, no fold, no
// atomics, and every run gives the same bits.  Ragged tiles are masked while
// loading.  bf16 inputs are converted to f32 on load.
#include "cqr2_tiles.cuh"

namespace {

template <typename S, int T>
__device__ __forceinline__ void chain(float (*Xi)[T], float (*Xj)[T], const S* src, int n,
                                      int ti, int tj, float (&acc)[T / 16][T / 16]) {
#pragma unroll
  for (int i = 0; i < T / 16; ++i)
#pragma unroll
    for (int j = 0; j < T / 16; ++j) acc[i][j] = 0.0f;
  for (int r0 = 0; r0 < n; r0 += cqr2::kRows) {
    cqr2::load_tile<S, T>(Xi, src, n, n, r0, ti * T);
    if (ti != tj) cqr2::load_tile<S, T>(Xj, src, n, n, r0, tj * T);
    __syncthreads();
    cqr2::gram_accumulate<T>(Xi, ti == tj ? Xi : Xj, acc);
    __syncthreads();
  }
}

template <typename S, int T>
__global__ void __launch_bounds__(cqr2::kThreads)
    combine_gram_kernel(const S* __restrict__ r1, const S* __restrict__ r2,
                        float* __restrict__ g, int n) {
  __shared__ __align__(16) float Xi[cqr2::kRows][T];
  __shared__ __align__(16) float Xj[cqr2::kRows][T];
  constexpr int MT = T / 16;
  const int nt = (n + T - 1) / T;
  int ti, tj;
  cqr2::tile_pair(blockIdx.x, nt, ti, tj);
  const long long off = (long long)blockIdx.y * n * n;
  float acc1[MT][MT], acc2[MT][MT];
  chain<S, T>(Xi, Xj, r1 + off, n, ti, tj, acc1);
  chain<S, T>(Xi, Xj, r2 + off, n, ti, tj, acc2);
  float* out = g + off;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int a = 0; a < MT; ++a) {
    const int i = ti * T + ty + 16 * a;
#pragma unroll
    for (int b = 0; b < MT; ++b) {
      const int j = tj * T + tx + 16 * b;
      // a diagonal tile's lower half is its upper half's mirror
      if (i < n && j < n && (ti != tj || i <= j)) {
        const float v = __fadd_rn(acc1[a][b], acc2[a][b]);
        out[(long long)i * n + j] = v;
        out[(long long)j * n + i] = v;
      }
    }
  }
}

template <typename S, int T>
cudaError_t launch(const S* r1, const S* r2, float* g, int batch, int n, cudaStream_t stream) {
  const int nt = (n + T - 1) / T;
  const dim3 grid(nt * (nt + 1) / 2, batch);
  combine_gram_kernel<S, T><<<grid, cqr2::kThreads, 0, stream>>>(r1, r2, g, n);
  return cudaGetLastError();
}

template <typename S>
cudaError_t dispatch(const S* r1, const S* r2, float* g, int batch, int n,
                     cudaStream_t stream) {
  if (n <= 32) return launch<S, 32>(r1, r2, g, batch, n, stream);
  return launch<S, 64>(r1, r2, g, batch, n, stream);
}

}  // namespace

// r1, r2: (batch, n, n) f32 or bf16, contiguous; g: (batch, n, n) f32.
// Returns the launch's cudaError_t.
extern "C" int repro_combine_gram(const void* r1, const void* r2, void* g, int is_bf16,
                                  int batch, int n, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(g);
  if (is_bf16)
    return dispatch(static_cast<const __nv_bfloat16*>(r1), static_cast<const __nv_bfloat16*>(r2),
                    out, batch, n, st);
  return dispatch(static_cast<const float*>(r1), static_cast<const float*>(r2), out, batch, n,
                  st);
}
