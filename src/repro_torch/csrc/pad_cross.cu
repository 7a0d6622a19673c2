// Fixed-shape blocked-QR prime: widen A to out_width with exact-zero columns
// and compute S = A_pad[:, :split]^T A_pad of the widened copy, in one sweep
// over A.
//
// Replaces the TPU kernel src/repro/kernels/trailing_update.py:pad_cross
// (_pad_cross_kernel) and its Pallas-Triton lowering in
// src/repro/kernels/gpu.py:pad_cross.
//
// What bounds it on an H100: f32 FMAs.  The real columns need the same
// m split (split + 1) + 2 m split (n - split) operations as panel_cross,
// against 4 m n bytes read and 4 m out_width written: 31 flop/byte at
// split = 128, n = 480, out_width = 512, above the card's ~20 flop/byte
// balance without tensor cores.
//
// Design.  panel_cross.cu's grid and arithmetic with the column tiles taken
// over out_width: loads mask columns >= n to zero, which is both the pad of
// A_pad and the pad columns of S (exact zeros for finite A).  The CTAs of S
// row tile 0 write their column tile of A_pad for their split's rows, from
// the same loads, so every A_pad element is written once and A is read
// once.  The row split is _launch.cross_split's, a function of (batch, m)
// only, so S's real columns equal panel_cross(A) bit for bit.
#include "cross_tiles.cuh"

namespace {

// X[r][c] = A[r0 + r][c0 + c] (zero at columns >= n), also stored into
// A_pad when `write` is set.
template <typename S, int T>
__device__ __forceinline__ void load_pad(float (*X)[T], const S* src, S* dst, int rows, int n,
                                         int out_width, long long lda, int r0, int c0,
                                         bool write) {
  for (int e = threadIdx.x; e < cqr2::kRows * T; e += cqr2::kThreads) {
    const int r = e / T, c = e % T;
    const int gr = r0 + r, gc = c0 + c;
    const bool row_in = gr < rows;
    const S v = (row_in && gc < n) ? src[(long long)gr * lda + gc] : cqr2::from_f32<S>(0.0f);
    if (write && row_in && gc < out_width) dst[(long long)gr * out_width + gc] = v;
    X[r][c] = row_in ? cqr2::to_f32(v) : 0.0f;
  }
}

template <typename S, int T>
__global__ void __launch_bounds__(cqr2::kThreads)
    pad_cross_kernel(const S* __restrict__ a, S* __restrict__ apad, float* __restrict__ part,
                     int m, int n, int split, int out_width, long long lda, long long a_bs,
                     int rows_per_split) {
  __shared__ __align__(16) float Xi[cqr2::kRows][T];
  __shared__ __align__(16) float Xj[cqr2::kRows][T];
  const int nj = (out_width + T - 1) / T;
  const int ti = blockIdx.x / nj, tj = blockIdx.x % nj;
  const int sp = blockIdx.y, b = blockIdx.z;
  const S* src = a + (long long)b * a_bs;
  S* dst = apad + (long long)b * m * out_width;
  const int r_begin = sp * rows_per_split;
  const int r_end = min(m, r_begin + rows_per_split);

  float acc[T / 16][T / 16];
  cross::zero_acc<T>(acc);
  for (int r0 = r_begin; r0 < r_end; r0 += cqr2::kRows) {
    load_pad<S, T>(Xj, src, dst, r_end, n, out_width, lda, r0, tj * T, ti == 0);
    if (ti != tj) load_pad<S, T>(Xi, src, dst, r_end, n, out_width, lda, r0, ti * T, false);
    __syncthreads();
    cqr2::gram_accumulate<T>(ti == tj ? Xj : Xi, Xj, acc);
    __syncthreads();
  }
  float* out = part + ((long long)b * gridDim.y + sp) * split * out_width;
  cross::store_rect<T>(out, split, out_width, ti, tj, acc);
}

template <typename S, int T>
cudaError_t launch(const S* a, S* apad, float* part, float* s, int batch, int m, int n,
                   int split, int out_width, long long lda, long long a_bs, int rows_per_split,
                   int splits, cudaStream_t stream) {
  const int ni = (split + T - 1) / T, nj = (out_width + T - 1) / T;
  const dim3 grid(ni * nj, splits, batch);
  pad_cross_kernel<S, T><<<grid, cqr2::kThreads, 0, stream>>>(a, apad, part, m, n, split,
                                                              out_width, lda, a_bs,
                                                              rows_per_split);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return cross::launch_fold_rect(part, s, batch, splits, split, out_width, stream);
}

template <typename S>
cudaError_t dispatch(const S* a, S* apad, float* part, float* s, int batch, int m, int n,
                     int split, int out_width, long long lda, long long a_bs, int rows_per_split,
                     int splits, cudaStream_t stream) {
  switch (cqr2::tile_for(out_width)) {
    case 32:
      return launch<S, 32>(a, apad, part, s, batch, m, n, split, out_width, lda, a_bs,
                           rows_per_split, splits, stream);
    case 64:
      return launch<S, 64>(a, apad, part, s, batch, m, n, split, out_width, lda, a_bs,
                           rows_per_split, splits, stream);
    default:
      return launch<S, 128>(a, apad, part, s, batch, m, n, split, out_width, lda, a_bs,
                            rows_per_split, splits, stream);
  }
}

}  // namespace

// a: (batch, m, n) with row stride lda and batch stride a_bs (elements);
// apad: (batch, m, out_width) contiguous, same storage type as a;
// part: (batch, splits, split, out_width) f32 scratch; s: (batch, split,
// out_width) f32.  Returns the launch's cudaError_t.
extern "C" int repro_pad_cross(const void* a, void* apad, void* part, void* s, int is_bf16,
                               int batch, int m, int n, int split, int out_width, long long lda,
                               long long a_bs, int rows_per_split, int splits, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  float* out = static_cast<float*>(s);
  if (is_bf16)
    return dispatch(static_cast<const __nv_bfloat16*>(a), static_cast<__nv_bfloat16*>(apad), p,
                    out, batch, m, n, split, out_width, lda, a_bs, rows_per_split, splits, st);
  return dispatch(static_cast<const float*>(a), static_cast<float*>(apad), p, out, batch, m, n,
                  split, out_width, lda, a_bs, rows_per_split, splits, st);
}
