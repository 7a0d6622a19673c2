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
// Arithmetic (the contract of cqr2_tiles.cuh): each entry of a split's
// partial is one f32 register summed with __fmaf_rn over the split's rows
// in row order; the rows are split by _launch.row_split (a function of
// (batch, m, n)), the splits folded in index order by fold_partials, which
// reads the upper triangle and mirrors it.  fused_apply_gram.cu keeps the
// same chain on the same split, so its G' equals gram(apply_right(A, W)).
// No atomics: every run gives the same bits.
//
// Design: panel_cross.cuh's sweep on the upper-triangle tile pairs (I <= J,
// grid.x) of every (split, matrix): a three-stage cp.async ring of 32-row
// chunks, zero-filled past the split's last row and A's last column, one
// barrier a chunk, 8 x 8 thread tiles read with 128-bit shared reads, two
// CTAs an SM.  A diagonal CTA stages one tile and skips the blocks below
// the diagonal; each CTA writes only the entries on or above it.  Widths
// up to 512 (ten tile pairs of 128) and ragged m are handled in the kernel
// with no padded copy; bf16 is staged raw and converted on the read.
#include "panel_cross.cuh"

namespace {

template <typename S, int T, int CPE>
__global__ void __launch_bounds__(cqr2::kThreads, 2)
    gram_partial_kernel(const S* __restrict__ a, float* __restrict__ part, int m, int n,
                        int rows_per_split) {
  int ti, tj;
  cqr2::tile_pair(blockIdx.x, (n + T - 1) / T, ti, tj);
  const int sp = blockIdx.y, b = blockIdx.z;
  const S* src = a + (long long)b * m * n;
  const int r_begin = sp * rows_per_split;
  const int r_end = min(m, r_begin + rows_per_split);
  float acc[T / 16][T / 16];
  if (ti == tj)
    cross::sweep<S, T, CPE, true>(src, r_begin, r_end, n, n, ti, tj, acc, cross::NoHook{});
  else
    cross::sweep<S, T, CPE, false>(src, r_begin, r_end, n, n, ti, tj, acc, cross::NoHook{});
  cross::store<T, true>(part + ((long long)b * gridDim.y + sp) * n * n, n, n, ti, tj, acc);
}

template <typename S, int T, int CPE>
cudaError_t launch(const S* a, float* part, float* g, int batch, int m, int n,
                   int rows_per_split, int splits, cudaStream_t stream) {
  const int nt = (n + T - 1) / T;
  const dim3 grid(nt * (nt + 1) / 2, splits, batch);
  constexpr int smem = cross::kSweepSmem<S, T>;
  cudaError_t err = cudaFuncSetAttribute(gram_partial_kernel<S, T, CPE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  gram_partial_kernel<S, T, CPE>
      <<<grid, cqr2::kThreads, smem, stream>>>(a, part, m, n, rows_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return cqr2::launch_fold(part, g, batch, splits, n, stream);
}

template <typename S, int T>
cudaError_t by_copy(const S* a, float* part, float* g, int batch, int m, int n,
                    int rows_per_split, int splits, cudaStream_t stream) {
  return tiles::by_copy(a, n, (long long)m * n, batch, [&](auto cpe) {
    return launch<S, T, decltype(cpe)::value>(a, part, g, batch, m, n, rows_per_split, splits,
                                              stream);
  });
}

template <typename S>
cudaError_t dispatch(const S* a, float* part, float* g, int batch, int m, int n,
                     int rows_per_split, int splits, cudaStream_t stream) {
  switch (cqr2::tile_for(n)) {
    case 32: return by_copy<S, 32>(a, part, g, batch, m, n, rows_per_split, splits, stream);
    case 64: return by_copy<S, 64>(a, part, g, batch, m, n, rows_per_split, splits, stream);
    default: return by_copy<S, 128>(a, part, g, batch, m, n, rows_per_split, splits, stream);
  }
}

}  // namespace

// a: (batch, m, n) f32 or bf16; part: (batch, splits, n, n) f32 scratch;
// g: (batch, n, n) f32.  Split s covers rows [s * rows_per_split, ...).
// Returns the first launch's cudaError_t.
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
