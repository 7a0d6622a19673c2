// Fused panel apply + next-round Gram: Q = A.W and G' = Q^T Q of the cast Q,
// in one sweep over A.
//
// Replaces the TPU kernel src/repro/kernels/fused_apply_gram.py:
// fused_apply_gram (_fused_kernel) and its Pallas-Triton lowering in
// src/repro/kernels/gpu.py:fused_apply_gram.
//
// What bounds it on an H100: f32 FMAs.  It needs 2 m n k operations for the
// apply and m k (k + 1) for the symmetric Gram against 4 m n bytes of A:
// 96 flop/byte at n = k = 128, far above the card's ~20 flop/byte balance
// without tensor cores.  f32 stays f32 (no TF32): CholeskyQR squares kappa(A).
//
// Design.  The grid is the same as gram.cu's: upper-triangle (I, J) tiles of
// G' (grid.x) by row splits (grid.y) by batch (grid.z).  Per 32-row chunk a
// CTA computes the Q columns of tiles I and J with apply_chunk (A and W
// staged through shared memory, f32 FMAs in l order), casts them to the
// storage type exactly as a stored Q would be, and feeds the cast values to
// the same gram_accumulate as gram.cu.  With want_q the diagonal CTAs
// (I == J) write their Q tile, so every Q element is written once; without
// it Q never reaches device memory.  Because the Q bits equal
// apply_right's, the row split equals gram's for the same (batch, m, k),
// and the partials fold in the same order, G' equals
// gram(apply_right(A, W)) bit for bit, with or without want_q.  Tiles off
// the diagonal recompute their Q columns: at k <= 128 there is one tile and
// nothing is recomputed.
#include "cqr2_tiles.cuh"

namespace {

template <typename S, int T>
__device__ __forceinline__ void cast_chunk(float (*X)[T], S* q, int m, int k, int r0, int c0,
                                           const float (&vals)[cqr2::kRows * T / cqr2::kThreads],
                                           bool write_q) {
  constexpr int TPC = cqr2::kThreads / T;
  const int c = threadIdx.x % T, rbase = threadIdx.x / T;
  const int gc = c0 + c;
#pragma unroll
  for (int e = 0; e < cqr2::kRows * T / cqr2::kThreads; ++e) {
    const int r = rbase + TPC * e;
    const int gr = r0 + r;
    const bool inside = gr < m && gc < k;
    const S stored = cqr2::from_f32<S>(vals[e]);
    if (write_q && inside) q[(long long)gr * k + gc] = stored;
    X[r][c] = inside ? cqr2::to_f32(stored) : 0.0f;
  }
}

// Two CTAs per SM: at T = 128 the compiler otherwise takes ~200 registers a
// thread and one CTA of 8 warps cannot hide the staging loads.
template <typename S, int T>
__global__ void __launch_bounds__(cqr2::kThreads, 2)
    fused_partial_kernel(const S* __restrict__ a, const S* __restrict__ w, S* __restrict__ q,
                         float* __restrict__ part, int m, int n, int k, int rows_per_split) {
  __shared__ __align__(16) float Xi[cqr2::kRows][T];
  __shared__ __align__(16) float Xj[cqr2::kRows][T];
  __shared__ __align__(16) float As[cqr2::kRows][cqr2::kDepth];
  __shared__ __align__(16) float Ws[cqr2::kDepth][T];
  const int nt = (k + T - 1) / T;
  int ti, tj;
  cqr2::tile_pair(blockIdx.x, nt, ti, tj);
  const int split = blockIdx.y, b = blockIdx.z;
  const S* ab = a + (long long)b * m * n;
  const S* wb = w + (long long)b * n * k;
  S* qb = q ? q + (long long)b * m * k : nullptr;
  const int r_begin = split * rows_per_split;
  const int r_end = min(m, r_begin + rows_per_split);

  float acc[T / 16][T / 16];
#pragma unroll
  for (int i = 0; i < T / 16; ++i)
#pragma unroll
    for (int j = 0; j < T / 16; ++j) acc[i][j] = 0.0f;

  float vals[cqr2::kRows * T / cqr2::kThreads];
  for (int r0 = r_begin; r0 < r_end; r0 += cqr2::kRows) {
    cqr2::apply_chunk<S, T>(ab, wb, r_end, n, k, r0, ti * T, As, Ws, vals);
    cast_chunk<S, T>(Xi, qb, r_end, k, r0, ti * T, vals, qb != nullptr && ti == tj);
    if (ti != tj) {
      cqr2::apply_chunk<S, T>(ab, wb, r_end, n, k, r0, tj * T, As, Ws, vals);
      cast_chunk<S, T>(Xj, qb, r_end, k, r0, tj * T, vals, false);
    }
    __syncthreads();
    cqr2::gram_accumulate<T>(Xi, ti == tj ? Xi : Xj, acc);
    __syncthreads();
  }
  float* out = part + ((long long)b * gridDim.y + split) * k * k;
  cqr2::store_partial<T>(out, k, ti, tj, acc);
}

template <typename S, int T>
cudaError_t launch(const S* a, const S* w, S* q, float* part, float* g, int batch, int m, int n,
                   int k, int rows_per_split, int splits, cudaStream_t stream) {
  const int nt = (k + T - 1) / T;
  const dim3 grid(nt * (nt + 1) / 2, splits, batch);
  fused_partial_kernel<S, T>
      <<<grid, cqr2::kThreads, 0, stream>>>(a, w, q, part, m, n, k, rows_per_split);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return cqr2::launch_fold(part, g, batch, splits, k, stream);
}

template <typename S>
cudaError_t dispatch(const S* a, const S* w, S* q, float* part, float* g, int batch, int m,
                     int n, int k, int rows_per_split, int splits, cudaStream_t stream) {
  switch (cqr2::tile_for(k)) {
    case 32:
      return launch<S, 32>(a, w, q, part, g, batch, m, n, k, rows_per_split, splits, stream);
    case 64:
      return launch<S, 64>(a, w, q, part, g, batch, m, n, k, rows_per_split, splits, stream);
    default:
      return launch<S, 128>(a, w, q, part, g, batch, m, n, k, rows_per_split, splits, stream);
  }
}

}  // namespace

// a: (batch, m, n); w: (batch, n, k); q: (batch, m, k) or null (no Q
// written); part: (batch, splits, k, k) f32 scratch; g: (batch, k, k) f32.
// a, w and q share one storage type (f32 or bf16).  Returns the launch's
// cudaError_t.
extern "C" int repro_fused_apply_gram(const void* a, const void* w, void* q, void* part, void* g,
                                      int is_bf16, int batch, int m, int n, int k,
                                      int rows_per_split, int splits, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  float* out = static_cast<float*>(g);
  if (is_bf16)
    return dispatch(static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(w),
                    static_cast<__nv_bfloat16*>(q), p, out, batch, m, n, k, rows_per_split,
                    splits, st);
  return dispatch(static_cast<const float*>(a), static_cast<const float*>(w),
                  static_cast<float*>(q), p, out, batch, m, n, k, rows_per_split, splits, st);
}
