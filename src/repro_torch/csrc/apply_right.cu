// Panel right-multiply Q = A.W, f32 accumulation, result in A's storage type.
//
// Replaces the TPU kernel src/repro/kernels/apply_right.py:apply_right
// (_apply_kernel) and its Pallas-Triton lowering in
// src/repro/kernels/gpu.py:apply_right.
//
// What bounds it on an H100: f32 FMAs at the main path's widths.  It does
// 2 m n k operations against 4 m (n + k) bytes: 32 flop/byte at
// n = k = 128, above the card's ~20 flop/byte balance without tensor cores;
// at n = k = 32 it is memory bound (8 flop/byte).  f32 stays f32 (no TF32).
//
// Design.  A map kernel: the grid is row blocks of 128 rows (grid.x) by
// column tiles of Q (grid.y) by batch (grid.z), so each output element is
// written exactly once and no CTA depends on another.  A row block streams
// in 32-row chunks through apply_chunk, the same device function the fused
// kernel uses, so Q's bits equal the fused kernel's.  W is re-read per row
// block from L2 (at most 1 MiB).  Ragged rows and columns are masked; no
// padded copy is made.  k may differ from n.
#include "cqr2_tiles.cuh"

namespace {

constexpr int kBlockRows = 4 * cqr2::kRows;

// Two CTAs per SM: with the staging prefetch the compiler otherwise takes
// ~145 registers a thread at T = 128, which leaves one CTA per SM.
template <typename S, int T>
__global__ void __launch_bounds__(cqr2::kThreads, 2)
    apply_kernel(const S* __restrict__ a, const S* __restrict__ w, S* __restrict__ q, int m,
                 int n, int k) {
  __shared__ __align__(16) float As[cqr2::kRows][cqr2::kDepth];
  __shared__ __align__(16) float Ws[cqr2::kDepth][T];
  constexpr int TPC = cqr2::kThreads / T;
  const int b = blockIdx.z, c0 = blockIdx.y * T;
  const S* ab = a + (long long)b * m * n;
  const S* wb = w + (long long)b * n * k;
  S* qb = q + (long long)b * m * k;
  const int c = threadIdx.x % T, rbase = threadIdx.x / T;
  const int gc = c0 + c;
  const int r_end = min(m, (int)blockIdx.x * kBlockRows + kBlockRows);
  float vals[cqr2::kRows * T / cqr2::kThreads];
  for (int r0 = blockIdx.x * kBlockRows; r0 < r_end; r0 += cqr2::kRows) {
    cqr2::apply_chunk<S, T>(ab, wb, m, n, k, r0, c0, As, Ws, vals);
#pragma unroll
    for (int e = 0; e < cqr2::kRows * T / cqr2::kThreads; ++e) {
      const int gr = r0 + rbase + TPC * e;
      if (gr < r_end && gc < k) qb[(long long)gr * k + gc] = cqr2::from_f32<S>(vals[e]);
    }
  }
}

template <typename S, int T>
cudaError_t launch(const S* a, const S* w, S* q, int batch, int m, int n, int k,
                   cudaStream_t stream) {
  const dim3 grid((m + kBlockRows - 1) / kBlockRows, (k + T - 1) / T, batch);
  apply_kernel<S, T><<<grid, cqr2::kThreads, 0, stream>>>(a, w, q, m, n, k);
  return cudaGetLastError();
}

template <typename S>
cudaError_t dispatch(const S* a, const S* w, S* q, int batch, int m, int n, int k,
                     cudaStream_t stream) {
  switch (cqr2::tile_for(k)) {
    case 32: return launch<S, 32>(a, w, q, batch, m, n, k, stream);
    case 64: return launch<S, 64>(a, w, q, batch, m, n, k, stream);
    default: return launch<S, 128>(a, w, q, batch, m, n, k, stream);
  }
}

}  // namespace

// a: (batch, m, n); w: (batch, n, k); q: (batch, m, k); one storage type
// (f32 or bf16) for all three.  Returns the launch's cudaError_t.
extern "C" int repro_apply_right(const void* a, const void* w, void* q, int is_bf16, int batch,
                                 int m, int n, int k, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch(static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(w),
                    static_cast<__nv_bfloat16*>(q), batch, m, n, k, st);
  return dispatch(static_cast<const float*>(a), static_cast<const float*>(w),
                  static_cast<float*>(q), batch, m, n, k, st);
}
