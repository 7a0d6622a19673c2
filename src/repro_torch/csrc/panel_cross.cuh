// The cross sweep of a batch of tall blocks, f32 accumulation: one CTA's
// tile of X^T X over one row split, shared by panel_cross.cu (the blocked
// QR's prime S = A[:, :split]^T A), trailing_update.cu (the lookahead S of
// the stored A_new), gram.cu (G = A^T A on the upper-triangle tile pairs)
// and pad_cross.cu (S of A widened by zero columns, writing A_pad from the
// staged chunks).  Each of them keeps its own __global__ entry around
// sweep() and enumerates its own tiles; a template flag (kSkip) skips the
// blocks below a Gram's diagonal and a functor (on_chunk) adds pad_cross's
// write.
//
// Arithmetic: each partial entry is one f32 register summed with __fmaf_rn
// over its split's rows in row order, the chunks' zero-filled rows past
// the split's end included.  The cross kernels split the rows by
// _launch.cross_split and fold with fold_rect (the contract of
// cross_tiles.cuh); gram splits by _launch.row_split and folds with
// cqr2::fold_partials (the contract of cqr2_tiles.cuh).  No atomics.
//
// Design.  Every (row tile I, column tile J, split, matrix) is a CTA of 256
// threads with a 128 x 128 tile (at widths > 64), 8 x 8 a thread.  A
// thread's rows and columns come in groups of four consecutive indices
// (4t..4t+3 and 64+4t.., cqr2::Axis), so one row of a chunk costs four
// 128-bit shared reads for 64 FMAs; the reads of the I tile are
// broadcasts.  The split's rows stream through a ring of kStages chunks of
// kChunk rows, copied with cp.async (16 bytes where the base and strides
// allow it, else 4, zero-filled through the source size past the split's
// last row and A's last column), so the copies of the next kStages - 1
// chunks are in flight while one chunk's FMAs run: one barrier per chunk.
// The diagonal CTA (I = J) stages one tile and reads it twice; for a Gram
// it also skips the 4 x 4 blocks of the lower 64 x 64 quadrant (48 FMAs a
// row for 64 at T = 128).  The ring takes 96 KiB, and __launch_bounds__
// keeps two CTAs on an SM (128 registers).  Measured on an H100, 32-row
// chunks beat 16 (half the barriers) and a full unroll of the chunk
// overflowed the instruction cache.  A's rows may be strided (a column
// slice of a wider matrix goes in without a copy); bf16 is staged raw and
// converted on the shared read.
#pragma once

#include "async_tiles.cuh"
#include "cross_tiles.cuh"

namespace cross {

constexpr int kChunk = 32;  // rows of one staged chunk
constexpr int kStages = 3;  // chunks in the ring

// Stage rows [r0, r0 + kChunk) and columns [c0, c0 + T) of src into X
// (kChunk x T), zero outside rows < r_end and columns < n.
template <typename S, int T, int CPE>
__device__ __forceinline__ void stage(S* X, const S* src, int r0, int r_end, int n,
                                      long long lda, int c0) {
  constexpr int kPerRow = T / CPE;
  for (int e = threadIdx.x; e < kChunk * kPerRow; e += cqr2::kThreads) {
    const int r = e / kPerRow, c = (e % kPerRow) * CPE;
    const int gr = r0 + r, gc = c0 + c;
    const int valid = gr < r_end ? max(0, min(CPE, n - gc)) : 0;
    tiles::copy<S, CPE>(X + r * T + c, valid ? src + gr * lda + gc : src, valid);
  }
}

// The row sweep of one CTA: acc[i][j] = sum over rows r of its split, in
// order, of X[r][ti * T + X::index(ty, i)] * X[r][tj * T + X::index(tx, j)]
// with X = A zero outside rows < r_end and columns < n.  kSkip (a diagonal
// tile, ti == tj) leaves out the G x G blocks below the diagonal (i / G >
// j / G), whose entries no caller reads; their acc stays zero.  After
// chunk c has landed, every thread calls on_chunk(tile, r0) with the
// staged (kChunk x T) chunk of column tile tj at rows r0.. (zero-filled),
// before the chunk's FMAs: pad_cross writes A_pad from it.
template <typename S, int T, int CPE, bool kSkip, typename OnChunk>
__device__ __forceinline__ void sweep(const S* src, int r_begin, int r_end, int n, long long lda,
                                      int ti, int tj, float (&acc)[T / 16][T / 16],
                                      OnChunk&& on_chunk) {
  using X = cqr2::Axis<T>;
  constexpr int MT = X::MT, G = X::G;
  extern __shared__ __align__(16) unsigned char smem[];
  S(*ring)[2][kChunk * T] = reinterpret_cast<S(*)[2][kChunk * T]>(smem);  // [kStages]
  const bool diag = ti == tj;
  const int chunks = (r_end - r_begin + kChunk - 1) / kChunk;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  auto issue = [&](int c) {
    if (c < chunks) {
      const int r0 = r_begin + c * kChunk;
      stage<S, T, CPE>(ring[c % kStages][0], src, r0, r_end, n, lda, tj * T);
      if (!diag) stage<S, T, CPE>(ring[c % kStages][1], src, r0, r_end, n, lda, ti * T);
    }
    tiles::commit();
  };

#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < MT; ++j) acc[i][j] = 0.0f;

#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) issue(c);
  for (int c = 0; c < chunks; ++c) {
    tiles::wait<kStages - 2>();
    __syncthreads();             // chunk c is visible; chunk c - 1's stage is free
    issue(c + kStages - 1);
    const S* xj_tile = ring[c % kStages][0];
    const S* xi_tile = diag ? xj_tile : ring[c % kStages][1];
    on_chunk(xj_tile, r_begin + c * kChunk);
#pragma unroll 8  // a full unroll outgrows the instruction cache
    for (int r = 0; r < kChunk; ++r) {
      float xi[MT], xj[MT];
#pragma unroll
      for (int g = 0; g < MT / G; ++g) {
        tiles::read<G>(xi_tile + r * T + X::index(ty, g * G), xi + g * G);
        tiles::read<G>(xj_tile + r * T + X::index(tx, g * G), xj + g * G);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < MT; ++j)
          if (!kSkip || i / G <= j / G) acc[i][j] = __fmaf_rn(xi[i], xj[j], acc[i][j]);
    }
  }
  tiles::wait<0>();
}

struct NoHook {
  template <typename S>
  __device__ __forceinline__ void operator()(const S*, int) const {}
};

// Write acc of tile (ti, tj) into a (rows x cols) row-major partial: the
// entries inside it and, with kUpper, only those on or above the diagonal
// (all that fold_partials reads).
template <int T, bool kUpper = false>
__device__ __forceinline__ void store(float* out, int rows, int cols, int ti, int tj,
                                      const float (&acc)[T / 16][T / 16]) {
  using X = cqr2::Axis<T>;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < X::MT; ++i) {
    const int gi = ti * T + X::index(ty, i);
    if (gi >= rows) continue;
#pragma unroll
    for (int j = 0; j < X::MT; ++j) {
      const int gj = tj * T + X::index(tx, j);
      if (gj < cols && (!kUpper || gi <= gj)) out[(long long)gi * cols + gj] = acc[i][j];
    }
  }
}

template <typename S, int T, int CPE>
__global__ void __launch_bounds__(cqr2::kThreads, 2)
    cross_partial_kernel(const S* __restrict__ a, float* __restrict__ part, int m, int n,
                         int split, long long lda, long long a_bs, int rows_per_split) {
  const int nj = (n + T - 1) / T;
  const int ti = blockIdx.x / nj, tj = blockIdx.x % nj;
  const int sp = blockIdx.y, b = blockIdx.z;
  const int r_begin = sp * rows_per_split;
  float acc[T / 16][T / 16];
  sweep<S, T, CPE, false>(a + (long long)b * a_bs, r_begin, min(m, r_begin + rows_per_split), n,
                          lda, ti, tj, acc, NoHook{});
  store<T>(part + ((long long)b * gridDim.y + sp) * split * n, split, n, ti, tj, acc);
}

// Dynamic shared memory of one sweep CTA: the ring of two staged tiles.
template <typename S, int T>
constexpr int kSweepSmem = kStages * 2 * kChunk * T * (int)sizeof(S);

template <typename S, int T, int CPE>
cudaError_t cross_launch(const S* a, float* part, float* s, int batch, int m, int n,
                         int split, long long lda, long long a_bs, int rows_per_split,
                         int splits, cudaStream_t stream) {
  const int ni = (split + T - 1) / T, nj = (n + T - 1) / T;
  const dim3 grid(ni * nj, splits, batch);
  constexpr int smem = kSweepSmem<S, T>;
  cudaError_t err = cudaFuncSetAttribute(cross_partial_kernel<S, T, CPE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cross_partial_kernel<S, T, CPE>
      <<<grid, cqr2::kThreads, smem, stream>>>(a, part, m, n, split, lda, a_bs, rows_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_fold_rect(part, s, batch, splits, split, n, stream);
}

template <typename S, int T>
cudaError_t cross_by_copy(const S* a, float* part, float* s, int batch, int m, int n,
                          int split, long long lda, long long a_bs, int rows_per_split,
                          int splits, cudaStream_t stream) {
  return tiles::by_copy(a, lda, a_bs, batch, [&](auto cpe) {
    return cross_launch<S, T, decltype(cpe)::value>(a, part, s, batch, m, n, split, lda, a_bs,
                                                    rows_per_split, splits, stream);
  });
}

// S = A[:, :split]^T A over a strided (batch, m, n) operand: the partials
// into part (batch, splits, split, n) and their fold into s (batch, split,
// n).  Returns the first launch error.
template <typename S>
cudaError_t panel_cross(const S* a, float* part, float* s, int batch, int m, int n, int split,
                        long long lda, long long a_bs, int rows_per_split, int splits,
                        cudaStream_t stream) {
  switch (cqr2::tile_for(n)) {
    case 32:
      return cross_by_copy<S, 32>(a, part, s, batch, m, n, split, lda, a_bs,
                                  rows_per_split, splits, stream);
    case 64:
      return cross_by_copy<S, 64>(a, part, s, batch, m, n, split, lda, a_bs,
                                  rows_per_split, splits, stream);
    default:
      return cross_by_copy<S, 128>(a, part, s, batch, m, n, split, lda, a_bs,
                                   rows_per_split, splits, stream);
  }
}

}  // namespace cross
