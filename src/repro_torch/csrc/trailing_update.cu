// One-sweep blocked-QR trailing update: A_new = A - Q.W in f32, cast to the
// storage type, and with next_width > 0 the lookahead
// S = A_new[:, :next_width]^T A_new of the cast rows in the same sweep.
//
// Replaces the TPU kernel src/repro/kernels/trailing_update.py:
// trailing_update (_update_kernel) and its Pallas-Triton lowering in
// src/repro/kernels/gpu.py:trailing_update.
//
// What bounds it on an H100: f32 FMAs.  At b = next_width = 128 and
// n_t = 384 it needs 2 m b n_t operations for the update, m b (b + 1) for
// the symmetric b x b block of S and 2 m b (n_t - b) for the rest, against
// 4 m (2 n_t + b) bytes: 52 flop/byte, far above the card's ~20 flop/byte
// balance without tensor cores.  Without S (next_width = 0) it is 2 m b n_t
// operations against the same bytes: 28 flop/byte, still operations-bound.
// f32 stays f32 (no TF32): S holds the next panel's Gram.
//
// Design.  The grid is (row tile I of S, column tile J of A_new) pairs
// (grid.x) by row splits (grid.y, _launch.cross_split: a function of
// (batch, m) only) by batch (grid.z).  Per 32-row chunk a CTA computes the
// update of column tile J with cqr2::apply_chunk (Q and W staged through
// shared memory, one in-order __fmaf_rn chain over l < b per element),
// subtracts it from A with one rounding, casts to the storage type and
// feeds the cast values to the same gram_accumulate as panel_cross.  The
// CTAs of S row tile 0 write their A_new tile, so every A_new element is
// written once; a CTA whose S row tile I differs from J recomputes the
// A_new columns of tile I by the same chain, so the bits agree, and does
// not write them.  S partials fold in split order (no atomics), so S equals
// panel_cross of the stored A_new bit for bit.  A is read and A_new is
// written through row strides: the blocked drivers pass the trailing block
// as a column slice, and the fixed-shape pipeline writes A_new into the
// leading columns of a wider buffer, with no copy.
#include "cross_tiles.cuh"

namespace {

// A_new for the thread's elements of the (kRows x T) chunk at (r0, c0):
// a - upd with one rounding, cast to S; stored to `out` when `write` is
// set, and staged as f32 of the cast value into X (zero outside the block).
template <typename S, int T>
__device__ __forceinline__ void update_chunk(float (*X)[T], const S* a, long long lda, S* out,
                                             long long ldo, int rows, int nt, int r0, int c0,
                                             const float (&upd)[cqr2::kRows * T / cqr2::kThreads],
                                             bool write) {
  constexpr int TPC = cqr2::kThreads / T;
  const int c = threadIdx.x % T, rbase = threadIdx.x / T;
  const int gc = c0 + c;
#pragma unroll
  for (int e = 0; e < cqr2::kRows * T / cqr2::kThreads; ++e) {
    const int r = rbase + TPC * e;
    const int gr = r0 + r;
    float v = 0.0f;
    if (gr < rows && gc < nt) {
      const S stored =
          cqr2::from_f32<S>(__fsub_rn(cqr2::to_f32(a[(long long)gr * lda + gc]), upd[e]));
      if (write) out[(long long)gr * ldo + gc] = stored;
      v = cqr2::to_f32(stored);
    }
    if (X) X[r][c] = v;
  }
}

// Two CTAs per SM, as fused_apply_gram.cu: the same apply-then-Gram body.
template <typename S, int T, bool WITH_S>
__global__ void __launch_bounds__(cqr2::kThreads, 2)
    trailing_kernel(const S* __restrict__ a, const S* __restrict__ q, const S* __restrict__ w,
                    S* __restrict__ out, float* __restrict__ part, int m, int b, int nt,
                    int next_width, long long lda, long long a_bs, long long ldo, long long o_bs,
                    int rows_per_split) {
  __shared__ __align__(16) float Xi[WITH_S ? cqr2::kRows : 1][T];
  __shared__ __align__(16) float Xj[WITH_S ? cqr2::kRows : 1][T];
  __shared__ __align__(16) float As[cqr2::kRows][cqr2::kDepth];
  __shared__ __align__(16) float Ws[cqr2::kDepth][T];
  const int nj = (nt + T - 1) / T;
  const int ti = WITH_S ? (int)blockIdx.x / nj : 0, tj = blockIdx.x % nj;
  const int sp = blockIdx.y, bb = blockIdx.z;
  const S* ab = a + (long long)bb * a_bs;
  const S* qb = q + (long long)bb * m * b;
  const S* wb = w + (long long)bb * b * nt;
  S* ob = out + (long long)bb * o_bs;
  const int r_begin = sp * rows_per_split;
  const int r_end = min(m, r_begin + rows_per_split);

  float acc[T / 16][T / 16];
  if (WITH_S) cross::zero_acc<T>(acc);
  float upd[cqr2::kRows * T / cqr2::kThreads];
  for (int r0 = r_begin; r0 < r_end; r0 += cqr2::kRows) {
    cqr2::apply_chunk<S, T>(qb, wb, r_end, b, nt, r0, tj * T, As, Ws, upd);
    update_chunk<S, T>(WITH_S ? Xj : nullptr, ab, lda, ob, ldo, r_end, nt, r0, tj * T, upd,
                       ti == 0);
    if (WITH_S) {
      if (ti != tj) {
        cqr2::apply_chunk<S, T>(qb, wb, r_end, b, nt, r0, ti * T, As, Ws, upd);
        update_chunk<S, T>(Xi, ab, lda, ob, ldo, r_end, nt, r0, ti * T, upd, false);
      }
      __syncthreads();
      cqr2::gram_accumulate<T>(ti == tj ? Xj : Xi, Xj, acc);
      __syncthreads();
    }
  }
  if (WITH_S) {
    float* dst = part + ((long long)bb * gridDim.y + sp) * next_width * nt;
    cross::store_rect<T>(dst, next_width, nt, ti, tj, acc);
  }
}

template <typename S, int T>
cudaError_t launch(const S* a, const S* q, const S* w, S* out, float* part, float* s, int batch,
                   int m, int b, int nt, int next_width, long long lda, long long a_bs,
                   long long ldo, long long o_bs, int rows_per_split, int splits,
                   cudaStream_t stream) {
  const int nj = (nt + T - 1) / T;
  if (next_width == 0) {
    const dim3 grid(nj, splits, batch);
    trailing_kernel<S, T, false><<<grid, cqr2::kThreads, 0, stream>>>(
        a, q, w, out, part, m, b, nt, 0, lda, a_bs, ldo, o_bs, rows_per_split);
    return cudaGetLastError();
  }
  const int ni = (next_width + T - 1) / T;
  const dim3 grid(ni * nj, splits, batch);
  trailing_kernel<S, T, true><<<grid, cqr2::kThreads, 0, stream>>>(
      a, q, w, out, part, m, b, nt, next_width, lda, a_bs, ldo, o_bs, rows_per_split);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return cross::launch_fold_rect(part, s, batch, splits, next_width, nt, stream);
}

template <typename S>
cudaError_t dispatch(const S* a, const S* q, const S* w, S* out, float* part, float* s, int batch,
                     int m, int b, int nt, int next_width, long long lda, long long a_bs,
                     long long ldo, long long o_bs, int rows_per_split, int splits,
                     cudaStream_t stream) {
  switch (cqr2::tile_for(nt)) {
    case 32:
      return launch<S, 32>(a, q, w, out, part, s, batch, m, b, nt, next_width, lda, a_bs, ldo,
                           o_bs, rows_per_split, splits, stream);
    case 64:
      return launch<S, 64>(a, q, w, out, part, s, batch, m, b, nt, next_width, lda, a_bs, ldo,
                           o_bs, rows_per_split, splits, stream);
    default:
      return launch<S, 128>(a, q, w, out, part, s, batch, m, b, nt, next_width, lda, a_bs, ldo,
                            o_bs, rows_per_split, splits, stream);
  }
}

}  // namespace

// a: (batch, m, nt) with row stride lda and batch stride a_bs; q: (batch,
// m, b) and w: (batch, b, nt) contiguous; out: (batch, m, nt) with row
// stride ldo and batch stride o_bs (elements); one storage type (f32 or
// bf16) for all four.  With next_width > 0, part: (batch, splits,
// next_width, nt) f32 scratch and s: (batch, next_width, nt) f32; otherwise
// both may be null.  Returns the launch's cudaError_t.
extern "C" int repro_trailing_update(const void* a, const void* q, const void* w, void* out,
                                     void* part, void* s, int is_bf16, int batch, int m, int b,
                                     int nt, int next_width, long long lda, long long a_bs,
                                     long long ldo, long long o_bs, int rows_per_split,
                                     int splits, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(part);
  float* sp = static_cast<float*>(s);
  if (is_bf16)
    return dispatch(static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(q),
                    static_cast<const __nv_bfloat16*>(w), static_cast<__nv_bfloat16*>(out), p, sp,
                    batch, m, b, nt, next_width, lda, a_bs, ldo, o_bs, rows_per_split, splits,
                    st);
  return dispatch(static_cast<const float*>(a), static_cast<const float*>(q),
                  static_cast<const float*>(w), static_cast<float*>(out), p, sp, batch, m, b, nt,
                  next_width, lda, a_bs, ldo, o_bs, rows_per_split, splits, st);
}
