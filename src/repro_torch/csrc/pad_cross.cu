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
// Arithmetic: panel_cross's (the contract of cross_tiles.cuh), on
// _launch.cross_split's split, so S's real columns equal panel_cross(A) bit
// for bit; the pad columns sum exact zeros.
//
// Design: panel_cross.cuh's sweep with the column tiles taken over
// out_width.  The cp.async source size zero-fills the columns >= n, which
// are both the pad of A_pad and the pad columns of S.  The CTAs of S's row
// tile 0 write their column tile of A_pad for their split's rows from each
// staged chunk once it has landed (16-byte stores where A_pad's rows allow
// them), so every A_pad element is written once and A is read once.
#include "panel_cross.cuh"

namespace {

// Rows [r0, min(r0 + kChunk, r_end)) and columns [c0, min(c0 + T, width))
// of the staged (kChunk x T) chunk X into dst (row stride width): V
// elements a store, V = 16 bytes' worth when vec, else one.
template <typename S, int T>
__device__ __forceinline__ void write_chunk(S* dst, const S* X, int r0, int r_end, int c0,
                                            int width, bool vec) {
  constexpr int V = 16 / (int)sizeof(S);
  if (vec) {
    for (int e = threadIdx.x; e < cross::kChunk * T / V; e += cqr2::kThreads) {
      const int r = e / (T / V), c = (e % (T / V)) * V;
      if (r0 + r < r_end && c0 + c < width)
        *reinterpret_cast<uint4*>(dst + (long long)(r0 + r) * width + c0 + c) =
            *reinterpret_cast<const uint4*>(X + r * T + c);
    }
  } else {
    for (int e = threadIdx.x; e < cross::kChunk * T; e += cqr2::kThreads) {
      const int r = e / T, c = e % T;
      if (r0 + r < r_end && c0 + c < width) dst[(long long)(r0 + r) * width + c0 + c] = X[e];
    }
  }
}

template <typename S, int T, int CPE>
__global__ void __launch_bounds__(cqr2::kThreads, 2)
    pad_cross_kernel(const S* __restrict__ a, S* __restrict__ apad, float* __restrict__ part,
                     int m, int n, int split, int out_width, long long lda, long long a_bs,
                     int rows_per_split, bool vec) {
  const int nj = (out_width + T - 1) / T;
  const int ti = blockIdx.x / nj, tj = blockIdx.x % nj;
  const int sp = blockIdx.y, b = blockIdx.z;
  S* dst = apad + (long long)b * m * out_width;
  const int r_begin = sp * rows_per_split;
  const int r_end = min(m, r_begin + rows_per_split);
  auto write_pad = [&](const S* X, int r0) {
    if (ti == 0) write_chunk<S, T>(dst, X, r0, r_end, tj * T, out_width, vec);
  };
  float acc[T / 16][T / 16];
  cross::sweep<S, T, CPE, false>(a + (long long)b * a_bs, r_begin, r_end, n, lda, ti, tj, acc,
                                 write_pad);
  cross::store<T>(part + ((long long)b * gridDim.y + sp) * split * out_width, split, out_width,
                  ti, tj, acc);
}

template <typename S, int T, int CPE>
cudaError_t launch(const S* a, S* apad, float* part, float* s, int batch, int m, int n,
                   int split, int out_width, long long lda, long long a_bs, int rows_per_split,
                   int splits, cudaStream_t stream) {
  const int ni = (split + T - 1) / T, nj = (out_width + T - 1) / T;
  const dim3 grid(ni * nj, splits, batch);
  const bool vec = reinterpret_cast<std::uintptr_t>(apad) % 16 == 0 &&
                   (out_width * (int)sizeof(S)) % 16 == 0;
  constexpr int smem = cross::kSweepSmem<S, T>;
  cudaError_t err = cudaFuncSetAttribute(pad_cross_kernel<S, T, CPE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  pad_cross_kernel<S, T, CPE><<<grid, cqr2::kThreads, smem, stream>>>(
      a, apad, part, m, n, split, out_width, lda, a_bs, rows_per_split, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return cross::launch_fold_rect(part, s, batch, splits, split, out_width, stream);
}

template <typename S, int T>
cudaError_t by_copy(const S* a, S* apad, float* part, float* s, int batch, int m, int n,
                    int split, int out_width, long long lda, long long a_bs, int rows_per_split,
                    int splits, cudaStream_t stream) {
  return tiles::by_copy(a, lda, a_bs, batch, [&](auto cpe) {
    return launch<S, T, decltype(cpe)::value>(a, apad, part, s, batch, m, n, split, out_width,
                                              lda, a_bs, rows_per_split, splits, stream);
  });
}

template <typename S>
cudaError_t dispatch(const S* a, S* apad, float* part, float* s, int batch, int m, int n,
                     int split, int out_width, long long lda, long long a_bs, int rows_per_split,
                     int splits, cudaStream_t stream) {
  switch (cqr2::tile_for(out_width)) {
    case 32:
      return by_copy<S, 32>(a, apad, part, s, batch, m, n, split, out_width, lda, a_bs,
                            rows_per_split, splits, stream);
    case 64:
      return by_copy<S, 64>(a, apad, part, s, batch, m, n, split, out_width, lda, a_bs,
                            rows_per_split, splits, stream);
    default:
      return by_copy<S, 128>(a, apad, part, s, batch, m, n, split, out_width, lda, a_bs,
                             rows_per_split, splits, stream);
  }
}

}  // namespace

// a: (batch, m, n) with row stride lda and batch stride a_bs (elements);
// apad: (batch, m, out_width) contiguous, same storage type as a;
// part: (batch, splits, split, out_width) f32 scratch; s: (batch, split,
// out_width) f32.  Returns the first launch's cudaError_t.
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
