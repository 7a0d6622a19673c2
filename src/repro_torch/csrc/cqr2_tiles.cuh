// Device building blocks shared by the CholeskyQR2 kernels (gram.cu,
// fused_apply_gram.cu, apply_right.cu) and the blocked-QR kernels.
//
// Bitwise contracts the three kernels keep with each other:
//   * every element of Q = A.W is one f32 register summed over l = 0..n-1
//     in order with __fmaf_rn (apply_chunk here, apply_right.cu's loop and
//     slab_tiles.cuh keep the same chain), so apply_right and the fused
//     kernel produce the same bits;
//   * every element of a Gram partial is one f32 register summed over the
//     rows of its split in order with __fmaf_rn (gram_accumulate, and
//     fused_apply_gram.cu's own tiling of the same chain), and the splits
//     are folded in index order (fold_partials), so the fused kernel's G'
//     equals gram(apply_right(A, W)) whenever both use the same row split,
//     and every run gives the same bits (no atomics).
// The tile shapes do not enter the arithmetic order, so the kernels are free
// to tile differently.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cqr2 {

constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kRows = 32;      // rows of one streamed chunk
constexpr int kDepth = 16;     // depth of one A.W step (columns of A)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename S> __device__ __forceinline__ S from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Output tile edge for a Gram or product width: one tile up to 128 columns.
inline int tile_for(int width) { return width <= 32 ? 32 : (width <= 64 ? 64 : 128); }

// A thread's MT = T / 16 indices along one axis, for thread coordinate t:
// groups of G consecutive indices, group g at g * 16 * G + t * G.
template <int T>
struct Axis {
  static constexpr int MT = T / 16;
  static constexpr int G = MT < 4 ? MT : 4;
  static __device__ __forceinline__ int index(int t, int e) {
    return (e / G) * 16 * G + t * G + e % G;
  }
};

// Index of upper-triangle tile pair p (row-major over I <= J) in an nt x nt grid.
__device__ __forceinline__ void tile_pair(int p, int nt, int& ti, int& tj) {
  ti = 0;
  while (p >= nt - ti) {
    p -= nt - ti;
    ++ti;
  }
  tj = ti + p;
}

// X[r][c] = src[r0 + r, c0 + c] of a (rows x width) row-major matrix, zero
// outside it.
template <typename S, int T>
__device__ __forceinline__ void load_tile(float (*X)[T], const S* src, int rows, int width,
                                          int r0, int c0) {
  for (int e = threadIdx.x; e < kRows * T; e += kThreads) {
    const int r = e / T, c = e % T;
    const int gr = r0 + r, gc = c0 + c;
    X[r][c] = (gr < rows && gc < width) ? to_f32(src[(long long)gr * width + gc]) : 0.0f;
  }
}

// acc[a][b] += sum_r Xi[r][ty + 16a] * Xj[r][tx + 16b], rows in order.
template <int T>
__device__ __forceinline__ void gram_accumulate(float (*Xi)[T], float (*Xj)[T],
                                                float (&acc)[T / 16][T / 16]) {
  constexpr int MT = T / 16;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll 4
  for (int r = 0; r < kRows; ++r) {
    float xi[MT], xj[MT];
#pragma unroll
    for (int a = 0; a < MT; ++a) xi[a] = Xi[r][ty + 16 * a];
#pragma unroll
    for (int b = 0; b < MT; ++b) xj[b] = Xj[r][tx + 16 * b];
#pragma unroll
    for (int a = 0; a < MT; ++a)
#pragma unroll
      for (int b = 0; b < MT; ++b) acc[a][b] = __fmaf_rn(xi[a], xj[b], acc[a][b]);
  }
}

// Write one CTA's accumulator tile (ti, tj) into its split's (width x width)
// partial.
template <int T>
__device__ __forceinline__ void store_partial(float* part, int width, int ti, int tj,
                                              const float (&acc)[T / 16][T / 16]) {
  constexpr int MT = T / 16;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int a = 0; a < MT; ++a) {
    const int i = ti * T + ty + 16 * a;
#pragma unroll
    for (int b = 0; b < MT; ++b) {
      const int j = tj * T + tx + 16 * b;
      if (i < width && j < width) part[(long long)i * width + j] = acc[a][b];
    }
  }
}

// The thread's elements of the (kRows x T) chunk Q[r0:, c0:] = A.W with f32
// accumulation: column c0 + tid % T, rows tid / T + (256 / T) * e.  A is
// (rows x n), W is (n x k), both row-major, staged through shared memory one
// kDepth-deep step at a time; the next step's global loads are issued into
// registers before the current step's FMAs, so they are in flight meanwhile.
template <typename S, int T>
__device__ __forceinline__ void apply_chunk(const S* A, const S* W, int rows, int n, int k,
                                            int r0, int c0, float (*As)[kDepth],
                                            float (*Ws)[T], float (&q)[kRows * T / kThreads]) {
  constexpr int TPC = kThreads / T;                // threads per column
  constexpr int RPT = kRows / TPC;                 // rows per thread
  constexpr int A_PT = kRows * kDepth / kThreads;  // staged A values per thread
  constexpr int W_PT = kDepth * T / kThreads;      // staged W values per thread
  const int c = threadIdx.x % T, rbase = threadIdx.x / T;
  float ra[A_PT], rw[W_PT];
  auto fetch = [&](int l0) {
#pragma unroll
    for (int i = 0; i < A_PT; ++i) {
      const int e = threadIdx.x + kThreads * i;
      const int gr = r0 + e / kDepth, gl = l0 + e % kDepth;
      ra[i] = (gr < rows && gl < n) ? to_f32(A[(long long)gr * n + gl]) : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < W_PT; ++i) {
      const int e = threadIdx.x + kThreads * i;
      const int gl = l0 + e / T, gc = c0 + e % T;
      rw[i] = (gl < n && gc < k) ? to_f32(W[(long long)gl * k + gc]) : 0.0f;
    }
  };
#pragma unroll
  for (int e = 0; e < RPT; ++e) q[e] = 0.0f;
  fetch(0);
  for (int l0 = 0; l0 < n; l0 += kDepth) {
#pragma unroll
    for (int i = 0; i < A_PT; ++i) {
      const int e = threadIdx.x + kThreads * i;
      As[e / kDepth][e % kDepth] = ra[i];
    }
#pragma unroll
    for (int i = 0; i < W_PT; ++i) {
      const int e = threadIdx.x + kThreads * i;
      Ws[e / T][e % T] = rw[i];
    }
    __syncthreads();
    if (l0 + kDepth < n) fetch(l0 + kDepth);
#pragma unroll
    for (int l = 0; l < kDepth; l += 4) {
      const float w0 = Ws[l][c], w1 = Ws[l + 1][c], w2 = Ws[l + 2][c], w3 = Ws[l + 3][c];
#pragma unroll
      for (int e = 0; e < RPT; ++e) {
        const float4 a = *reinterpret_cast<const float4*>(&As[rbase + TPC * e][l]);
        float acc = q[e];
        acc = __fmaf_rn(a.x, w0, acc);
        acc = __fmaf_rn(a.y, w1, acc);
        acc = __fmaf_rn(a.z, w2, acc);
        acc = __fmaf_rn(a.w, w3, acc);
        q[e] = acc;
      }
    }
    __syncthreads();
  }
}

// g[b][i][j] = sum over splits s in order of part[b][s][min(i,j)][max(i,j)]:
// the upper-triangle partials folded into a full, exactly symmetric Gram.
__global__ void fold_partials(const float* __restrict__ part, float* __restrict__ g, int batch,
                              int splits, int width) {
  const long long per = (long long)width * width;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= batch * per) return;
  const int b = (int)(idx / per);
  const int rem = (int)(idx % per);
  int i = rem / width, j = rem % width;
  if (i > j) {
    const int t = i;
    i = j;
    j = t;
  }
  const float* p = part + (long long)b * splits * per + (long long)i * width + j;
  float sum = 0.0f;
  for (int s = 0; s < splits; ++s) sum = __fadd_rn(sum, p[s * per]);
  g[idx] = sum;
}

inline cudaError_t launch_fold(const float* part, float* g, int batch, int splits, int width,
                               cudaStream_t stream) {
  const long long total = (long long)batch * width * width;
  const int blocks = (int)((total + kThreads - 1) / kThreads);
  fold_partials<<<blocks, kThreads, 0, stream>>>(part, g, batch, splits, width);
  return cudaGetLastError();
}

}  // namespace cqr2
