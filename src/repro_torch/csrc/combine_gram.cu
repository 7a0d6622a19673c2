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
// Arithmetic (unchanged from the first design, so every output keeps its
// bits): each element (i, j) is two chains, R1's and R2's, each one f32
// register summed over k = 0, 1, ... in order with __fmaf_rn from +0 (the
// rows past n of the last chunk are zero, which leaves the chain as it is:
// fma(0, 0, acc) == acc for every acc the chain can reach), and one rounded
// __fadd_rn of the two.  A diagonal tile writes all of its elements and an
// off-diagonal tile writes (i, j) and (j, i): fma is symmetric in its
// factors, so G is exactly symmetric.  n <= 512 needs no split over k: no
// partials, no fold, no atomics, and every run gives the same bits.
//
// Design.  The first design ran both chains in one CTA of 256 threads, one
// after the other, each thread a 4 x 4 tile read with scalar shared loads
// from chunks staged by synchronous loads: at n = 512 its 288 CTAs waited
// out every load and issued a shared read for every two FMAs.  Now:
//   * the two chains run in the two CTAs of a thread-block cluster of 2
//     (rank 0 R1's, rank 1 R2's); rank 1 hands its sums to rank 0 through
//     distributed shared memory, which adds and stores, so each CTA's
//     serial chain is half as long and twice as many CTAs are in flight;
//   * a CTA is 64 threads (8 x 8) on a T x T tile (T = 64, or 32 at n <=
//     32), 8 x 8 outputs a thread (4 x 4 at T = 32) in groups of four
//     consecutive indices, so a row of a chunk costs four 128-bit shared
//     reads for 64 FMAs;
//   * the rows stream through a ring of three 16-row chunks copied with
//     cp.async (async_tiles.cuh: 16 bytes where the rows allow, zero-filled
//     past row and column n), one barrier a chunk;
//   * at n = 512 the grid is 8 matrices x 36 tile pairs x 2 = 576 CTAs of
//     24 KiB, all resident at once (the launch bound keeps six an SM);
//     n = 32 and 128 (16 and 48 CTAs) are launch-bound;
//   * the stores are 16-byte vectors when n % 4 == 0 (else one element).
// bf16 inputs are staged raw and converted on the shared read.
//
// What still bounds it: the FMA issue of the SMs that hold five CTAs.  An
// instrumented build (not kept) showed all 576 CTAs starting together, 48
// SMs holding five and 84 holding four, the five-CTA SMs finishing last,
// and the FMA loop alone (no loads after the first chunks) taking most of
// the time, at about two warps a scheduler.  Of the variants tried on the
// card, the cluster split was the change that moved the time: the chains
// one after the other in one CTA were much slower, while twice the warps
// (8 x 4 tiles), 4 x 4 tiles, one-warp CTAs on half tiles (finer balance,
// more loads), 32-row chunks, more stages and other register caps were
// none of them clearly faster.  Splitting k would give more warps but
// change the chains' order, and so the bits.
#include <cooperative_groups.h>

#include "async_tiles.cuh"
#include "cqr2_tiles.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 64;  // 8 x 8 threads
constexpr int kChunk = 16;    // rows of one staged chunk
constexpr int kStages = 3;    // chunks in the ring

// A thread's MT = T / 8 indices along one axis, for thread coordinate t:
// groups of four consecutive indices, group g at 32 g + 4 t.
template <int T>
struct Axis {
  static constexpr int MT = T / 8;
  static __device__ __forceinline__ int index(int t, int e) { return (e / 4) * 32 + t * 4 + e % 4; }
};

// Stage rows [r0, r0 + kChunk) and columns [c0, c0 + T) of the (n x n)
// row-major src into X (kChunk x T), zero outside it.
template <typename S, int T, int CPE>
__device__ __forceinline__ void stage(S* X, const S* src, int r0, int n, int c0) {
  constexpr int kPerRow = T / CPE;
  for (int e = threadIdx.x; e < kChunk * kPerRow; e += kThreads) {
    const int r = e / kPerRow, c = (e % kPerRow) * CPE;
    const int gr = r0 + r, gc = c0 + c;
    const int valid = gr < n ? max(0, min(CPE, n - gc)) : 0;
    tiles::copy<S, CPE>(X + r * T + c, valid ? src + (long long)gr * n + gc : src, valid);
  }
}

// acc[i][j] = sum over k in order of src[k, ti T + index(ty, i)] *
// src[k, tj T + index(tx, j)], each a __fmaf_rn chain from +0.
template <typename S, int T, int CPE>
__device__ __forceinline__ void chain(const S* src, int n, int ti, int tj, S* ring,
                                      float (&acc)[T / 8][T / 8]) {
  using X = Axis<T>;
  constexpr int MT = X::MT, kTile = kChunk * T;
  const bool diag = ti == tj;
  const int chunks = (n + kChunk - 1) / kChunk;
  const int ty = threadIdx.x / 8, tx = threadIdx.x % 8;

  auto issue = [&](int c) {
    if (c < chunks) {
      S* slot = ring + (c % kStages) * 2 * kTile;
      stage<S, T, CPE>(slot, src, c * kChunk, n, tj * T);
      if (!diag) stage<S, T, CPE>(slot + kTile, src, c * kChunk, n, ti * T);
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
    const S* xj_tile = ring + (c % kStages) * 2 * kTile;
    const S* xi_tile = diag ? xj_tile : xj_tile + kTile;
#pragma unroll 8
    for (int r = 0; r < kChunk; ++r) {
      float xi[MT], xj[MT];
#pragma unroll
      for (int g = 0; g < MT / 4; ++g) {
        tiles::read<4>(xi_tile + r * T + X::index(ty, 4 * g), xi + 4 * g);
        tiles::read<4>(xj_tile + r * T + X::index(tx, 4 * g), xj + 4 * g);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < MT; ++j) acc[i][j] = __fmaf_rn(xi[i], xj[j], acc[i][j]);
    }
  }
  tiles::wait<0>();
}

template <typename S, int T>
constexpr int kRingBytes = kStages * 2 * kChunk * T * (int)sizeof(S);
template <int T>
constexpr int kHandBytes = kThreads * (T / 8) * (T / 8) * (int)sizeof(float);

// One cluster of two CTAs per (matrix, upper-triangle tile pair): rank 0
// runs R1's chain, rank 1 R2's; rank 0 adds and stores.
template <typename S, int T, int CPE>
__global__ void __launch_bounds__(kThreads, 6)
    combine_gram_kernel(const S* __restrict__ r1, const S* __restrict__ r2,
                        float* __restrict__ g, int n) {
  using X = Axis<T>;
  constexpr int MT = X::MT;
  constexpr int kRing = kRingBytes<S, T>, kHand = kHandBytes<T>;
  constexpr int kBytes = kRing > kHand ? kRing : kHand;
  __shared__ __align__(16) unsigned char smem[kBytes];
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  int ti, tj;
  cqr2::tile_pair(blockIdx.x / 2, (n + T - 1) / T, ti, tj);
  const long long off = (long long)blockIdx.y * n * n;
  float acc[MT][MT];
  chain<S, T, CPE>((rank == 0 ? r1 : r2) + off, n, ti, tj, reinterpret_cast<S*>(smem), acc);
  __syncthreads();  // every read of the ring is done before the hand-off reuses it
  float* hand = reinterpret_cast<float*>(smem);
  if (rank == 1) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < MT; ++j) hand[(i * MT + j) * kThreads + threadIdx.x] = acc[i][j];
  }
  cluster.sync();  // rank 1's sums are visible to rank 0
  if (rank == 0) {
    const float* other = cluster.map_shared_rank(hand, 1);
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < MT; ++j)
        acc[i][j] = __fadd_rn(acc[i][j], other[(i * MT + j) * kThreads + threadIdx.x]);
    float* out = g + off;
    const int ty = threadIdx.x / 8, tx = threadIdx.x % 8;
    const bool diag = ti == tj;
    if (n % 4 == 0) {
      // groups of four consecutive columns (rows for the mirror) are
      // wholly inside or wholly outside the matrix
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int gi = ti * T + X::index(ty, i);
#pragma unroll
        for (int jg = 0; jg < MT; jg += 4) {
          const int gj = tj * T + X::index(tx, jg);
          if (gi < n && gj < n)
            *reinterpret_cast<float4*>(out + (long long)gi * n + gj) =
                make_float4(acc[i][jg], acc[i][jg + 1], acc[i][jg + 2], acc[i][jg + 3]);
        }
      }
      if (!diag) {
#pragma unroll
        for (int j = 0; j < MT; ++j) {
          const int gj = tj * T + X::index(tx, j);
#pragma unroll
          for (int ig = 0; ig < MT; ig += 4) {
            const int gi = ti * T + X::index(ty, ig);
            if (gi < n && gj < n)
              *reinterpret_cast<float4*>(out + (long long)gj * n + gi) =
                  make_float4(acc[ig][j], acc[ig + 1][j], acc[ig + 2][j], acc[ig + 3][j]);
          }
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int gi = ti * T + X::index(ty, i);
#pragma unroll
        for (int j = 0; j < MT; ++j) {
          const int gj = tj * T + X::index(tx, j);
          if (gi < n && gj < n) {
            out[(long long)gi * n + gj] = acc[i][j];
            if (!diag) out[(long long)gj * n + gi] = acc[i][j];
          }
        }
      }
    }
  }
  cluster.sync();  // rank 1's shared memory outlives rank 0's reads
}

template <typename S, int T, int CPE>
cudaError_t launch(const S* r1, const S* r2, float* g, int batch, int n, cudaStream_t stream) {
  const int nt = (n + T - 1) / T;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(2 * (nt * (nt + 1) / 2), batch);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 2;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, combine_gram_kernel<S, T, CPE>, r1, r2, g, n);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The widest cp.async size that every row of both (batch, n, n) operands
// admits: 16 bytes, else 4, else (bf16 on odd addresses) one element.
template <typename S, int T>
cudaError_t by_copy(const S* r1, const S* r2, float* g, int batch, int n, cudaStream_t stream) {
  constexpr int es = sizeof(S);
  auto fits = [&](int bytes) {
    return reinterpret_cast<std::uintptr_t>(r1) % bytes == 0 &&
           reinterpret_cast<std::uintptr_t>(r2) % bytes == 0 && ((long long)n * es) % bytes == 0;
  };
  if (fits(16)) return launch<S, T, 16 / es>(r1, r2, g, batch, n, stream);
  if (fits(4)) return launch<S, T, 4 / es>(r1, r2, g, batch, n, stream);
  if constexpr (es == 2) return launch<S, T, 1>(r1, r2, g, batch, n, stream);
  return cudaErrorMisalignedAddress;
}

template <typename S>
cudaError_t dispatch(const S* r1, const S* r2, float* g, int batch, int n,
                     cudaStream_t stream) {
  if (n <= 32) return by_copy<S, 32>(r1, r2, g, batch, n, stream);
  return by_copy<S, 64>(r1, r2, g, batch, n, stream);
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
