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
// Arithmetic: every element of Q is one f32 register, starting at 0 and
// summed with __fmaf_rn over l = 0..n-1 in order, then cast to A's type,
// exactly as cqr2::apply_chunk does, so Q equals fused_apply_gram's Q bit
// for bit.  Zero-filled depth past n adds exact zeros.
//
// Design.  A map kernel on a persistent grid (one CTA per SM): each CTA
// takes a contiguous range of (matrix, column tile, row block) tiles, row
// blocks fastest, so it keeps one W slab for many row blocks.  The slab,
// W[:, c0:c0 + T] in f32 (zero past n and k), is loaded into shared memory
// once per (matrix, column tile) and stays there; T shrinks from 128 to 64
// or 32 for wide n so the slab fits in 64 KiB.  A streams through a ring of
// kStages depth slices (BM rows x KD columns, 64 KiB in f32), copied with
// cp.async (16 bytes where A's base and row length allow it, else 4,
// zero-filled through the source size), so the next slice's copies overlap
// the current slice's FMAs, one barrier a slice.  Each of the 256 threads
// owns a 16 x 8 tile of Q: sixteen consecutive rows and two groups of four
// columns (4t.. and T/2 + 4t..); four steps of l cost sixteen 128-bit
// broadcast reads of A and eight of W for 512 FMAs.  The tile takes all
// 255 registers.  Measured on an H100, deeper slices (fewer barriers) and a
// taller thread tile each paid, and a full unroll of the 64-deep slice
// overflowed the instruction cache.  bf16 A is staged raw and converted on
// the shared read.
#include "async_tiles.cuh"
#include "cqr2_tiles.cuh"

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kStages = 2;            // depth slices in the ring
constexpr int kSlabBytes = 64 << 10;  // shared memory for W's slab

template <int T>
struct Tile {
  static constexpr int RM = 16;                   // rows of a thread's tile (8 columns)
  static constexpr int TX = T / 8;                // threads across a tile's columns
  static constexpr int TY = cqr2::kThreads / TX;  // threads down its rows
  static constexpr int BM = RM * TY;              // rows of a tile: 256, 512, 1024
  static constexpr int KD = T / 2;                // depth of a slice: BM * KD = 16384
};

// Rows of W's slab: n rounded up to whole slices.
template <int T>
__host__ __device__ __forceinline__ int slab_rows(int n) {
  return (n + Tile<T>::KD - 1) / Tile<T>::KD * Tile<T>::KD;
}

template <typename S, int T>
constexpr int ring_bytes() {
  return kStages * Tile<T>::BM * Tile<T>::KD * static_cast<int>(sizeof(S));
}

// q[0..4) = v[0..4) cast to S where the column is below k; one vector store
// when all four are and the row is aligned.
template <typename S>
__device__ __forceinline__ void store4(S* q, const float* v, int cols, bool vec) {
  if (vec && cols >= 4) {
    if constexpr (sizeof(S) == 4) {
      *reinterpret_cast<float4*>(q) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
      uint2 u;
      u.x = *reinterpret_cast<const unsigned*>(&lo);
      u.y = *reinterpret_cast<const unsigned*>(&hi);
      *reinterpret_cast<uint2*>(q) = u;
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (j < cols) q[j] = cqr2::from_f32<S>(v[j]);
}

template <typename S, int T, int CPE>
__global__ void __launch_bounds__(cqr2::kThreads, 1)
    apply_kernel(const S* __restrict__ a, const S* __restrict__ w, S* __restrict__ q, int batch,
                 int m, int n, int k) {
  using TL = Tile<T>;
  constexpr int BM = TL::BM, KD = TL::KD, TX = TL::TX, RM = TL::RM;
  extern __shared__ __align__(16) unsigned char smem[];
  const int depth = slab_rows<T>(n), slices = depth / KD;
  float* slab = reinterpret_cast<float*>(smem);                         // [depth][T]
  S* ring = reinterpret_cast<S*>(smem + (size_t)depth * T * sizeof(float));  // [kStages][BM][KD]
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int row_blocks = (m + BM - 1) / BM, col_tiles = (k + T - 1) / T;
  const long long tiles = (long long)batch * col_tiles * row_blocks;
  const long long t_end = tiles * (blockIdx.x + 1) / gridDim.x;
  const bool vec = k % 4 == 0 && reinterpret_cast<std::uintptr_t>(q) % (4 * sizeof(S)) == 0;

  for (long long t = tiles * blockIdx.x / gridDim.x; t < t_end;) {
    const long long group = t / row_blocks;  // (matrix, column tile)
    const long long seg_end = min(t_end, (group + 1) * row_blocks);
    const int b = (int)(group / col_tiles), c0 = (int)(group % col_tiles) * T;
    const int rb0 = (int)(t - group * row_blocks);
    const int steps = (int)(seg_end - t) * slices;
    const S* ab = a + (long long)b * m * n;
    const S* wb = w + (long long)b * n * k;
    S* qb = q + (long long)b * m * k;

    __syncthreads();  // the previous segment's reads of the slab and the ring are done
    for (int e = threadIdx.x; e < depth * T; e += cqr2::kThreads) {
      const int l = e / T, gc = c0 + e % T;
      slab[e] = (l < n && gc < k) ? cqr2::to_f32(wb[(long long)l * k + gc]) : 0.0f;
    }
    auto issue = [&](int s) {
      if (s < steps) {
        const int r0 = (rb0 + s / slices) * BM, l0 = (s % slices) * KD;
        S* dst = ring + (s % kStages) * BM * KD;
        constexpr int kPerRow = KD / CPE;
        for (int e = threadIdx.x; e < BM * kPerRow; e += cqr2::kThreads) {
          const int r = e / kPerRow, c = (e % kPerRow) * CPE;
          const int gr = r0 + r, gl = l0 + c;
          const int valid = gr < m ? max(0, min(CPE, n - gl)) : 0;
          tiles::copy<S, CPE>(dst + r * KD + c, valid ? ab + (long long)gr * n + gl : ab, valid);
        }
      }
      tiles::commit();
    };
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) issue(s);

    float acc[RM][8];
    for (int s = 0; s < steps; ++s) {
      tiles::wait<kStages - 2>();
      __syncthreads();  // slice s (and the slab) is visible; slice s - 1's stage is free
      issue(s + kStages - 1);
      const int slice = s % slices;
      if (slice == 0) {
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
      }
      const S* as = ring + (s % kStages) * BM * KD + ty * RM * KD;
      const float* ws = slab + slice * KD * T + 4 * tx;
#pragma unroll 4  // a full unroll of 64 deep outgrows the instruction cache
      for (int l4 = 0; l4 < KD; l4 += 4) {
        float av[RM][4];
#pragma unroll
        for (int i = 0; i < RM; ++i) tiles::read<4>(as + i * KD + l4, av[i]);
#pragma unroll
        for (int dl = 0; dl < 4; ++dl) {
          float wv[8];
          tiles::read<4>(ws + (l4 + dl) * T, wv);
          tiles::read<4>(ws + (l4 + dl) * T + T / 2, wv + 4);
#pragma unroll
          for (int i = 0; i < RM; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = __fmaf_rn(av[i][dl], wv[j], acc[i][j]);
        }
      }
      if (slice == slices - 1) {
        const int r0 = (rb0 + s / slices) * BM + ty * RM;
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          if (r0 + i >= m) break;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int gc = c0 + h * (T / 2) + 4 * tx;
            if (gc < k) store4<S>(qb + (long long)(r0 + i) * k + gc, acc[i] + 4 * h, k - gc, vec);
          }
        }
      }
    }
    t = seg_end;
  }
  tiles::wait<0>();
}

template <typename S, int T, int CPE>
cudaError_t launch(const S* a, const S* w, S* q, int batch, int m, int n, int k,
                   cudaStream_t stream) {
  const int smem = slab_rows<T>(n) * T * (int)sizeof(float) + ring_bytes<S, T>();
  cudaError_t err = cudaFuncSetAttribute(apply_kernel<S, T, CPE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int device = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, apply_kernel<S, T, CPE>,
                                                        cqr2::kThreads, smem);
  if (err != cudaSuccess) return err;
  const long long tiles = (long long)batch * ((k + T - 1) / T) *
                          ((m + Tile<T>::BM - 1) / Tile<T>::BM);
  const int grid = (int)std::min(tiles, (long long)std::max(1, per_sm) * sms);
  apply_kernel<S, T, CPE><<<grid, cqr2::kThreads, smem, stream>>>(a, w, q, batch, m, n, k);
  return cudaGetLastError();
}

template <typename S, int T>
cudaError_t by_copy(const S* a, const S* w, S* q, int batch, int m, int n, int k,
                    cudaStream_t stream) {
  return tiles::by_copy(a, n, (long long)m * n, batch, [&](auto cpe) {
    return launch<S, T, decltype(cpe)::value>(a, w, q, batch, m, n, k, stream);
  });
}

// Column tile: 128 (or less for narrow k), halved until W's slab fits.
template <typename S>
cudaError_t dispatch(const S* a, const S* w, S* q, int batch, int m, int n, int k,
                     cudaStream_t stream) {
  const int t = cqr2::tile_for(k);
  if (t == 128 && slab_rows<128>(n) * 128 * 4 <= kSlabBytes)
    return by_copy<S, 128>(a, w, q, batch, m, n, k, stream);
  if (t >= 64 && slab_rows<64>(n) * 64 * 4 <= kSlabBytes)
    return by_copy<S, 64>(a, w, q, batch, m, n, k, stream);
  return by_copy<S, 32>(a, w, q, batch, m, n, k, stream);
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
