// The streamed right-multiply X.W on a W slab held in shared memory, shared
// by trailing_update.cu (the update A - Q.W) and fused_apply_gram.cu (Q =
// A.W): the tile geometry, the slab, the cp.async ring of X's depth slices
// and the FMAs of one slice.
//
// Arithmetic: every element of X.W is one f32 register, starting at 0 and
// summed with __fmaf_rn over l = 0..n-1 in order (zero-filled depth past n
// adds exact zeros), as cqr2::apply_chunk and apply_right.cu sum it, so the
// tiling below does not enter the bits.
//
// Geometry.  An output tile is BM rows x T columns; each of the 256 threads
// owns 8 rows (ty * 8 ..) x 8 columns in two groups of four (4 tx .. and
// T / 2 + 4 tx ..), so a warp's reads of W are 16-byte, bank-conflict free,
// and its reads of X are broadcasts.  One ring stage holds BM x KD = 4096
// elements of X (16 KiB in f32), so BM x T x KD is the same at every T.
#pragma once

#include "async_tiles.cuh"
#include "cqr2_tiles.cuh"

#include <cstdint>

namespace slab {

constexpr int kThreads = cqr2::kThreads;
constexpr int kStages = 3;  // depth slices in the ring: copies of two in flight

template <int T>
struct Tile {
  static constexpr int RM = 8;                // rows of a thread's tile
  static constexpr int TX = T / 8;            // threads across the columns
  static constexpr int TY = kThreads / TX;    // threads down the rows
  static constexpr int BM = RM * TY;          // rows of a tile: 128, 256, 512
  static constexpr int KD = 4096 / BM;        // depth of a slice: 32, 16, 8
  static constexpr int kStageElems = BM * KD;
};

// Rows of W's slab: n rounded up to whole slices.
template <int T>
__host__ __device__ __forceinline__ int slab_rows(int n) {
  return (n + Tile<T>::KD - 1) / Tile<T>::KD * Tile<T>::KD;
}

// slab[l][c] = W[l][c0 + c] in f32 for l < slab_rows(n), c < T, zero outside
// the (n x k) row-major W.  Plain loads: the slab is read from L2 once per
// (CTA, matrix, column tile), and the first ring barrier publishes it.
template <typename S, int T>
__device__ __forceinline__ void load_slab(float* slab, const S* w, int n, int k, int c0) {
  const int depth = slab_rows<T>(n);
  for (int e = threadIdx.x; e < depth * T; e += kThreads) {
    const int l = e / T, gc = c0 + e % T;
    slab[e] = (l < n && gc < k) ? cqr2::to_f32(w[(long long)l * k + gc]) : 0.0f;
  }
}

// Copy rows [r0, r0 + BM) x depth [l0, l0 + KD) of the (rows x n) operand x
// (row stride ldx) into one ring stage (BM x KD, row-major), zero-filled at
// rows >= r_end and depth >= n.  CPE elements a copy (async_tiles.cuh).
template <typename S, int T, int CPE>
__device__ __forceinline__ void stage(S* dst, const S* x, long long ldx, int r0, int r_end,
                                      int l0, int n) {
  using TL = Tile<T>;
  constexpr int kPerRow = TL::KD / CPE;
  static_assert(TL::KD % CPE == 0, "a copy must not straddle two rows");
  for (int e = threadIdx.x; e < TL::BM * kPerRow; e += kThreads) {
    const int r = e / kPerRow, c = (e % kPerRow) * CPE;
    const int gr = r0 + r, gl = l0 + c;
    const int valid = gr < r_end ? max(0, min(CPE, n - gl)) : 0;
    tiles::copy<S, CPE>(dst + r * TL::KD + c, valid ? x + gr * ldx + gl : x, valid);
  }
}

// acc[i][j] += sum over the slice's depth l, in order, of xs[i][l] * ws[l][j]
// for the thread's 8 x 8 tile.  xs: the thread's first row in a ring stage
// (row stride KD); ws: the slice's first row of the slab plus 4 tx (row
// stride T).  LG depth values of a row are read at once (a 4 LG- or
// 2 LG-byte shared read): LG = 4 needs 32 registers for them, LG = 2 half.
// UNROLL steps of LG are unrolled: measured on an H100, 4 paid for the
// fused kernel (one CTA an SM), while the update kernel's 128 registers
// spilled at 2 and 4 and ran as fast at 1.  A full unroll outgrows the
// instruction cache.
template <typename S, int T, int LG, int UNROLL>
__device__ __forceinline__ void fma_slice(float (&acc)[8][8], const S* xs, const float* ws) {
  constexpr int KD = Tile<T>::KD;
#pragma unroll UNROLL
  for (int l0 = 0; l0 < KD; l0 += LG) {
    float xv[8][LG];
#pragma unroll
    for (int i = 0; i < 8; ++i) tiles::read<LG>(xs + i * KD + l0, xv[i]);
#pragma unroll
    for (int dl = 0; dl < LG; ++dl) {
      float wv[8];
      tiles::read<4>(ws + (l0 + dl) * T, wv);
      tiles::read<4>(ws + (l0 + dl) * T + T / 2, wv + 4);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = __fmaf_rn(xv[i][dl], wv[j], acc[i][j]);
    }
  }
}

// Four consecutive elements of a row: v[0..4) = p[0..4) as f32 (one vector
// load when `vec`), and the store of four values cast to S.  Only the first
// `cols` (< 4 at the last column) are touched.
template <typename S>
__device__ __forceinline__ void load4(const S* p, float* v, int cols, bool vec) {
  if (vec && cols >= 4) {
    if constexpr (sizeof(S) == 4) {
      const float4 x = *reinterpret_cast<const float4*>(p);
      v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
    } else {
      const uint2 x = *reinterpret_cast<const uint2*>(p);
      v[0] = tiles::lo_bf16(x.x), v[1] = tiles::hi_bf16(x.x);
      v[2] = tiles::lo_bf16(x.y), v[3] = tiles::hi_bf16(x.y);
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (j < cols) v[j] = cqr2::to_f32(p[j]);
}

template <typename S>
__device__ __forceinline__ void store4(S* p, const S* v, int cols, bool vec) {
  if (vec && cols >= 4) {
    if constexpr (sizeof(S) == 4) {
      *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      uint2 u;
      u.x = static_cast<unsigned>(__bfloat16_as_ushort(v[0])) |
            (static_cast<unsigned>(__bfloat16_as_ushort(v[1])) << 16);
      u.y = static_cast<unsigned>(__bfloat16_as_ushort(v[2])) |
            (static_cast<unsigned>(__bfloat16_as_ushort(v[3])) << 16);
      *reinterpret_cast<uint2*>(p) = u;
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (j < cols) p[j] = v[j];
}

// Whether a (rows x cols) operand at p with row stride ld (and, over more
// than one matrix, batch stride bs) takes 4-element vector accesses.
template <typename S>
__device__ __forceinline__ bool vec4(const S* p, long long ld, long long bs, int batch) {
  constexpr long long kAlign = 4 * sizeof(S);
  return reinterpret_cast<std::uintptr_t>(p) % kAlign == 0 && ld % 4 == 0 &&
         (batch == 1 || bs % 4 == 0);
}

}  // namespace slab
