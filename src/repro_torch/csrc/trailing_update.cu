// One blocked-QR trailing update: A_new = A - Q.W in f32, cast to the
// storage type, and with next_width > 0 the lookahead
// S = A_new[:, :next_width]^T A_new of the stored rows.
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
// Arithmetic.  Each A_new element is A minus one f32 register summed with
// __fmaf_rn over l = 0..b-1 in order (slab_tiles.cuh), with one __fsub_rn
// and one cast; it does not depend on the trailing width or the tiling, so
// the fixed-shape pipeline (padded width) and the eager driver (live width)
// store the same bits.  S is panel_cross.cuh's sweep over the stored A_new,
// on _launch.cross_split's split, so S equals panel_cross(A_new) bit for
// bit by construction.
//
// Design: two sweeps in one call, each computing every element once.
//   1. update_kernel: a persistent grid of two 256-thread CTAs an SM (128
//      registers, 112 KiB of shared memory each) walks the (matrix, column
//      tile, row block) tiles of A_new, row blocks fastest, in contiguous
//      ranges.  W's column tile stays in shared memory as an f32 slab for
//      all the row blocks of a range; Q streams through a three-stage
//      cp.async ring of depth slices (16 bytes a copy where Q's rows allow,
//      zero-filled past the last row and depth), one barrier a slice, so
//      the next two slices' copies are in flight during a slice's FMAs.
//      Each thread owns an 8 x 8 tile and reads Q two depths at a time
//      (64-bit broadcasts) and W four columns at a time (128-bit): 24
//      shared reads for 256 FMAs.  Measured on an H100, one CTA an SM at
//      four depths a read (168 registers) ran 24% slower.  The epilogue reads its A tile, subtracts
//      and writes A_new through row strides, vectorized where they allow.
//   2. with next_width > 0, panel_cross.cuh's sweep over the stored A_new
//      and the in-order fold of its split partials.
// The earlier design formed S in the same sweep as the update, which made
// every CTA off S's row tile recompute that tile's A_new: 5/3 of the
// update's work at n_t = 384.  Reading A_new back once costs 4 m n_t bytes,
// which the cross sweep's FMAs hide.  A is read and A_new is written
// through row strides: the blocked drivers pass the trailing block as a
// column slice, and the fixed-shape pipeline writes A_new into the leading
// columns of a wider buffer, with no copy.
#include "panel_cross.cuh"
#include "slab_tiles.cuh"

#include <algorithm>

namespace {

constexpr int kSlabBytes = 64 << 10;  // shared memory for W's slab

template <typename S, int T>
int update_smem(int b) {
  return slab::slab_rows<T>(b) * T * 4 +
         slab::kStages * slab::Tile<T>::kStageElems * static_cast<int>(sizeof(S));
}

template <typename S, int T, int CPE>
__global__ void __launch_bounds__(slab::kThreads, 2)
    update_kernel(const S* __restrict__ a, const S* __restrict__ q, const S* __restrict__ w,
                  S* __restrict__ out, int batch, int m, int b, int nt, long long lda,
                  long long a_bs, long long ldo, long long o_bs) {
  using TL = slab::Tile<T>;
  constexpr int BM = TL::BM, KD = TL::KD, TX = TL::TX, RM = TL::RM;
  extern __shared__ __align__(16) unsigned char smem[];
  const int depth = slab::slab_rows<T>(b), slices = depth / KD;
  float* wslab = reinterpret_cast<float*>(smem);                             // [depth][T]
  S* ring = reinterpret_cast<S*>(smem + (size_t)depth * T * sizeof(float));  // [kStages][BM][KD]
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int row_blocks = (m + BM - 1) / BM, col_tiles = (nt + T - 1) / T;
  const long long tiles_total = (long long)batch * col_tiles * row_blocks;
  const long long t_end = tiles_total * (blockIdx.x + 1) / gridDim.x;
  const bool vec_a = slab::vec4(a, lda, a_bs, batch);
  const bool vec_o = slab::vec4(out, ldo, o_bs, batch);

  for (long long t = tiles_total * blockIdx.x / gridDim.x; t < t_end;) {
    const long long group = t / row_blocks;  // (matrix, column tile)
    const long long seg_end = min(t_end, (group + 1) * row_blocks);
    const int bb = (int)(group / col_tiles), c0 = (int)(group % col_tiles) * T;
    const int rb0 = (int)(t - group * row_blocks);
    const int steps = (int)(seg_end - t) * slices;
    const S* qb = q + (long long)bb * m * b;
    const S* ab = a + (long long)bb * a_bs;
    S* ob = out + (long long)bb * o_bs;

    __syncthreads();  // the previous range's reads of the slab and the ring are done
    slab::load_slab<S, T>(wslab, w + (long long)bb * b * nt, b, nt, c0);
    auto issue = [&](int s) {
      if (s < steps)
        slab::stage<S, T, CPE>(ring + (s % slab::kStages) * TL::kStageElems, qb, b,
                               (rb0 + s / slices) * BM, m, (s % slices) * KD, b);
      tiles::commit();
    };
#pragma unroll
    for (int s = 0; s < slab::kStages - 1; ++s) issue(s);

    float acc[RM][8];
    for (int s = 0; s < steps; ++s) {
      tiles::wait<slab::kStages - 2>();
      __syncthreads();  // slice s (and the slab) is visible; slice s - 1's stage is free
      issue(s + slab::kStages - 1);
      const int slice = s % slices;
      if (slice == 0) {
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
      }
      const S* xs = ring + (s % slab::kStages) * TL::kStageElems + ty * RM * KD;
      slab::fma_slice<S, T, 2, 1>(acc, xs, wslab + slice * KD * T + 4 * tx);
      if (slice == slices - 1) {
        const int r0 = (rb0 + s / slices) * BM + ty * RM;
#pragma unroll
        for (int i = 0; i < RM; ++i) {
          if (r0 + i >= m) break;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int gc = c0 + h * (T / 2) + 4 * tx;
            if (gc >= nt) continue;
            float av[4];
            S v[4];
            slab::load4<S>(ab + (long long)(r0 + i) * lda + gc, av, nt - gc, vec_a);
#pragma unroll
            for (int j = 0; j < 4; ++j)
              v[j] = cqr2::from_f32<S>(__fsub_rn(av[j], acc[i][4 * h + j]));
            slab::store4<S>(ob + (long long)(r0 + i) * ldo + gc, v, nt - gc, vec_o);
          }
        }
      }
    }
    t = seg_end;
  }
  tiles::wait<0>();
}

template <typename S, int T, int CPE>
cudaError_t launch_update(const S* a, const S* q, const S* w, S* out, int batch, int m, int b,
                          int nt, long long lda, long long a_bs, long long ldo, long long o_bs,
                          cudaStream_t stream) {
  const int smem = update_smem<S, T>(b);
  cudaError_t err = cudaFuncSetAttribute(update_kernel<S, T, CPE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int device = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, update_kernel<S, T, CPE>,
                                                        slab::kThreads, smem);
  if (err != cudaSuccess) return err;
  const long long tiles_total = (long long)batch * ((nt + T - 1) / T) *
                                ((m + slab::Tile<T>::BM - 1) / slab::Tile<T>::BM);
  const int grid = (int)std::min(tiles_total, (long long)std::max(1, per_sm) * sms);
  update_kernel<S, T, CPE><<<grid, slab::kThreads, smem, stream>>>(a, q, w, out, batch, m, b, nt,
                                                                   lda, a_bs, ldo, o_bs);
  return cudaGetLastError();
}

template <typename S, int T>
cudaError_t update_by_copy(const S* a, const S* q, const S* w, S* out, int batch, int m, int b,
                           int nt, long long lda, long long a_bs, long long ldo, long long o_bs,
                           cudaStream_t stream) {
  return tiles::by_copy(q, b, (long long)m * b, batch, [&](auto cpe) {
    return launch_update<S, T, decltype(cpe)::value>(a, q, w, out, batch, m, b, nt, lda, a_bs,
                                                     ldo, o_bs, stream);
  });
}

template <typename S>
cudaError_t dispatch(const S* a, const S* q, const S* w, S* out, float* part, float* s, int batch,
                     int m, int b, int nt, int next_width, long long lda, long long a_bs,
                     long long ldo, long long o_bs, int rows_per_split, int splits,
                     cudaStream_t stream) {
  // Column tile: 128 (or less for narrow n_t), halved until W's slab fits.
  const int t = cqr2::tile_for(nt);
  cudaError_t err;
  if (t == 128 && slab::slab_rows<128>(b) * 128 * 4 <= kSlabBytes)
    err = update_by_copy<S, 128>(a, q, w, out, batch, m, b, nt, lda, a_bs, ldo, o_bs, stream);
  else if (t >= 64 && slab::slab_rows<64>(b) * 64 * 4 <= kSlabBytes)
    err = update_by_copy<S, 64>(a, q, w, out, batch, m, b, nt, lda, a_bs, ldo, o_bs, stream);
  else
    err = update_by_copy<S, 32>(a, q, w, out, batch, m, b, nt, lda, a_bs, ldo, o_bs, stream);
  if (err != cudaSuccess || next_width == 0) return err;
  return cross::panel_cross(static_cast<const S*>(out), part, s, batch, m, nt, next_width, ldo,
                            o_bs, rows_per_split, splits, stream);
}

}  // namespace

// a: (batch, m, nt) with row stride lda and batch stride a_bs; q: (batch,
// m, b) and w: (batch, b, nt) contiguous; out: (batch, m, nt) with row
// stride ldo and batch stride o_bs (elements); one storage type (f32 or
// bf16) for all four.  With next_width > 0, part: (batch, splits,
// next_width, nt) f32 scratch and s: (batch, next_width, nt) f32; otherwise
// both may be null.  Returns the first launch's cudaError_t.
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
