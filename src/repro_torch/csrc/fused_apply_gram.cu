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
// Arithmetic.  Every Q element is one f32 register summed with __fmaf_rn
// over l = 0..n-1 in order (slab_tiles.cuh), the chain apply_right.cu
// keeps, so Q equals apply_right(A, W) bit for bit.  Every G' element
// (i <= j) is one f32 register summed with __fmaf_rn over the rows of its
// split in order, of the cast Q, on gram.cu's split (_launch.row_split of
// (batch, m, k)), and the splits are folded in index order
// (cqr2::fold_partials), so G' equals gram(apply_right(A, W)) bit for bit,
// with or without want_q.
//
// Design, for one Gram tile (k <= 128) whose W slab fits: one CTA of 256
// threads for each (split, matrix), alone on its SM (its two accumulators
// take 239 registers).  W in f32 stays in shared memory for the whole
// split (read from L2 once per CTA).  A streams through a three-stage
// cp.async ring of depth slices, one barrier a slice; each thread owns an
// 8 x 8 tile of a BM-row chunk of Q and reads A four depths at a time
// (128-bit broadcasts) and W four columns at a time: 16 shared reads for
// 256 FMAs.  At a chunk's last slice the thread casts its Q tile, writes it
// to device memory when asked, and writes its f32 value into a chunk buffer
// X in shared memory.  The Gram of that chunk runs right after the next
// slice's barrier, so it needs no barrier of its own, and it is done before
// the barrier of the slice after, before X is written again (a chunk of one
// slice adds that barrier).  The Gram reads X with cqr2::Axis's 128-bit
// groups, as panel_cross.cuh does, and skips the 4 x 4 blocks below the
// diagonal, which fold_partials never reads: 48 FMAs a row for 64 at
// T = 128.  Q never reaches device memory without want_q.
//
// Wider Grams (k > 128, several tiles) and W slabs too large for shared
// memory take the earlier kernel (fused_partial_kernel): every
// upper-triangle tile pair is a CTA that computes its two Q column tiles
// with cqr2::apply_chunk and feeds them to cqr2::gram_accumulate; the tiles
// off the diagonal recompute their Q columns.
#include "slab_tiles.cuh"

#include <algorithm>

namespace {

constexpr int kSmemBytes = 227 << 10;  // shared memory one CTA may take

template <typename S, int T>
int fused_smem(int n) {
  using TL = slab::Tile<T>;
  return (slab::slab_rows<T>(n) + TL::BM) * T * 4 +
         slab::kStages * TL::kStageElems * static_cast<int>(sizeof(S));
}

// acc[i][j] += X[r][i] X[r][j] over the chunk's rows in order, for the
// thread's cqr2::Axis indices; blocks of four rows entirely below the
// diagonal are skipped.
template <int T>
__device__ __forceinline__ void gram_chunk(const float* X, float (&g)[T / 16][T / 16]) {
  using AX = cqr2::Axis<T>;
  constexpr int MT = AX::MT, G = AX::G;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll 8
  for (int r = 0; r < slab::Tile<T>::BM; ++r) {
    float xi[MT], xj[MT];
#pragma unroll
    for (int e = 0; e < MT / G; ++e) {
      tiles::read<G>(X + r * T + AX::index(ty, e * G), xi + e * G);
      tiles::read<G>(X + r * T + AX::index(tx, e * G), xj + e * G);
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < MT; ++j)
        if (i / G <= j / G) g[i][j] = __fmaf_rn(xi[i], xj[j], g[i][j]);
  }
}

template <typename S, int T, int CPE>
__global__ void __launch_bounds__(slab::kThreads, 1)
    fused_kernel(const S* __restrict__ a, const S* __restrict__ w, S* __restrict__ q,
                 float* __restrict__ part, int m, int n, int k, int rows_per_split) {
  using TL = slab::Tile<T>;
  using AX = cqr2::Axis<T>;
  constexpr int BM = TL::BM, KD = TL::KD, TX = TL::TX, MT = AX::MT, G = AX::G;
  extern __shared__ __align__(16) unsigned char smem[];
  const int depth = slab::slab_rows<T>(n), slices = depth / KD;
  float* wslab = reinterpret_cast<float*>(smem);  // [depth][T]
  float* X = wslab + depth * T;                    // [BM][T]: the last chunk's cast Q
  S* ring = reinterpret_cast<S*>(X + BM * T);      // [kStages][BM][KD]
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int sp = blockIdx.y, b = blockIdx.z;
  const S* ab = a + (long long)b * m * n;
  S* qb = q ? q + (long long)b * m * k : nullptr;
  const int r_begin = sp * rows_per_split;
  const int r_end = min(m, r_begin + rows_per_split);
  const int steps = (r_end - r_begin + BM - 1) / BM * slices;
  const bool vec_q = qb && slab::vec4(q, k, (long long)m * k, gridDim.z);

  slab::load_slab<S, T>(wslab, w + (long long)b * n * k, n, k, 0);
  auto issue = [&](int s) {
    if (s < steps)
      slab::stage<S, T, CPE>(ring + (s % slab::kStages) * TL::kStageElems, ab, n,
                             r_begin + s / slices * BM, r_end, (s % slices) * KD, n);
    tiles::commit();
  };
#pragma unroll
  for (int s = 0; s < slab::kStages - 1; ++s) issue(s);

  float g[MT][MT];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < MT; ++j) g[i][j] = 0.0f;
  float acc[8][8];
  for (int s = 0; s < steps; ++s) {
    tiles::wait<slab::kStages - 2>();
    __syncthreads();  // slice s, the slab and X are visible; slice s - 1's stage is free
    issue(s + slab::kStages - 1);
    const int slice = s % slices;
    if (slice == 0) {
      if (s > 0) gram_chunk<T>(X, g);  // the previous chunk
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
    }
    const S* xs = ring + (s % slab::kStages) * TL::kStageElems + ty * 8 * KD;
    slab::fma_slice<S, T, 4, 4>(acc, xs, wslab + slice * KD * T + 4 * tx);
    if (slice == slices - 1) {
      if (slices == 1) __syncthreads();  // the Gram above still reads X
      const int r0 = r_begin + s / slices * BM + ty * 8;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = h * (T / 2) + 4 * tx;
          S v[4];
          float x[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            v[j] = cqr2::from_f32<S>(acc[i][4 * h + j]);
            x[j] = cqr2::to_f32(v[j]);
          }
          *reinterpret_cast<float4*>(X + (ty * 8 + i) * T + c) =
              make_float4(x[0], x[1], x[2], x[3]);
          if (qb && r0 + i < r_end && c < k)
            slab::store4<S>(qb + (long long)(r0 + i) * k + c, v, k - c, vec_q);
        }
      }
    }
  }
  __syncthreads();
  gram_chunk<T>(X, g);
  tiles::wait<0>();

  float* out = part + ((long long)b * gridDim.y + sp) * k * k;
  const int ty16 = threadIdx.x / 16, tx16 = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int gi = AX::index(ty16, i);
#pragma unroll
    for (int j = 0; j < MT; ++j) {
      const int gj = AX::index(tx16, j);
      if (i / G <= j / G && gi < k && gj < k) out[(long long)gi * k + gj] = g[i][j];
    }
  }
}

template <typename S, int T, int CPE>
cudaError_t launch_slab(const S* a, const S* w, S* q, float* part, int batch, int m, int n,
                        int k, int rows_per_split, int splits, cudaStream_t stream) {
  const int smem = fused_smem<S, T>(n);
  cudaError_t err = cudaFuncSetAttribute(fused_kernel<S, T, CPE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  fused_kernel<S, T, CPE><<<dim3(1, splits, batch), slab::kThreads, smem, stream>>>(
      a, w, q, part, m, n, k, rows_per_split);
  return cudaGetLastError();
}

template <typename S, int T>
cudaError_t slab_by_copy(const S* a, const S* w, S* q, float* part, int batch, int m, int n,
                         int k, int rows_per_split, int splits, cudaStream_t stream) {
  return tiles::by_copy(a, n, (long long)m * n, batch, [&](auto cpe) {
    return launch_slab<S, T, decltype(cpe)::value>(a, w, q, part, batch, m, n, k,
                                                   rows_per_split, splits, stream);
  });
}

// -- the tile-pair kernel, for k > 128 or a W slab too large --------------------

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
cudaError_t launch_pairs(const S* a, const S* w, S* q, float* part, int batch, int m, int n,
                         int k, int rows_per_split, int splits, cudaStream_t stream) {
  const int nt = (k + T - 1) / T;
  const dim3 grid(nt * (nt + 1) / 2, splits, batch);
  fused_partial_kernel<S, T>
      <<<grid, cqr2::kThreads, 0, stream>>>(a, w, q, part, m, n, k, rows_per_split);
  return cudaGetLastError();
}

template <typename S, int T>
cudaError_t launch(const S* a, const S* w, S* q, float* part, int batch, int m, int n, int k,
                   int rows_per_split, int splits, cudaStream_t stream) {
  if ((k + T - 1) / T == 1 && fused_smem<S, T>(n) <= kSmemBytes)
    return slab_by_copy<S, T>(a, w, q, part, batch, m, n, k, rows_per_split, splits, stream);
  return launch_pairs<S, T>(a, w, q, part, batch, m, n, k, rows_per_split, splits, stream);
}

template <typename S>
cudaError_t dispatch(const S* a, const S* w, S* q, float* part, float* g, int batch, int m,
                     int n, int k, int rows_per_split, int splits, cudaStream_t stream) {
  cudaError_t err;
  switch (cqr2::tile_for(k)) {
    case 32:
      err = launch<S, 32>(a, w, q, part, batch, m, n, k, rows_per_split, splits, stream);
      break;
    case 64:
      err = launch<S, 64>(a, w, q, part, batch, m, n, k, rows_per_split, splits, stream);
      break;
    default:
      err = launch<S, 128>(a, w, q, part, batch, m, n, k, rows_per_split, splits, stream);
  }
  if (err != cudaSuccess) return err;
  return cqr2::launch_fold(part, g, batch, splits, k, stream);
}

}  // namespace

// a: (batch, m, n); w: (batch, n, k); q: (batch, m, k) or null (no Q
// written); part: (batch, splits, k, k) f32 scratch; g: (batch, k, k) f32.
// a, w and q share one storage type (f32 or bf16).  Returns the first
// launch's cudaError_t.
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
