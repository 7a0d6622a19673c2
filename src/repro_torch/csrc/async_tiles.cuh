// Asynchronous staging and vectorized shared reads for the kernels that
// stream a tall operand through shared memory in a ring of stages
// (panel_cross.cu, apply_right.cu).
//
// A copy moves CPE elements of the storage type S from global to shared
// memory.  At 16 or 4 bytes it is a cp.async whose source size covers only
// the valid elements: the hardware zero-fills the rest, so ragged rows and
// columns need no second pass.  A bf16 operand whose rows sit on odd
// addresses admits no cp.async size and takes plain loads and stores (CPE
// = 1, 2 bytes), still into the same ring.  The values staged are the raw
// elements; reads convert bf16 to f32 exactly.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace tiles {

template <typename S, int CPE>
__device__ __forceinline__ void copy(S* dst, const S* src, int valid) {
  constexpr int kBytes = CPE * static_cast<int>(sizeof(S));
  static_assert(kBytes == 16 || kBytes == 4 || (kBytes == 2 && CPE == 1), "copy size");
  if constexpr (kBytes == 2) {
    *dst = valid ? *src : __ushort_as_bfloat16(static_cast<unsigned short>(0));
  } else {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    const int src_bytes = valid * static_cast<int>(sizeof(S));
    if constexpr (kBytes == 16)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
                   "r"(src_bytes));
    else
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
                   "r"(src_bytes));
  }
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// out[0..G) = p[0..G) as f32 (G = 4 or 2), one shared read of 4 * G (f32)
// or 2 * G (bf16) bytes; p is aligned to that size.
template <int G>
__device__ __forceinline__ void read(const float* p, float* out) {
  static_assert(G == 4 || G == 2, "read size");
  if constexpr (G == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x, out[1] = v.y, out[2] = v.z, out[3] = v.w;
  } else {
    const float2 v = *reinterpret_cast<const float2*>(p);
    out[0] = v.x, out[1] = v.y;
  }
}

__device__ __forceinline__ float lo_bf16(unsigned u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float hi_bf16(unsigned u) { return __uint_as_float(u & 0xffff0000u); }

template <int G>
__device__ __forceinline__ void read(const __nv_bfloat16* p, float* out) {
  static_assert(G == 4 || G == 2, "read size");
  if constexpr (G == 4) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    out[0] = lo_bf16(v.x), out[1] = hi_bf16(v.x), out[2] = lo_bf16(v.y), out[3] = hi_bf16(v.y);
  } else {
    const unsigned v = *reinterpret_cast<const unsigned*>(p);
    out[0] = lo_bf16(v), out[1] = hi_bf16(v);
  }
}

// Calls launch(std::integral_constant<int, CPE>) with the widest copy that
// every row of a strided operand admits: 16 bytes, else 4, else (bf16 on
// odd addresses) one element.  The base, the row stride ld and, with more
// than one matrix, the batch stride (in elements) must be aligned to it.
template <typename S, typename Launch>
cudaError_t by_copy(const S* base, long long ld, long long batch_stride, int batch,
                    Launch&& launch) {
  constexpr int es = sizeof(S);
  const auto p = reinterpret_cast<std::uintptr_t>(base);
  auto fits = [&](int bytes) {
    return p % bytes == 0 && (ld * es) % bytes == 0 &&
           (batch == 1 || (batch_stride * es) % bytes == 0);
  };
  if (fits(16)) return launch(std::integral_constant<int, 16 / es>{});
  if (fits(4)) return launch(std::integral_constant<int, 4 / es>{});
  if constexpr (es == 2) return launch(std::integral_constant<int, 1>{});
  return cudaErrorMisalignedAddress;
}

}  // namespace tiles
