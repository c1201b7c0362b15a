// Hopper TMA plumbing shared by the kernels that stream int8 tiles into wgmma
// (pack_score.cu's K1 and fastdot.cu's product): mbarriers, 3-D TMA loads,
// the matrix descriptor of a 128-byte-swizzled K-major tile, and the host
// side that encodes a tensor map for such loads.
//
// Every box is kTmaBoxK bytes of K wide: one 128-byte swizzled row, so a
// kernel's K step per stage is kTmaBoxK.  The tensor map encoder is a
// driver-API function fetched through the runtime, so that the library links
// without libcuda.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums
#include <cuda_runtime.h>

#include <cstdint>

namespace fhe {

constexpr int kTmaBoxK = 128;  // K bytes a box: one row of the 128-byte swizzle

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Wait until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One TMA box of a 3-D tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma matrix descriptor of a K-major tile whose 128-byte rows TMA wrote with
// the 128-byte swizzle: start address >> 4 (bits 0-13), leading byte offset
// (unused for swizzled K-major, 1 by convention; bits 16-29), 1024 bytes
// between 8-row groups >> 4 (bits 32-45), swizzle mode 1 = 128 B (bits 62-63).
// Stepping K by 32 bytes inside the row adds 32 to the start address.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma instructions.
template <int N>
__device__ __forceinline__ void fence_regs(int32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, fetched once through the runtime; nullptr when the
// driver does not have it.
inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q{};
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (limbs, rows, k) int8 tensor, k innermost, read in (1, box_rows, kTmaBoxK)
// boxes with the 128-byte swizzle; rows past the end read as zeros.
inline bool encode(EncodeTiled enc, CUtensorMap* map, const void* data, int k, int rows,
                   int limbs, int box_rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(k), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(limbs)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(k),
                                 static_cast<cuuint64_t>(k) * static_cast<cuuint64_t>(rows)};
  const cuuint32_t box[3] = {kTmaBoxK, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(data), dims, strides, box,
             unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace fhe
