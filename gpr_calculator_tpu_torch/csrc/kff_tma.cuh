// The Tensor Memory Accelerator path shared by kff_tri.cu and the mode
// kernels (kff_mma.cuh): mbarriers, and the tensor maps the TMA reads
// through, encoded on the host and kept.  Only those sources include it
// (with <cuda.h>): kff_rect.cu's kernels read 2.5-8 % slower in a
// translation unit that holds the tensor-map path (PERF.md).
#pragma once

#include <cuda.h>
#include <string.h>

#include <mutex>

#include "kff_common.cuh"

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// The producer's arrive, announcing the bytes its copies will deliver.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Wait until the phase of parity ``parity`` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// A tiled tensor map of ``rank`` dimensions over the tensor at ``ptr``
// (extents dims, byte strides of dimensions 1.., boxes of box), zeros past
// the extents.  cuTensorMapEncodeTiled is looked up with
// cudaGetDriverEntryPoint, so the library links nothing but the CUDA
// runtime.  A map depends on these arguments alone, so it is encoded once
// per (device, arguments) and kept (the last 32 in each source): a launch
// on a tensor seen before, e.g. every launch of a timing loop or the
// training side of every served block, reuses it.  Returns 0, or -1 when
// the encoder is missing or refuses the arguments.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

struct MapKey {
  int device, dtype, rank, swizzle;
  const void* ptr;
  cuuint64_t dims[5], strides[4];
  cuuint32_t box[5];
};

inline int tensor_map(CUtensorMapDataType dtype, int rank, const void* ptr,
                      const cuuint64_t* dims, const cuuint64_t* strides,
                      const cuuint32_t* box, CUtensorMapSwizzle swizzle,
                      CUtensorMap* map) {
  static std::mutex lock;
  static EncodeTiled encode = nullptr;
  static MapKey keys[32];
  static CUtensorMap maps[32];
  static int n_kept = 0, next_slot = 0;
  MapKey key;
  memset(&key, 0, sizeof key);   // the padding takes part in the compare
  if (cudaGetDevice(&key.device) != cudaSuccess) return -1;
  key.dtype = (int)dtype;
  key.rank = rank;
  key.swizzle = (int)swizzle;
  key.ptr = ptr;
  for (int d = 0; d < rank; ++d) {
    key.dims[d] = dims[d];
    key.box[d] = box[d];
    if (d) key.strides[d - 1] = strides[d - 1];
  }
  std::lock_guard<std::mutex> guard(lock);
  for (int i = 0; i < n_kept; ++i)
    if (memcmp(&keys[i], &key, sizeof key) == 0) {
      *map = maps[i];
      return 0;
    }
  if (!encode) {
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", (void**)&encode,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess || !encode) {
      encode = nullptr;
      return -1;
    }
  }
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  if (encode(map, dtype, rank, const_cast<void*>(ptr), dims, strides, box,
             unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return -1;
  keys[next_slot] = key;
  maps[next_slot] = *map;
  next_slot = (next_slot + 1) % 32;
  if (n_kept < 32) ++n_kept;
  return 0;
}

}  // namespace
