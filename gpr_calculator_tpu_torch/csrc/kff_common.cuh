// Shared by the covariance-kernel sources of this directory (one library,
// ops/kff.py build()): the tile and chunk geometry, the kernel families and
// coefficient sets, the per-pair powers, the upper-triangle tile index, the
// cp.async helpers, the chunk element ranges of the element skip, and the
// shared-memory set-up of the kernels whose ring lies in dynamic shared
// memory.  Each source keeps its own kernels and extern "C" entry points;
// see kff_cov.cu for the operand layout and the arithmetic they share.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int DP = 32;        // padded descriptor width
constexpr int TP = 8;         // points per tile side
constexpr int CB = 4;         // envs per point per chunk
constexpr int NE = TP * CB;   // envs per chunk per side
constexpr int NT = 256;       // threads per block: 8 warps
constexpr int RS = DP + 8;    // bf16 row stride in shared memory (80 bytes:
                              // conflict-free fragment loads)
constexpr int RBF = 0;        // kernel families (template KIND)
constexpr int DOT = 1;
constexpr int KONLY = 0;      // coefficient sets (template SEL): K,
constexpr int DUAL = 1;       // K and dK/dgamma,
constexpr int DERIV = 2;      // dK/dgamma alone
constexpr int BF16X4 = 1;     // matmul precision of the tensor-core kernels
constexpr int BF16 = 2;       // (template PREC; highest, 0, runs on fp32)

// The upper-triangle tile (I <= J) of linear index k = J (J + 1) / 2 + I.
__device__ __forceinline__ void tri_tile(long long k, int& I, int& J) {
  long long j = (long long)((sqrt(8.0 * (double)k + 1.0) - 1.0) * 0.5);
  while ((j + 1) * (j + 2) / 2 <= k) ++j;
  while (j * (j + 1) / 2 > k) --j;
  J = (int)j;
  I = (int)(k - j * (j + 1) / 2);
}

// c^(z-1) and z(z-1) c^(z-2) for an integer exponent z >= 1.
__device__ __forceinline__ void powers(float c, int zeta, float& d1,
                                       float& dm2) {
  if (zeta == 1) {
    d1 = 1.f;
    dm2 = 0.f;
  } else if (zeta == 2) {
    d1 = c;
    dm2 = 1.f;
  } else {
    dm2 = c;
    for (int i = 0; i < zeta - 3; ++i) dm2 *= c;
    d1 = dm2 * c;
  }
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int n = valid ? 4 : 0;   // 0 source bytes: the word is zero-filled
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// [weight, element] of the same envs, in env order: sre[row * NEX + env].
template <int NEX, int CBX>
__device__ __forceinline__ void stage_re_async(const float* __restrict__ re,
                                               int m, int B, int p0, int e0,
                                               float* __restrict__ sre) {
  const long long N = (long long)m * B;
  for (int idx = threadIdx.x; idx < 2 * NEX; idx += NT) {
    const int row = idx / NEX;
    const int env = idx % NEX;
    const int p = p0 + env / CBX;
    const int e = e0 + env % CBX;
    const bool ok = p < m && e < B;
    cp_async4(sre + idx, ok ? re + row * N + (long long)p * B + e : re, ok);
  }
}

// Element range [lo, hi] of the envs with a weight in chunk c of one
// side's tile, by one warp; (+inf, -inf) for a chunk of padding alone.
template <int NEX, int CBX>
__device__ __forceinline__ void chunk_range(const float* __restrict__ re,
                                            int m, int B, int p0, int c,
                                            float* __restrict__ rng) {
  const long long N = (long long)m * B;
  const int lane = threadIdx.x & 31;
  float lo = INFINITY, hi = -INFINITY;
  for (int env = lane; env < NEX; env += 32) {
    const int p = p0 + env / CBX;
    const int e = c * CBX + env % CBX;
    if (p < m && e < B) {
      const long long n = (long long)p * B + e;
      if (re[n] != 0.f) {
        const float el = re[N + n];
        lo = fminf(lo, el);
        hi = fmaxf(hi, el);
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  if (lane == 0) {
    rng[2 * c] = lo;
    rng[2 * c + 1] = hi;
  }
}

// D += A B (16 x 8 x 16, bf16 in, fp32 sums) on the tensor cores.
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

inline int tiles(int m) { return (m + TP - 1) / TP; }

// Chunk ranges in dynamic shared memory: 8 bytes a chunk, up to 2048
// chunks on the two sides of a block.
constexpr size_t kRangeBytes = 16384;

// Raise a kernel's dynamic shared-memory limit to ``bytes`` and ask for
// the largest carveout: two blocks of 75 KB (K3), three of 56 KB (K2) or
// two of 98 KB (K1) in highest, two of up to 84 KB in the modes, must
// fit an SM.
template <typename Kernel>
cudaError_t smem_init(Kernel kernel, size_t bytes) {
  cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (rc != cudaSuccess) return rc;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

}  // namespace

// The shared-memory limits of each source's ring kernels on the current
// device (defined beside the kernels; kff_rect_init, in kff_rect.cu, calls
// them all).  Each returns the first CUDA error.
namespace kff {
cudaError_t rect_highest_init();
cudaError_t tri_highest_init();
cudaError_t rect_mma_init();
}  // namespace kff
