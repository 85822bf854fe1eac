// The covariance kernels of this directory, and what they share.  Each
// .cu is compiled by an nvcc of its own and all are linked into one library
// with a plain C interface, loaded with ctypes by
// gpr_calculator_tpu_torch/ops/kff.py:
//   kff_rect.cu     rect_kernel: K2 and K3 in highest
//   kff_tri.cu      tri_kernel: K1 in highest (a TMA ring)
//   kff_rect_mma.cu rect_mma_kernel: K2 and K3 in the bf16 modes
//   kff_tri_mma.cu  tri_mma_kernel: K1 in the bf16 modes
//   kff_f64.cu      tri_f64_kernel, rect_f64_kernel: K1, K2 and K3 in
//                   float64
//   kff_common.cuh  this file: the operands and the arithmetic every kernel
//                   computes, the tile and chunk geometry, the kernel
//                   families and coefficient sets, the per-pair powers, the
//                   upper-triangle tile index, the cp.async helpers, the
//                   chunk element ranges of the element skip, and the
//                   shared-memory set-up of the ring kernels
//   kff_tma.cuh     mbarriers and the tensor maps the TMA reads through
//   kff_mma.cuh     the tensor-core path of the two mode kernels
// Each source keeps its own kernels, loop bodies and extern "C" entry
// points.
//
// Force-force and energy-force covariance blocks of the RBF and Dot
// many-body kernels for sm_90a: exact fp32 FMA on CUDA cores ("highest")
// or bf16 tensor-core products with fp32 sums (the "bf16x4" and "bf16"
// matmul precisions).  They replace the Pallas TPU kernels of
// gpr_calculator_tpu/ops/kff_pallas.py:
//   kff_tri  (K1) <- _kff_kernel_tri  (kff_pallas.py:282), symmetric K_FF
//   kef_rect (K2) <- _kef_kernel      (kff_pallas.py:748), K_EF
//   kff_rect (K3) <- _kff_kernel      (kff_pallas.py:269), rectangular K_FF
// each in the variants (suffix):
//   _dual   dual=True: K and dK/dgamma from one set of env-pair dot
//           products and one expf (_coeff_sets kff_pallas.py:199-206,
//           kff_pallas.py:785-791), for the analytic NLL gradient
//   _deriv  deriv=True: dK/dgamma alone (the same coefficient sets)
//   _dot    kind="dot" (_coeff_sets kff_pallas.py:189-192, :780-781)
// and each in the three matmul precisions of kff_pallas.py:38-63
// (_pair_blocks :151, _lhs_rhs :394): no further suffix for highest, then
// _bf16x4 and _bf16.  For float64 operands (the JAX package's default
// x64 mode, whose XLA builds kff_self, kef and kff of ops/kernels.py:429,
// :215, :365 the Pallas gate leaves float64 to) each also has an _f64
// kernel (kff_f64.cu) that computes the same sums in double.
//
// Operands (built once per block side by ops/kff.py, so every block of one
// training covariance reads the same rounded values):
//   X  (4, N, 32) f32 (highest), or its bf16 parts (P, 4, N, 32): P = 2,
//      [hi; lo] (bf16x4), or P = 1, [bf16(X)] (bf16).  Rows [u; Jt_x;
//      Jt_y; Jt_z] per environment, with u = x/|x| and Jt = J - (J.u) u;
//      descriptor width zero-padded to 32.  The energy side has one row
//      per environment, (N, 32) or (P, N, 32).
//   re (2, N)     f32: [rinv or weight, element id]; 0 weight = padding
// Environments of point p are rows p*B .. p*B+B-1.  For one env pair
// (a in lhs point p, b in rhs point q):
//   c = u_a.u_b,  p1_u = Jt_a,u.u_b,  p2_v = u_a.Jt_b,v,  m_uv = Jt_a,u.Jt_b,v
//   RBF: k = s2 exp((c^z - 1) g),  A = k g z c^(z-1),
//        B = k g (z(z-1) c^(z-2) + (z c^(z-1))^2 g)
//   Dot: k = s2 (c^z + s0^2),      A = s2 z c^(z-1),  B = s2 z(z-1) c^(z-2)
//   K_FF[(p,u),(q,v)] += w (A m_uv + B p1_u p2_v),  w = rinv_a rinv_b [same]
//   K_EF[p,(q,v)]     += w A0 p2_v,  A0 = -A,       w = w_a rinv_b [same]
// with [same] = [ele_a == ele_b].  The Dot force blocks need s2 alone: s0
// enters K_EE only, and there is no expf.  The dK/dg planes (RBF only)
// take dA = A (D-1) + k z c^(z-1), dB = B (D-1) + k (z(z-1) c^(z-2)
// + 2 (z c^(z-1))^2 g) and dA0 = A0 (D-1) - k z c^(z-1), with D = c^z.
// In bf16x4 each dot product is hi.hi + hi.lo + lo.hi + lo.lo: the exact
// product of the (hi + lo) values with fp32 sums, so every block is the
// exact Gram of the same rounded rows and the covariance stays PSD; bf16
// takes the one product of the rounded rows.
//
// What bounds them on the card: each env pair costs 16 (K_FF) or 4 (K_EF)
// length-32 dot products -- a thin-k product of the operand rows -- plus
// the coefficients (one expf for RBF, none for Dot) and the assembly.  The
// operands are small (49 MB at 3000 force points x 32 envs in f32) and
// stay in L2, so the kernels are bound by the dot products (fp32 FMA, or
// the tensor cores' bf16 rate) and the assembly, not device memory.  Every
// kernel skips the env chunks whose element ranges cannot meet (the
// operand builders sort each point's envs by element on large sides), and
// a skipped pair is one whose every weight is zero, which the assembly
// never adds.
//
// The order of the sums (the same in every kernel of a mode, so that the
// mode kernels give one bit pattern whatever skips): a thread owns the
// 2 x 2 env micro-tile of one point pair in each chunk pair (lhs envs
// 2g, 2g + 1, rhs envs 2q, 2q + 1 of the chunks); it adds the env pairs
// e = ia * 2 + ib in order, K_FF[u][v] += A m_uv + (B p1_u) p2_v, over the
// chunk pairs in nested order (lhs chunk outer), then the lanes of the
// point pair are summed by shuffles.  On the tensor cores a dot product is
// summed k half by k half, each (lhs part, rhs part) product in order.
//
// The tile-range form of K1 (the mesh-sharded training build): the
// kff_tri* entry points take a first tile k0 and a tile count nk of the
// linear upper-triangle index k = J (J + 1) / 2 + I and launch nk blocks,
// block b computing tile k0 + b.  It replaces the cells= / owned= form of
// _kff_kernel_tri (kff_pallas.py:592-596, :703-711) and its callers in
// gpr_calculator_tpu/parallel/sharded_kernels.py: each shard launches its
// contiguous range into an output its wrapper has zeroed, every element is
// written by exactly one shard, and the sum over shards is the single
// launch bit for bit (the tile body does not know the range).  The whole
// range (k0 = 0, nk = all tiles) is the single-card call.
//
// Every entry point of the library: (X1, re1, m1, B1, X2, re2, m2, B2,
// out, outd, sigma2, gamma, zeta, k0, nk, ldo, trans, stream), with re,
// out, sigma2 and gamma float (double in the _f64 entry points).  K_FF: out
// (3 m1, 3 m2); K_EF: out (m1, 3 m2) from energy operands (U1, w1 =
// [valid/count, element]) against force operands; ldo is the leading
// dimension of out and outd (at least 3 m2).  outd receives dK/dgamma for
// _dual and is unused otherwise; gamma is unused by _dot.  K1 (kff_tri*)
// takes re2 = re1, m2 = m1, B2 = B1, and X2 = X1 in the bf16 modes and in
// float64, but in highest X2 = the k-major copy of (X1, re1) (kff_tri.cu);
// it writes tiles [k0, k0 + nk) of the upper triangle and their
// transposes, nothing else: the whole range gives an exactly symmetric out
// (and outd), a part of it needs out zeroed by the caller.  k0 and nk are unused by the rectangular
// kernels.  trans != 0 (the kef_rect* kernels of every mode; K1 and K3
// refuse it) stores K_EF transposed, out (3 m2, m1) with ldo at least m1.
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

// c^(z-1) and z(z-1) c^(z-2) for an integer exponent z >= 1, in the
// scalar type T of the kernel (float, or double for the _f64 kernels).
template <typename T>
__device__ __forceinline__ void powers(T c, int zeta, T& d1, T& dm2) {
  if (zeta == 1) {
    d1 = T(1);
    dm2 = T(0);
  } else if (zeta == 2) {
    d1 = c;
    dm2 = T(1);
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
// T: the scalar type of re and of the ranges (float, double; fmin and
// fmax have overloads of both).
template <int NEX, int CBX, typename T = float>
__device__ __forceinline__ void chunk_range(const T* __restrict__ re,
                                            int m, int B, int p0, int c,
                                            T* __restrict__ rng) {
  const long long N = (long long)m * B;
  const int lane = threadIdx.x & 31;
  T lo = INFINITY, hi = -INFINITY;
  for (int env = lane; env < NEX; env += 32) {
    const int p = p0 + env / CBX;
    const int e = c * CBX + env % CBX;
    if (p < m && e < B) {
      const long long n = (long long)p * B + e;
      if (re[n] != T(0)) {
        const T el = re[N + n];
        lo = fmin(lo, el);
        hi = fmax(hi, el);
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = fmin(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = fmax(hi, __shfl_xor_sync(0xffffffffu, hi, o));
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
// two of 98 KB (K1) in highest, two of up to 104 KB in the modes, must
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
cudaError_t tri_mma_init();
cudaError_t f64_init();
}  // namespace kff
