// Force-force and energy-force covariance blocks of the RBF and Dot
// many-body kernels for sm_90a: exact fp32 FMA on CUDA cores ("highest")
// or bf16 tensor-core products with fp32 sums (the "bf16x4" and "bf16"
// matmul precisions).  Plain C interface, loaded from Python with ctypes
// (gpr_calculator_tpu_torch/ops/kff.py).
//
// Replaces the Pallas TPU kernels of gpr_calculator_tpu/ops/kff_pallas.py:
//   kff_tri  (K1) <- _kff_kernel_tri  (kff_pallas.py:282), symmetric K_FF
//   kef_rect (K2) <- _kef_kernel      (kff_pallas.py:748), K_EF
//   kff_rect (K3) <- _kff_kernel      (kff_pallas.py:269), rectangular K_FF
// each in the variants (suffix):
//   _dual   dual=True: K and dK/dgamma from one set of env-pair dot
//           products and one expf (_coeff_sets kff_pallas.py:199-206,
//           kff_pallas.py:785-791), for the analytic NLL gradient
//   _deriv  deriv=True: dK/dgamma alone (the same coefficient sets)
//   _dot    kind="dot" (_coeff_sets kff_pallas.py:189-192, :780-781)
// (K1, K2: all three; K3: all three) and each in the three matmul
// precisions of kff_pallas.py:38-63 (_pair_blocks :151, _lhs_rhs :394):
// no further suffix for highest, then _bf16x4 and _bf16.
//
// Three kernels.  cov_kernel (this note) serves K1, K2 and K3 in the bf16
// modes (24 instantiations).  The twelve highest kernels (their own note
// further down) share the per-chunk-pair arithmetic of one point pair's
// env micro-tile: K2 and K3 on rect_kernel (8), which stages with a
// cp.async ring, K1 on tri_kernel (4), which stages with the Tensor Memory
// Accelerator and an mbarrier ring.  They skip the env chunks whose elements cannot meet, overlap
// staging with the arithmetic and write into a caller's buffer (K2
// transposed where asked, K1 as its tile and the tile's transpose).
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
// the tensor cores' bf16 rate) and the assembly, not device memory.  In
// cov_kernel the dot products are taken for every env pair; the element
// mask skips only the coefficients and the assembly.
// Its design keeps every env-pair intermediate in registers: one block
// (8 warps) owns a tile of 8 x 8 points and loops over 4-env chunks of
// both sides staged in shared memory; each thread owns a 2 x 2 env
// micro-tile of one point pair and its 16 (K_EF: 4) dot products, reduces
// env -> point in registers across the chunks, then over the 4 threads of
// its point pair with warp shuffles.  It stages the bf16 parts env-major
// (k contiguous, the layout mma.row.col reads) and takes the dot products
// with mma.sync m16n8k16: warp (wa, wb) multiplies 16 lhs envs
// x 4 components (4 m-tiles) by 8 rhs envs x 4 components (4 n-tiles),
// and the lhs envs are staged so that fragment row g holds env 2g and row
// g + 8 env 2g + 1: then each thread's accumulators hold all (c1, c2)
// products of its lhs envs 2g, 2g+1 and rhs envs 2q, 2q+1 (q = lane % 4),
// one point pair's 2 x 2 micro-tile, and the assembly is the same code.
// The Dot variants differ from the RBF ones in the coefficients alone
// (KIND).  No block reads another's output, the ragged point and env
// edges are masked at load, and the (p,u) x (q,v) interleaved layout is
// written directly.  K1 derives its upper-triangle tile pair (I <= J) from
// the linear block index and writes each tile and its transpose; on
// diagonal tiles only the upper entries are computed into the output, so
// the result is exactly symmetric.
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

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>

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
constexpr int BF16X4 = 1;     // matmul precision of cov_kernel (template
constexpr int BF16 = 2;       // PREC; highest, 0, runs on rect_kernel)

// The bf16 modes: stage the NP parts of the same envs env-major with k
// contiguous, s[(part * NC + c) * NE + slot][k] with row stride RS.  On
// the lhs (PERM) side env 2g + h of each 16-env group goes to slot
// g + 8 h, the fragment row that reads it (see the file comment).
template <int NC, int NP, bool PERM>
__device__ __forceinline__ void stage_bf16(const uint16_t* __restrict__ X,
                                           int m, int B, int p0, int e0,
                                           uint16_t* __restrict__ s) {
  const long long N = (long long)m * B;
  for (int idx = threadIdx.x; idx < NP * NC * NE * (DP / 8); idx += NT) {
    const int k8 = idx % (DP / 8);
    const int env = (idx / (DP / 8)) % NE;
    const int pc = idx / (DP / 8 * NE);   // part * NC + c
    const int p = p0 + env / CB;
    const int e = e0 + env % CB;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (p < m && e < B) {
      const long long n = (long long)p * B + e;
      v = *reinterpret_cast<const uint4*>(X + (pc * N + n) * DP + k8 * 8);
    }
    const int slot =
        PERM ? (env & ~15) | ((env & 1) << 3) | ((env & 15) >> 1) : env;
    *reinterpret_cast<uint4*>(s + (pc * NE + slot) * RS + k8 * 8) = v;
  }
}

// [weight, element] of the staged envs, in env order.
__device__ __forceinline__ void stage_re(const float* __restrict__ re,
                                         int m, int B, int p0, int e0,
                                         float (*sre)[NE]) {
  const long long N = (long long)m * B;
  for (int idx = threadIdx.x; idx < 2 * NE; idx += NT) {
    const int row = idx / NE;
    const int env = idx % NE;
    const int p = p0 + env / CB;
    const int e = e0 + env % CB;
    float v = 0.f;
    if (p < m && e < B) v = re[row * N + (long long)p * B + e];
    sre[row][env] = v;
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

__device__ __forceinline__ uint32_t ld32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The same G from the staged bf16 parts with mma.sync: warp (wa, wb)
// takes lhs envs [16 wa, 16 wa + 16) x LC components against rhs envs
// [8 wb, 8 wb + 8) x 4 components, every (lhs part, rhs part) product
// (bf16x4: four, bf16: one) into one fp32 accumulator.  Accumulator
// element i sits at fragment row g + 8 (i >> 1) = lhs env 2g + (i >> 1)
// and column 2q + (i & 1) = rhs env 2q + (i & 1): G[c][ia * 2 + ib].
template <int LC, int NP>
__device__ __forceinline__ void pair_blocks_mma(const uint16_t* __restrict__ sA,
                                                const uint16_t* __restrict__ sB,
                                                int wa, int wb, int lane,
                                                float (&G)[LC * 4][4]) {
  const int g = lane >> 2;
  const int q = lane & 3;
#pragma unroll
  for (int c = 0; c < LC * 4; ++c)
#pragma unroll
    for (int i = 0; i < 4; ++i) G[c][i] = 0.f;
#pragma unroll
  for (int ks = 0; ks < DP; ks += 16) {
    uint32_t b[NP][4][2];
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int c2 = 0; c2 < 4; ++c2) {
        const uint16_t* r =
            sB + ((p * 4 + c2) * NE + 8 * wb + g) * RS + ks + 2 * q;
        b[p][c2][0] = ld32(r);
        b[p][c2][1] = ld32(r + 8);
      }
#pragma unroll
    for (int c1 = 0; c1 < LC; ++c1) {
      uint32_t a[NP][4];
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const uint16_t* r =
            sA + ((p * LC + c1) * NE + 16 * wa + g) * RS + ks + 2 * q;
        a[p][0] = ld32(r);
        a[p][1] = ld32(r + 8 * RS);
        a[p][2] = ld32(r + 8);
        a[p][3] = ld32(r + 8 * RS + 8);
      }
#pragma unroll
      for (int c2 = 0; c2 < 4; ++c2)
#pragma unroll
        for (int pa = 0; pa < NP; ++pa)
#pragma unroll
          for (int pb = 0; pb < NP; ++pb)
            mma_bf16(G[c1 * 4 + c2], a[pa], b[pb][c2]);
    }
  }
}

// One side's staged chunk with NC components: the bf16 parts env-major
// with row stride RS.  The two sides are two __shared__ arrays: one object
// holding both made ptxas spill 40-96 bytes in the fp32 K_FF kernels
// (PERF.md).
template <int NC, int PREC>
using Staged = uint16_t[(PREC == BF16X4 ? 2 : 1) * NC * NE * RS];

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

// LC = 4: K_FF (lhs carries [u; Jt]), LC = 1: K_EF (lhs carries u only).
// MODE 0: rectangular grid (blockIdx.y = lhs tile, blockIdx.x = rhs tile);
// MODE 1: upper-triangle tiles of a symmetric K_FF from the linear index
// k0 + blockIdx.x (k0 is unused by MODE 0).
// SEL = KONLY: K into out; DUAL: K into out and dK/dgamma into outd;
// DERIV: dK/dgamma into out.
// KIND = RBF (gamma = 1 / (2 l^2)) or DOT (gamma unused).
// PREC = BF16X4 or BF16 (tensor cores).
// The K_FF instantiations ask for two resident blocks per SM, which caps
// them at 128 registers, and the K_EF ones for four (64 registers): left
// free, ptxas gave some K_FF ones 129-139 registers, the card then held
// one block per SM and they ran slower; a K_EF one given more than 64
// registers ran slower too (PERF.md).
template <int LC, int MODE, int SEL, int KIND, int PREC>
__global__ void __launch_bounds__(NT, LC == 4 ? 2 : 4)
cov_kernel(const void* __restrict__ X1, const float* __restrict__ re1,
           int m1, int B1, const void* __restrict__ X2,
           const float* __restrict__ re2, int m2, int B2,
           float* __restrict__ out, float* __restrict__ outd, long long ldo,
           float sigma2, float gamma, int zeta, long long k0) {
  static_assert(KIND == RBF || SEL == KONLY,
                "the Dot kernel has no dK/dgamma pass");
  constexpr int NPL = LC == 4 ? 9 : 3;   // planes per coefficient set
  constexpr int NS = SEL == DUAL ? 2 : 1;
  constexpr int NOUT = NPL * NS;
  constexpr int DSET = SEL == DUAL ? NPL : 0;   // first dK/dgamma plane
  constexpr int NP = PREC == BF16X4 ? 2 : 1;    // bf16 parts per value
  __shared__ __align__(16) Staged<LC, PREC> s1;
  __shared__ __align__(16) Staged<4, PREC> s2;
  __shared__ float sre1[2][NE];
  __shared__ float sre2[2][NE];

  int I, J;
  if (MODE == 1) {
    tri_tile(k0 + blockIdx.x, I, J);
  } else {
    I = blockIdx.y;
    J = blockIdx.x;
  }

  // this thread's point pair (pl, ql) in the tile, its two lhs envs a0,
  // a0 + 1 and two rhs envs b0, b0 + 1 of each chunk (the fragment rows
  // and columns of its accumulators), and the lanes of the other three
  // threads of the pair (xor 1, xor 4)
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int g = lane >> 2, q4 = lane & 3;
  const int pl = 4 * (warp >> 2) + (g >> 1);
  const int ql = 2 * (warp & 3) + (q4 >> 1);
  const int a0 = 16 * (warp >> 2) + 2 * g;
  const int b0 = 8 * (warp & 3) + 2 * q4;

  float acc[NOUT];
#pragma unroll
  for (int i = 0; i < NOUT; ++i) acc[i] = 0.f;

  for (int ea = 0; ea < B1; ea += CB) {
    stage_bf16<LC, NP, true>(static_cast<const uint16_t*>(X1), m1, B1,
                             I * TP, ea, s1);
    stage_re(re1, m1, B1, I * TP, ea, sre1);
    for (int eb = 0; eb < B2; eb += CB) {
      stage_bf16<4, NP, false>(static_cast<const uint16_t*>(X2), m2, B2,
                               J * TP, eb, s2);
      stage_re(re2, m2, B2, J * TP, eb, sre2);
      __syncthreads();

      // G[c1 * 4 + c2][ia * 2 + ib] = X1[c1]_(a0+ia) . X2[c2]_(b0+ib)
      float G[LC * 4][4];
      pair_blocks_mma<LC, NP>(s1, s2, warp >> 2, warp & 3, lane, G);

#pragma unroll
      for (int ia = 0; ia < 2; ++ia)
#pragma unroll
        for (int ib = 0; ib < 2; ++ib) {
          const int e = ia * 2 + ib;
          const float same =
              sre1[1][a0 + ia] == sre2[1][b0 + ib] ? 1.f : 0.f;
          const float w = sre1[0][a0 + ia] * sre2[0][b0 + ib] * same;
          if (w == 0.f) continue;
          const float c = G[0][e];
          float d1, dm2;
          powers(c, zeta, d1, dm2);
          const float D = d1 * c;
          const float zd1 = (float)zeta * d1;
          const float b0c = (float)(zeta * (zeta - 1)) * dm2;
          // A: coefficient of m_uv (K_FF) and -A of p2_v (K_EF);
          // Bc: of p1_u p2_v (K_FF); both carry the pair weight w
          float k = 0.f, A, Bc;
          if constexpr (KIND == DOT) {
            A = sigma2 * zd1 * w;
            Bc = sigma2 * b0c * w;
          } else {
            k = sigma2 * expf((D - 1.f) * gamma);
            const float kg = k * gamma;
            A = kg * zd1 * w;
            Bc = kg * (b0c + zd1 * zd1 * gamma) * w;
          }
          if constexpr (LC == 4) {
            if constexpr (SEL != DERIV) {
#pragma unroll
              for (int u = 0; u < 3; ++u) {
                const float Bp1 = Bc * G[(1 + u) * 4][e];
#pragma unroll
                for (int v = 0; v < 3; ++v)
                  acc[u * 3 + v] += A * G[(1 + u) * 4 + 1 + v][e] +
                                    Bp1 * G[1 + v][e];
              }
            }
            if constexpr (SEL != KONLY) {
              const float Dm1 = D - 1.f;
              const float kw = k * w;
              const float dA = A * Dm1 + kw * zd1;
              const float dB =
                  Bc * Dm1 + kw * (b0c + 2.f * zd1 * zd1 * gamma);
#pragma unroll
              for (int u = 0; u < 3; ++u) {
                const float dBp1 = dB * G[(1 + u) * 4][e];
#pragma unroll
                for (int v = 0; v < 3; ++v)
                  acc[DSET + u * 3 + v] +=
                      dA * G[(1 + u) * 4 + 1 + v][e] + dBp1 * G[1 + v][e];
              }
            }
          } else {
            const float A0 = -A;
            if constexpr (SEL != DERIV) {
#pragma unroll
              for (int v = 0; v < 3; ++v) acc[v] += A0 * G[1 + v][e];
            }
            if constexpr (SEL != KONLY) {
              const float dA0 = A0 * (D - 1.f) - k * w * zd1;
#pragma unroll
              for (int v = 0; v < 3; ++v)
                acc[DSET + v] += dA0 * G[1 + v][e];
            }
          }
        }
      __syncthreads();
    }
  }

  // reduce the 2 x 2 micro-tiles of one point pair (lanes xor 1, xor 4)
#pragma unroll
  for (int i = 0; i < NOUT; ++i) {
    acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], 1);
    acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], 4);
  }
  if ((lane & 5) != 0) return;
  const int p = I * TP + pl;
  const int q = J * TP + ql;
  if (p >= m1 || q >= m2) return;

#pragma unroll
  for (int sset = 0; sset < NS; ++sset) {
    float* __restrict__ o = sset == 0 ? out : outd;
    const int a = sset * NPL;   // this set's first accumulator
    if constexpr (LC == 1) {
#pragma unroll
      for (int v = 0; v < 3; ++v)
        o[(long long)p * ldo + 3 * q + v] = acc[a + v];
    } else if (MODE == 0 || I < J || pl < ql) {
#pragma unroll
      for (int u = 0; u < 3; ++u)
#pragma unroll
        for (int v = 0; v < 3; ++v)
          o[(long long)(3 * p + u) * ldo + 3 * q + v] =
              acc[a + u * 3 + v];
      if (MODE == 1) {
#pragma unroll
        for (int u = 0; u < 3; ++u)
#pragma unroll
          for (int v = 0; v < 3; ++v)
            o[(long long)(3 * q + v) * ldo + 3 * p + u] =
                acc[a + u * 3 + v];
      }
    } else if (pl == ql) {
      // diagonal 3 x 3 block: upper entries, mirrored
#pragma unroll
      for (int u = 0; u < 3; ++u)
#pragma unroll
        for (int v = u; v < 3; ++v) {
          const float x = acc[a + u * 3 + v];
          o[(long long)(3 * p + u) * ldo + 3 * p + v] = x;
          o[(long long)(3 * p + v) * ldo + 3 * p + u] = x;
        }
    }
  }
}


// ---------------------------------------------------------------------------
// The kernels in highest: K3 (kff_rect*, LC = 4) and K2 (kef_rect*, LC =
// 1), the two kernels of every served block, on rect_kernel; K1
// (kff_tri*), the symmetric K_FF of every training covariance, on
// tri_kernel.  Both run the same arithmetic per staged chunk pair, each
// with its own copy of it: shared as one function, it made the compiler
// emit slower code for K1 (111.8 against 88.8 ms at the 10k bench shape,
// NVIDIA H100 80GB HBM3, 700.00 W; PERF.md).
//
// They replace _kff_kernel (kff_pallas.py:269, K3), _kef_kernel
// (kff_pallas.py:748, K2) and _kff_kernel_tri (kff_pallas.py:282, K1) in
// the exact mode.  What bounds them on this card: the fp32 FMA rate of the
// env-pair dot products (operations; the operands stay in L2), and at the
// few-point shapes of one served request the length of one block's serial
// chain of chunk pairs.  What the design does about it:
//  * Chunk pairs that cannot meet are never staged or multiplied.  Every
//    block first reads the element range [lo, hi] of the valid envs of
//    each of its env chunks from re; a chunk pair whose ranges do not
//    intersect (or a chunk of padding alone) is skipped, and inside a
//    staged pair a warp whose own lhs envs cannot meet the rhs chunk skips
//    its dot products.  With the envs of a point sorted by element (the
//    operand functions of ops/kff.py do that) this removes cross-element
//    work; with any other order it only finds less to skip: the per-pair
//    mask stays, and a skipped pair is one whose every weight is zero,
//    which the assembly never adds, so the sums are the same bit for bit
//    whatever is skipped.
//  * rect_kernel: staging overlaps the arithmetic: cp.async copies the
//    next chunk pair into the second stage of a ring in dynamic shared
//    memory while the block multiplies the current one.  The copies are 4
//    bytes wide and transpose on the way (8 consecutive k of 4 consecutive
//    envs per warp instruction: whole 32-byte sectors from global,
//    conflict-free k-major rows of stride NE + 4 in shared memory), so the
//    inner loop reads the k-major layout it needs, one k a step; a lhs
//    chunk already held by a stage is not copied again.  (16-byte copies
//    of env-major rows with a float4 k-vector inner loop were measured
//    slower, 14.2 against 12.2 ms for K3 at 750 x 750 points of 32 envs
//    on an NVIDIA H100 80GB HBM3, 700.00 W, and spilled.)
//  * K2 is no longer bound by shared-memory loads: a thread owns 4 lhs
//    envs x 2 rhs envs x 4 components (32 accumulators, 1 float4 + 4
//    float2 loads for 32 FMAs per k, against 5 float2 loads for 16
//    before), with 8-env lhs chunks of 8 energy points.  K1 and K3 keep
//    the 2 x 2 env micro-tile of 16 dot products and 4-env chunks.  All
//    tiles are 8 points x 8 points, one warp a lhs point.
//  * The output goes to out + row * ldo (the caller's buffer, any leading
//    dimension), and K2 can store transposed (K_FE of a served block).
//  * tri_kernel (K1) stages with the Tensor Memory Accelerator: the
//    operand's k-major copy (ops/kff.py tri_operand: rows [c][k], weight,
//    element; m points; env count rounded up to CB) is read through a
//    3-D tensor map, one box (CB envs x TP points x all TROWS rows) a side
//    and chunk, which lands as the k-major rows the inner loop reads
//    (stride NE: a warp's rhs loads cover 128 consecutive bytes, no bank
//    conflict) with the weights and elements behind them; points past m
//    arrive as zeros.  A ring of TSTAGES stages, each with a full and an
//    empty mbarrier: thread 0 issues the next copies as soon as the
//    stage's consumers have released it, every warp waits on the full
//    barrier of the stage it reads and releases it with one arrive, and
//    no block barrier stands in the chunk loop.  This took K1 at the
//    10k bench shape from 96.0 ms (the cp.async ring of rect_kernel) to
//    88.2 ms, K1-dual from 100.7 to 95.3 (NVIDIA H100 80GB HBM3,
//    700.00 W; PERF.md).  K1 walks the upper-triangle tiles of its range,
//    one a block; a diagonal tile reads its chunk ranges once for both
//    sides.  It writes the tile and its transpose, on a diagonal tile the
//    upper entries mirrored, so K is exactly symmetric; the tile body does
//    not know the range, so tile ranges sum to the single launch bit for
//    bit (the mesh-sharded build).
// Every output element is written once by one thread; a point pair's sum
// is taken in an order that depends on its own envs alone (chunk pairs in
// nested order, then the lanes of the pair by shuffles), never on the
// grid, so stripes of a block cut at whole 8-point tiles equal the single
// launch bit for bit.
// ---------------------------------------------------------------------------

constexpr int KS2 = NE + 4;   // k-row stride of the staged rhs chunk

template <int LC>
struct Rect {
  static constexpr int CB1 = LC == 4 ? 4 : 8;    // lhs envs per point, chunk
  static constexpr int MA = CB1 / 2;             // lhs envs per thread
  static constexpr int NE1 = TP * CB1;           // lhs envs per chunk
  static constexpr int KS1 = NE1 + 4;            // its k-row stride
  static constexpr int S1 = LC * DP * KS1;       // floats: lhs chunk,
  static constexpr int S2 = 4 * DP * KS2;        // rhs chunk,
  static constexpr int STAGE = S1 + S2 + 2 * NE1 + 2 * NE;   // one stage
};

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

// Copy envs [e0, e0 + CBX) of points [p0, p0 + NEX / CBX) of one side
// into a stage, k-major: s[(c * DP + k) * KS + env], env = point_local *
// CBX + e; what lies past the point or env count arrives as zeros.
template <int NC, int NEX, int CBX>
__device__ __forceinline__ void stage_async(const float* __restrict__ X,
                                            int m, int B, int p0, int e0,
                                            float* __restrict__ s) {
  constexpr int KS = NEX + 4;
  constexpr int EH = NEX / 4;   // groups of 4 consecutive envs
  const long long N = (long long)m * B;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // a warp instruction copies 8 consecutive k of 4 consecutive envs; this
  // thread keeps one k and walks every second env group, all components
  const int k = (warp & 3) * 8 + (lane >> 2);
#pragma unroll
  for (int h = 0; h < EH / 2; ++h) {
    const int env = ((warp >> 2) + 2 * h) * 4 + (lane & 3);
    const int p = p0 + env / CBX;
    const int e = e0 + env % CBX;
    const bool ok = p < m && e < B;
    const float* src = ok ? X + ((long long)p * B + e) * DP + k : X;
    float* dst = s + k * KS + env;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      cp_async4(dst + c * DP * KS, ok ? src + c * N * DP : X, ok);
  }
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

// LC = 4: K_FF (kff_rect*), LC = 1: K_EF (kef_rect*); SEL and KIND as in
// cov_kernel.  blockIdx.y = lhs tile, blockIdx.x = rhs tile.  out (and
// outd for DUAL) have leading dimension ldo; trans (K_EF only) stores
// out[(3 q + v) * ldo + p] instead of out[p * ldo + 3 q + v].
template <int LC, int SEL, int KIND>
__global__ void __launch_bounds__(NT, LC == 4 ? 2 : 3)
rect_kernel(const float* __restrict__ X1, const float* __restrict__ re1,
            int m1, int B1, const float* __restrict__ X2,
            const float* __restrict__ re2, int m2, int B2,
            float* __restrict__ out, float* __restrict__ outd,
            long long ldo, int trans, float sigma2, float gamma, int zeta) {
  static_assert(KIND == RBF || SEL == KONLY,
                "the Dot kernel has no dK/dgamma pass");
  using R = Rect<LC>;
  constexpr int MA = R::MA;
  constexpr int NPL = LC == 4 ? 9 : 3;   // planes per coefficient set
  constexpr int NS = SEL == DUAL ? 2 : 1;
  constexpr int NOUT = NPL * NS;
  constexpr int DSET = SEL == DUAL ? NPL : 0;   // first dK/dgamma plane
  extern __shared__ __align__(16) float smem[];

  const int I = blockIdx.y, J = blockIdx.x;
  const int nca = (B1 + R::CB1 - 1) / R::CB1;
  const int ncb = (B2 + CB - 1) / CB;
  float* const rng1 = smem + 2 * R::STAGE;
  float* const rng2 = rng1 + 2 * nca;

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  // this thread's point pair (pl, ql), its MA lhs envs from a0 and its two
  // rhs envs b0, b0 + 1 in each chunk pair; the other three threads of
  // the pair are the lanes xor 1, xor 2
  const int pl = warp;
  const int ql = lane >> 2;
  const int a0 = pl * R::CB1 + ((lane >> 1) & 1) * MA;
  const int b0 = ql * CB + (lane & 1) * 2;

  for (int ch = warp; ch < nca + ncb; ch += NT / 32) {
    if (ch < nca)
      chunk_range<R::NE1, R::CB1>(re1, m1, B1, I * TP, ch, rng1);
    else
      chunk_range<NE, CB>(re2, m2, B2, J * TP, ch - nca, rng2);
  }
  __syncthreads();

  // the next chunk pair after (a, b), in nested order, whose element
  // ranges intersect
  auto next = [&](int& a, int& b) -> bool {
    for (;;) {
      if (++b >= ncb) {
        b = 0;
        ++a;
      }
      if (a >= nca) return false;
      if (!(rng1[2 * a + 1] < rng2[2 * b] || rng2[2 * b + 1] < rng1[2 * a]))
        return true;
    }
  };
  int held0 = -1, held1 = -1;   // the lhs chunk each stage holds
  auto stage_pair = [&](int stage, int a, int b) {
    float* const st = smem + stage * R::STAGE;
    int& held = stage ? held1 : held0;
    if (held != a) {
      stage_async<LC, R::NE1, R::CB1>(X1, m1, B1, I * TP, a * R::CB1, st);
      stage_re_async<R::NE1, R::CB1>(re1, m1, B1, I * TP, a * R::CB1,
                                     st + R::S1 + R::S2);
      held = a;
    }
    stage_async<4, NE, CB>(X2, m2, B2, J * TP, b * CB, st + R::S1);
    stage_re_async<NE, CB>(re2, m2, B2, J * TP, b * CB,
                           st + R::S1 + R::S2 + 2 * R::NE1);
  };

  float acc[NOUT];
#pragma unroll
  for (int i = 0; i < NOUT; ++i) acc[i] = 0.f;

  int a = 0, b = -1, cur = 0;
  bool have = next(a, b);
  if (have) stage_pair(0, a, b);
  cp_async_commit();
  while (have) {
    int na = a, nb = b;
    const bool more = next(na, nb);
    if (more) stage_pair(cur ^ 1, na, nb);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    const float* const s1 = smem + cur * R::STAGE;
    const float* const s2 = s1 + R::S1;
    const float* const sw1 = s2 + R::S2;           // lhs weights
    const float* const se1 = sw1 + R::NE1;         // lhs elements
    const float* const sw2 = se1 + R::NE1;
    const float* const se2 = sw2 + NE;
    // this warp's lhs point against the rhs chunk's range
    float wlo = INFINITY, whi = -INFINITY;
#pragma unroll
    for (int i = 0; i < R::CB1; ++i) {
      const float el = se1[pl * R::CB1 + i];
      if (sw1[pl * R::CB1 + i] != 0.f) {
        wlo = fminf(wlo, el);
        whi = fmaxf(whi, el);
      }
    }
    if (!(whi < rng2[2 * b] || rng2[2 * b + 1] < wlo)) {
      // G[c1 * 4 + c2][ia * 2 + ib] = X1[c1]_(a0+ia) . X2[c2]_(b0+ib)
      float G[LC * 4][MA * 2];
#pragma unroll
      for (int c = 0; c < LC * 4; ++c)
#pragma unroll
        for (int i = 0; i < MA * 2; ++i) G[c][i] = 0.f;
#pragma unroll 2
      for (int k = 0; k < DP; ++k) {
        float l[LC][MA];
        float2 r[4];
#pragma unroll
        for (int c = 0; c < LC; ++c) {
          const float* lp = s1 + (c * DP + k) * R::KS1 + a0;
          if constexpr (MA == 2) {
            const float2 v = *reinterpret_cast<const float2*>(lp);
            l[c][0] = v.x;
            l[c][1] = v.y;
          } else {
            const float4 v = *reinterpret_cast<const float4*>(lp);
            l[c][0] = v.x;
            l[c][1] = v.y;
            l[c][2] = v.z;
            l[c][3] = v.w;
          }
        }
#pragma unroll
        for (int c = 0; c < 4; ++c)
          r[c] = *reinterpret_cast<const float2*>(s2 + (c * DP + k) * KS2 +
                                                  b0);
#pragma unroll
        for (int c1 = 0; c1 < LC; ++c1)
#pragma unroll
          for (int c2 = 0; c2 < 4; ++c2) {
            float* gc = G[c1 * 4 + c2];
#pragma unroll
            for (int ia = 0; ia < MA; ++ia) {
              gc[ia * 2 + 0] = fmaf(l[c1][ia], r[c2].x, gc[ia * 2 + 0]);
              gc[ia * 2 + 1] = fmaf(l[c1][ia], r[c2].y, gc[ia * 2 + 1]);
            }
          }
      }

#pragma unroll
      for (int ia = 0; ia < MA; ++ia)
#pragma unroll
        for (int ib = 0; ib < 2; ++ib) {
          const int e = ia * 2 + ib;
          const float same = se1[a0 + ia] == se2[b0 + ib] ? 1.f : 0.f;
          const float w = sw1[a0 + ia] * sw2[b0 + ib] * same;
          if (w == 0.f) continue;
          const float c = G[0][e];
          float d1, dm2;
          powers(c, zeta, d1, dm2);
          const float D = d1 * c;
          const float zd1 = (float)zeta * d1;
          const float b0c = (float)(zeta * (zeta - 1)) * dm2;
          // A: coefficient of m_uv (K_FF) and -A of p2_v (K_EF);
          // Bc: of p1_u p2_v (K_FF); both carry the pair weight w
          float k = 0.f, A, Bc;
          if constexpr (KIND == DOT) {
            A = sigma2 * zd1 * w;
            Bc = sigma2 * b0c * w;
          } else {
            k = sigma2 * expf((D - 1.f) * gamma);
            const float kg = k * gamma;
            A = kg * zd1 * w;
            Bc = kg * (b0c + zd1 * zd1 * gamma) * w;
          }
          if constexpr (LC == 4) {
            if constexpr (SEL != DERIV) {
#pragma unroll
              for (int u = 0; u < 3; ++u) {
                const float Bp1 = Bc * G[(1 + u) * 4][e];
#pragma unroll
                for (int v = 0; v < 3; ++v)
                  acc[u * 3 + v] += A * G[(1 + u) * 4 + 1 + v][e] +
                                    Bp1 * G[1 + v][e];
              }
            }
            if constexpr (SEL != KONLY) {
              const float Dm1 = D - 1.f;
              const float kw = k * w;
              const float dA = A * Dm1 + kw * zd1;
              const float dB =
                  Bc * Dm1 + kw * (b0c + 2.f * zd1 * zd1 * gamma);
#pragma unroll
              for (int u = 0; u < 3; ++u) {
                const float dBp1 = dB * G[(1 + u) * 4][e];
#pragma unroll
                for (int v = 0; v < 3; ++v)
                  acc[DSET + u * 3 + v] +=
                      dA * G[(1 + u) * 4 + 1 + v][e] + dBp1 * G[1 + v][e];
              }
            }
          } else {
            const float A0 = -A;
            if constexpr (SEL != DERIV) {
#pragma unroll
              for (int v = 0; v < 3; ++v) acc[v] += A0 * G[1 + v][e];
            }
            if constexpr (SEL != KONLY) {
              const float dA0 = A0 * (D - 1.f) - k * w * zd1;
#pragma unroll
              for (int v = 0; v < 3; ++v)
                acc[DSET + v] += dA0 * G[1 + v][e];
            }
          }
        }
    }
    __syncthreads();
    a = na;
    b = nb;
    have = more;
    cur ^= 1;
  }

  // reduce the micro-tiles of one point pair: lanes xor 1, xor 2
#pragma unroll
  for (int i = 0; i < NOUT; ++i) {
    acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], 1);
    acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], 2);
  }
  if ((lane & 3) != 0) return;
  const int p = I * TP + pl;
  const int q = J * TP + ql;
  if (p >= m1 || q >= m2) return;

#pragma unroll
  for (int sset = 0; sset < NS; ++sset) {
    float* __restrict__ o = sset == 0 ? out : outd;
    const int s0 = sset * NPL;   // this set's first accumulator
    if constexpr (LC == 1) {
#pragma unroll
      for (int v = 0; v < 3; ++v) {
        if (trans)
          o[(long long)(3 * q + v) * ldo + p] = acc[s0 + v];
        else
          o[(long long)p * ldo + 3 * q + v] = acc[s0 + v];
      }
    } else {
#pragma unroll
      for (int u = 0; u < 3; ++u)
#pragma unroll
        for (int v = 0; v < 3; ++v)
          o[(long long)(3 * p + u) * ldo + 3 * q + v] = acc[s0 + u * 3 + v];
    }
  }
}

// The TMA staging of tri_kernel: TROWS rows of the k-major copy a chunk
// (4 DP rows [c][k], then the weight and the element), TSIDE floats a
// side (16 640 bytes), TSTAGES stages of both sides.
constexpr int TROWS = 4 * DP + 2;
constexpr int TSIDE = TROWS * NE;
constexpr int TSTAGES = 3;

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

// One box of the k-major copy (envs c0.., points c1.., rows c2..) into
// shared memory; its bytes complete the transaction count of ``bar``.
__device__ __forceinline__ void tma_load3(float* dst, const CUtensorMap* map,
                                          uint64_t* bar, int c0, int c1,
                                          int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(
          smem_u32(dst)),
      "l"((uint64_t)map), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// K1 in highest: tiles [k0, k0 + gridDim.x) of the upper triangle of one
// operand, re its [weight, element] rows (the chunk ranges), map the
// tensor map of its k-major copy (tri_map).  SEL and KIND as in
// cov_kernel; out (and outd for DUAL) with leading dimension ldo.
template <int SEL, int KIND>
__global__ void __launch_bounds__(NT, 2)
tri_kernel(const __grid_constant__ CUtensorMap map,
           const float* __restrict__ re, int m, int B,
           float* __restrict__ out, float* __restrict__ outd, long long ldo,
           float sigma2, float gamma, int zeta, long long k0) {
  constexpr int NPL = 9, NS = SEL == DUAL ? 2 : 1, NOUT = NPL * NS;
  constexpr int DSET = SEL == DUAL ? NPL : 0;
  extern __shared__ __align__(16) float smem_raw[];
  // the ring first, at a 128-byte boundary (a TMA destination), then the
  // barriers and the chunk ranges
  float* const ring = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~(uintptr_t)127);
  uint64_t* const full = reinterpret_cast<uint64_t*>(
      ring + TSTAGES * 2 * TSIDE);
  uint64_t* const empty = full + TSTAGES;
  float* const rngs = reinterpret_cast<float*>(empty + TSTAGES);

  int I, J;
  tri_tile(k0 + blockIdx.x, I, J);
  const int nc = (B + CB - 1) / CB;
  // a diagonal tile: both sides are one tile, whose chunk ranges are read
  // once for both roles
  const bool one_tile = I == J;
  float* const rng1 = rngs;
  float* const rng2 = one_tile ? rng1 : rng1 + 2 * nc;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int pl = warp, ql = lane >> 2;
  const int a0 = pl * CB + ((lane >> 1) & 1) * 2;
  const int b0 = ql * CB + (lane & 1) * 2;

  for (int ch = warp; ch < (one_tile ? nc : 2 * nc); ch += NT / 32) {
    if (ch < nc)
      chunk_range<NE, CB>(re, m, B, I * TP, ch, rng1);
    else
      chunk_range<NE, CB>(re, m, B, J * TP, ch - nc, rng2);
  }
  if (t == 0) {
    for (int s = 0; s < TSTAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NT / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  auto next = [&](int& a, int& b) -> bool {
    for (;;) {
      if (++b >= nc) {
        b = 0;
        ++a;
      }
      if (a >= nc) return false;
      if (!(rng1[2 * a + 1] < rng2[2 * b] || rng2[2 * b + 1] < rng1[2 * a]))
        return true;
    }
  };
  // the producer (thread 0): its own cursor over the same chunk pairs,
  // the next copy's index, and the lhs chunk each stage holds
  int pa = 0, pb = -1, jn = 0;
  int held[TSTAGES];
  bool phave = false;
  auto issue = [&]() {
    const int s = jn % TSTAGES;
    if (jn >= TSTAGES) mbar_wait(&empty[s], ((jn / TSTAGES) - 1) & 1);
    float* const st = ring + s * 2 * TSIDE;
    const bool lhs = held[s] != pa;
    mbar_expect_tx(&full[s], (lhs ? 2 : 1) * TSIDE * (uint32_t)sizeof(float));
    if (lhs) {
      tma_load3(st, &map, &full[s], pa * CB, I * TP, 0);
      held[s] = pa;
    }
    tma_load3(st + TSIDE, &map, &full[s], pb * CB, J * TP, 0);
    ++jn;
    phave = next(pa, pb);
  };
  if (t == 0) {
    for (int s = 0; s < TSTAGES; ++s) held[s] = -1;
    phave = next(pa, pb);
    for (int s = 0; s < TSTAGES - 1 && phave; ++s) issue();
  }

  float acc[NOUT];
#pragma unroll
  for (int i = 0; i < NOUT; ++i) acc[i] = 0.f;

  int a = 0, b = -1, it = 0;
  bool have = next(a, b);
  while (have) {
    // keep TSTAGES - 1 chunk pairs in flight ahead of this one
    if (t == 0 && phave) issue();
    const int s = it % TSTAGES;
    mbar_wait(&full[s], (it / TSTAGES) & 1);
    const float* const s1 = ring + s * 2 * TSIDE;
    const float* const s2 = s1 + TSIDE;
    const float* const sw1 = s1 + 4 * DP * NE;
    const float* const se1 = sw1 + NE;
    const float* const sw2 = s2 + 4 * DP * NE;
    const float* const se2 = sw2 + NE;
    float wlo = INFINITY, whi = -INFINITY;
#pragma unroll
    for (int i = 0; i < CB; ++i) {
      const float el = se1[pl * CB + i];
      if (sw1[pl * CB + i] != 0.f) {
        wlo = fminf(wlo, el);
        whi = fmaxf(whi, el);
      }
    }
    if (!(whi < rng2[2 * b] || rng2[2 * b + 1] < wlo)) {
      float G[16][4];
#pragma unroll
      for (int c = 0; c < 16; ++c)
#pragma unroll
        for (int i = 0; i < 4; ++i) G[c][i] = 0.f;
#pragma unroll 2
      for (int k = 0; k < DP; ++k) {
        float2 l[4], r[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          l[c] = *reinterpret_cast<const float2*>(s1 + (c * DP + k) * NE + a0);
          r[c] = *reinterpret_cast<const float2*>(s2 + (c * DP + k) * NE + b0);
        }
#pragma unroll
        for (int c1 = 0; c1 < 4; ++c1)
#pragma unroll
          for (int c2 = 0; c2 < 4; ++c2) {
            float* gc = G[c1 * 4 + c2];
            gc[0] = fmaf(l[c1].x, r[c2].x, gc[0]);
            gc[1] = fmaf(l[c1].x, r[c2].y, gc[1]);
            gc[2] = fmaf(l[c1].y, r[c2].x, gc[2]);
            gc[3] = fmaf(l[c1].y, r[c2].y, gc[3]);
          }
      }
#pragma unroll
      for (int ia = 0; ia < 2; ++ia)
#pragma unroll
        for (int ib = 0; ib < 2; ++ib) {
          const int e = ia * 2 + ib;
          const float same = se1[a0 + ia] == se2[b0 + ib] ? 1.f : 0.f;
          const float w = sw1[a0 + ia] * sw2[b0 + ib] * same;
          if (w == 0.f) continue;
          const float c = G[0][e];
          float d1, dm2;
          powers(c, zeta, d1, dm2);
          const float D = d1 * c;
          const float zd1 = (float)zeta * d1;
          const float b0c = (float)(zeta * (zeta - 1)) * dm2;
          float k = 0.f, A, Bc;
          if constexpr (KIND == DOT) {
            A = sigma2 * zd1 * w;
            Bc = sigma2 * b0c * w;
          } else {
            k = sigma2 * expf((D - 1.f) * gamma);
            const float kg = k * gamma;
            A = kg * zd1 * w;
            Bc = kg * (b0c + zd1 * zd1 * gamma) * w;
          }
          if constexpr (SEL != DERIV) {
#pragma unroll
            for (int u = 0; u < 3; ++u) {
              const float Bp1 = Bc * G[(1 + u) * 4][e];
#pragma unroll
              for (int v = 0; v < 3; ++v)
                acc[u * 3 + v] += A * G[(1 + u) * 4 + 1 + v][e] +
                                  Bp1 * G[1 + v][e];
            }
          }
          if constexpr (SEL != KONLY) {
            const float Dm1 = D - 1.f;
            const float kw = k * w;
            const float dA = A * Dm1 + kw * zd1;
            const float dB = Bc * Dm1 + kw * (b0c + 2.f * zd1 * zd1 * gamma);
#pragma unroll
            for (int u = 0; u < 3; ++u) {
              const float dBp1 = dB * G[(1 + u) * 4][e];
#pragma unroll
              for (int v = 0; v < 3; ++v)
                acc[DSET + u * 3 + v] +=
                    dA * G[(1 + u) * 4 + 1 + v][e] + dBp1 * G[1 + v][e];
            }
          }
        }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
    have = next(a, b);
    ++it;
  }

#pragma unroll
  for (int i = 0; i < NOUT; ++i) {
    acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], 1);
    acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], 2);
  }
  if ((lane & 3) != 0) return;
  const int p = I * TP + pl;
  const int q = J * TP + ql;
  if (p >= m || q >= m) return;
#pragma unroll
  for (int sset = 0; sset < NS; ++sset) {
    float* __restrict__ o = sset == 0 ? out : outd;
    const int s0 = sset * NPL;
    if (I < J || pl < ql) {
#pragma unroll
      for (int u = 0; u < 3; ++u)
#pragma unroll
        for (int v = 0; v < 3; ++v) {
          o[(long long)(3 * p + u) * ldo + 3 * q + v] = acc[s0 + u * 3 + v];
          o[(long long)(3 * q + v) * ldo + 3 * p + u] = acc[s0 + u * 3 + v];
        }
    } else if (pl == ql) {
#pragma unroll
      for (int u = 0; u < 3; ++u)
#pragma unroll
        for (int v = u; v < 3; ++v) {
          const float x = acc[s0 + u * 3 + v];
          o[(long long)(3 * p + u) * ldo + 3 * p + v] = x;
          o[(long long)(3 * p + v) * ldo + 3 * p + u] = x;
        }
    }
  }
}

// An empty kernel: the floor of one launch on this card.
__global__ void empty_kernel() {}

inline int tiles(int m) { return (m + TP - 1) / TP; }

// The grid of one launch.  MODE 1 (K1): tiles [k0, k0 + nk) of the upper
// triangle of one (m1 = m2) point set, a range that must lie inside the
// triangle; MODE 0: every (lhs tile, rhs tile), k0 and nk unused.  False
// for a range outside the triangle.
template <int MODE>
bool grid_of(int m1, int m2, long long k0, long long nk, dim3& grid) {
  grid = dim3(tiles(m2), tiles(m1));
  if (MODE == 1) {
    const long long nt = tiles(m1);
    if (k0 < 0 || nk < 1 || nk > 0x7fffffffLL || k0 + nk > nt * (nt + 1) / 2)
      return false;
    grid = dim3((unsigned)nk);
  }
  return true;
}

// cov_kernel (K1 and K2 / K3 in the bf16 modes).  Returns the launch
// status.
template <int LC, int MODE, int SEL, int KIND, int PREC>
int launch(const void* X1, const float* re1, int m1, int B1, const void* X2,
           const float* re2, int m2, int B2, float* out, float* outd,
           float sigma2, float gamma, int zeta, long long k0, long long nk,
           long long ldo, int trans, void* stream) {
  dim3 grid;
  if (trans || ldo < 3LL * m2 || !grid_of<MODE>(m1, m2, k0, nk, grid))
    return (int)cudaErrorInvalidValue;
  cov_kernel<LC, MODE, SEL, KIND, PREC>
      <<<grid, NT, 0, (cudaStream_t)stream>>>(X1, re1, m1, B1, X2, re2, m2,
                                              B2, out, outd, ldo, sigma2,
                                              gamma, zeta, k0);
  return (int)cudaGetLastError();
}

// The highest kernels' launches.  rect_kernel (K2, K3): every (lhs tile,
// rhs tile), with the two-stage ring and the chunk ranges in dynamic shared
// memory; tri_kernel (K1): the tile range, with the TMA ring, its barriers
// and the chunk ranges.  Both rings are above the 48 KB a kernel gets
// unasked, so kff_rect_init raises the limit of every instantiation, once
// per device, to what a block needs: its ring and kRangeBytes of chunk
// ranges (8 bytes a chunk: up to 2048 chunks on the two sides).
constexpr size_t kRangeBytes = 16384;

template <int LC>
constexpr size_t rect_ring_bytes() {
  return sizeof(float) * 2 * (size_t)Rect<LC>::STAGE;
}

// 128 bytes to align the ring, the ring, 2 TSTAGES barriers, the ranges
constexpr size_t tri_ring_bytes() {
  return 128 + sizeof(float) * TSTAGES * 2 * (size_t)TSIDE +
         2 * TSTAGES * sizeof(uint64_t);
}

// Raise a kernel's dynamic shared-memory limit to ``bytes`` and ask for
// the largest carveout: two blocks of 75 KB (K3), three of 56 KB (K2) or
// two of 98 KB (K1) must fit an SM.
template <typename Kernel>
cudaError_t smem_init(Kernel kernel, size_t bytes) {
  cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (rc != cudaSuccess) return rc;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

template <int LC, int SEL, int KIND>
cudaError_t rect_init() {
  return smem_init(rect_kernel<LC, SEL, KIND>,
                   rect_ring_bytes<LC>() + kRangeBytes);
}

template <int SEL, int KIND>
cudaError_t tri_init() {
  return smem_init(tri_kernel<SEL, KIND>, tri_ring_bytes() + kRangeBytes);
}

template <int LC, int SEL, int KIND>
int launch_rect(const float* X1, const float* re1, int m1, int B1,
                const float* X2, const float* re2, int m2, int B2, float* out,
                float* outd, float sigma2, float gamma, int zeta,
                long long ldo, int trans, void* stream) {
  using R = Rect<LC>;
  if (trans ? (LC != 1 || ldo < m1) : ldo < 3LL * m2)
    return (int)cudaErrorInvalidValue;
  const int nca = (B1 + R::CB1 - 1) / R::CB1;
  const int ncb = (B2 + CB - 1) / CB;
  const size_t ranges = sizeof(float) * 2 * ((size_t)nca + ncb);
  if (ranges > kRangeBytes) return (int)cudaErrorInvalidValue;
  dim3 grid(tiles(m2), tiles(m1));
  rect_kernel<LC, SEL, KIND>
      <<<grid, NT, rect_ring_bytes<LC>() + ranges, (cudaStream_t)stream>>>(
          X1, re1, m1, B1, X2, re2, m2, B2, out, outd, ldo, trans, sigma2,
          gamma, zeta);
  return (int)cudaGetLastError();
}

// The tensor map of one k-major copy: a 3-D float32 tensor (env, point,
// row) of extents (Bp, m, TROWS), boxes of (CB, TP, TROWS), no swizzle,
// zeros past the extents.  cuTensorMapEncodeTiled is looked up with
// cudaGetDriverEntryPoint, so the library links nothing but the CUDA
// runtime.  A map depends on the copy's address and extents alone,
// so it is encoded once per (device, address, extents) and kept: a launch
// on a copy seen before, e.g. every launch of a timing loop, reuses it.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

struct TriMap {
  int device;
  const void* ptr;
  int m, Bp;
  CUtensorMap map;
};

int tri_map(const void* Xt, int m, int Bp, CUtensorMap* map) {
  static std::mutex lock;
  static EncodeTiled encode = nullptr;
  static TriMap kept[16];
  static int n_kept = 0, next_slot = 0;
  int device;
  if (cudaGetDevice(&device) != cudaSuccess) return -1;
  std::lock_guard<std::mutex> guard(lock);
  for (int i = 0; i < n_kept; ++i) {
    const TriMap& e = kept[i];
    if (e.device == device && e.ptr == Xt && e.m == m && e.Bp == Bp) {
      *map = e.map;
      return 0;
    }
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
  const cuuint64_t dims[3] = {(cuuint64_t)Bp, (cuuint64_t)m, TROWS};
  const cuuint64_t strides[2] = {sizeof(float) * (cuuint64_t)Bp,
                                 sizeof(float) * (cuuint64_t)Bp * m};
  const cuuint32_t box[3] = {CB, TP, TROWS};
  const cuuint32_t unit[3] = {1, 1, 1};
  if (encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
             const_cast<void*>(Xt), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return -1;
  kept[next_slot] = TriMap{device, Xt, m, Bp, *map};
  next_slot = (next_slot + 1) % 16;
  if (n_kept < 16) ++n_kept;
  return 0;
}

// K1 in highest: X1 is unused, re1 gives the chunk ranges, X2 is the
// k-major copy of (X1, re1) (ops/kff.py tri_operand, 16-byte aligned);
// re2, m2, B2 must repeat re1, m1, B1.
template <int SEL, int KIND>
int launch_tri(const float* re1, int m1, int B1, const float* X2,
               const float* re2, int m2, int B2, float* out, float* outd,
               float sigma2, float gamma, int zeta, long long k0,
               long long nk, long long ldo, int trans, void* stream) {
  const int nc = (B1 + CB - 1) / CB;
  const size_t ranges = sizeof(float) * 4 * (size_t)nc;
  dim3 grid;
  if (trans || ldo < 3LL * m1 || re2 != re1 || m2 != m1 || B2 != B1 ||
      ranges > kRangeBytes || ((uintptr_t)X2 & 15) ||
      !grid_of<1>(m1, m1, k0, nk, grid))
    return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  if (tri_map(X2, m1, nc * CB, &map) != 0)
    return (int)cudaErrorInvalidValue;
  tri_kernel<SEL, KIND>
      <<<grid, NT, tri_ring_bytes() + ranges, (cudaStream_t)stream>>>(
          map, re1, m1, B1, out, outd, ldo, sigma2, gamma, zeta, k0);
  return (int)cudaGetLastError();
}

}  // namespace

// Every entry point: (X1, re1, m1, B1, X2, re2, m2, B2, out, outd, sigma2,
// gamma, zeta, k0, nk, ldo, trans, stream).  K_FF: out (3 m1, 3 m2); K_EF:
// out (m1, 3 m2) from energy operands (U1, w1 = [valid/count, element])
// against force operands; ldo is the leading dimension of out and outd
// (at least 3 m2).  outd receives dK/dgamma for _dual and is unused
// otherwise; gamma is unused by _dot.  K1 (kff_tri*) takes re2 = re1, m2
// = m1, B2 = B1, and X2 = X1 in the bf16 modes, but in highest X2 = the
// k-major copy of (X1, re1) (ops/kff.py tri_operand: kff_tri_rows() rows
// of m1 points of B1 envs rounded up to 4); it writes tiles [k0, k0 + nk)
// of the upper triangle and their transposes, nothing else: the whole
// range gives an exactly symmetric out (and outd), a part of it needs out
// zeroed by the caller.  k0 and nk are unused by the rectangular kernels.
// trans != 0 (the highest kef_rect* alone; any other kernel refuses it)
// stores K_EF transposed, out (3 m2, m1) with ldo at least m1.
#define COV_ENTRY(NAME, LC, MODE, SEL, KIND, PREC)                          \
  int NAME(const void* X1, const float* re1, int m1, int B1,                \
           const void* X2, const float* re2, int m2, int B2, float* out,    \
           float* outd, float sigma2, float gamma, int zeta, long long k0,  \
           long long nk, long long ldo, int trans, void* stream) {          \
    return launch<LC, MODE, SEL, KIND, PREC>(X1, re1, m1, B1, X2, re2, m2,  \
                                             B2, out, outd, sigma2, gamma,  \
                                             zeta, k0, nk, ldo, trans,      \
                                             stream);                       \
  }

#define RECT_ENTRY(NAME, LC, SEL, KIND)                                     \
  int NAME(const void* X1, const float* re1, int m1, int B1,                \
           const void* X2, const float* re2, int m2, int B2, float* out,    \
           float* outd, float sigma2, float gamma, int zeta, long long,     \
           long long, long long ldo, int trans, void* stream) {             \
    return launch_rect<LC, SEL, KIND>(                                      \
        static_cast<const float*>(X1), re1, m1, B1,                         \
        static_cast<const float*>(X2), re2, m2, B2, out, outd, sigma2,      \
        gamma, zeta, ldo, trans, stream);                                   \
  }

#define TRI_ENTRY(NAME, SEL, KIND)                                          \
  int NAME(const void*, const float* re1, int m1, int B1, const void* X2,   \
           const float* re2, int m2, int B2, float* out, float* outd,       \
           float sigma2, float gamma, int zeta, long long k0, long long nk, \
           long long ldo, int trans, void* stream) {                        \
    return launch_tri<SEL, KIND>(re1, m1, B1,                               \
                                 static_cast<const float*>(X2), re2, m2,    \
                                 B2, out, outd, sigma2, gamma, zeta, k0,    \
                                 nk, ldo, trans, stream);                   \
  }

#define TRI_FAMILY(SUFFIX, PREC)                                    \
  COV_ENTRY(kff_tri##SUFFIX, 4, 1, KONLY, RBF, PREC)                \
  COV_ENTRY(kff_tri_dual##SUFFIX, 4, 1, DUAL, RBF, PREC)            \
  COV_ENTRY(kff_tri_deriv##SUFFIX, 4, 1, DERIV, RBF, PREC)          \
  COV_ENTRY(kff_tri_dot##SUFFIX, 4, 1, KONLY, DOT, PREC)

#define RECT_FAMILY(SUFFIX, PREC)                                   \
  COV_ENTRY(kef_rect##SUFFIX, 1, 0, KONLY, RBF, PREC)               \
  COV_ENTRY(kef_rect_dual##SUFFIX, 1, 0, DUAL, RBF, PREC)           \
  COV_ENTRY(kef_rect_deriv##SUFFIX, 1, 0, DERIV, RBF, PREC)         \
  COV_ENTRY(kef_rect_dot##SUFFIX, 1, 0, KONLY, DOT, PREC)           \
  COV_ENTRY(kff_rect##SUFFIX, 4, 0, KONLY, RBF, PREC)               \
  COV_ENTRY(kff_rect_dual##SUFFIX, 4, 0, DUAL, RBF, PREC)           \
  COV_ENTRY(kff_rect_deriv##SUFFIX, 4, 0, DERIV, RBF, PREC)         \
  COV_ENTRY(kff_rect_dot##SUFFIX, 4, 0, KONLY, DOT, PREC)

extern "C" {
TRI_ENTRY(kff_tri, KONLY, RBF)
TRI_ENTRY(kff_tri_dual, DUAL, RBF)
TRI_ENTRY(kff_tri_deriv, DERIV, RBF)
TRI_ENTRY(kff_tri_dot, KONLY, DOT)
RECT_ENTRY(kef_rect, 1, KONLY, RBF)
RECT_ENTRY(kef_rect_dual, 1, DUAL, RBF)
RECT_ENTRY(kef_rect_deriv, 1, DERIV, RBF)
RECT_ENTRY(kef_rect_dot, 1, KONLY, DOT)
RECT_ENTRY(kff_rect, 4, KONLY, RBF)
RECT_ENTRY(kff_rect_dual, 4, DUAL, RBF)
RECT_ENTRY(kff_rect_deriv, 4, DERIV, RBF)
RECT_ENTRY(kff_rect_dot, 4, KONLY, DOT)
TRI_FAMILY(_bf16x4, BF16X4)
RECT_FAMILY(_bf16x4, BF16X4)
TRI_FAMILY(_bf16, BF16)
RECT_FAMILY(_bf16, BF16)

// The shared-memory limits of the twelve highest kernels on the current
// device: the library's loader calls it once for each device before the
// first launch there.  Returns the first CUDA error.
int kff_rect_init() {
  const cudaError_t rcs[] = {
      rect_init<1, KONLY, RBF>(), rect_init<1, DUAL, RBF>(),
      rect_init<1, DERIV, RBF>(), rect_init<1, KONLY, DOT>(),
      rect_init<4, KONLY, RBF>(), rect_init<4, DUAL, RBF>(),
      rect_init<4, DERIV, RBF>(), rect_init<4, KONLY, DOT>(),
      tri_init<KONLY, RBF>(),     tri_init<DUAL, RBF>(),
      tri_init<DERIV, RBF>(),     tri_init<KONLY, DOT>()};
  for (cudaError_t rc : rcs)
    if (rc != cudaSuccess) return (int)rc;
  return 0;
}

// The rows of the k-major copy the highest K1 kernels read (X2).
int kff_tri_rows() { return TROWS; }

// One launch of an empty kernel (the launch floor chip_smoke.py reports).
int kff_empty(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
}  // extern "C"
