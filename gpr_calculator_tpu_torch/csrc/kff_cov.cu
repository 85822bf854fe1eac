// Force-force and energy-force covariance blocks of the RBF and Dot
// many-body kernels for sm_90a: exact fp32 FMA on CUDA cores ("highest")
// or bf16 tensor-core products with fp32 sums (the "bf16x4" and "bf16"
// matmul precisions).  Plain C interface, loaded from Python with ctypes
// (gpr_calculator_tpu_torch/ops/kff.py), which compiles every source of
// this directory and links them into one library:
//   kff_cov.cu      cov_kernel: K1 in the bf16 modes (this file)
//   kff_rect.cu     rect_kernel: K2 and K3 in highest
//   kff_rect_mma.cu rect_mma_kernel: K2 and K3 in the bf16 modes
//   kff_tri.cu      tri_kernel: K1 in highest (the tensor-map path)
//   kff_common.cuh  the geometry and the helpers they share
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
// and each in the three matmul precisions of kff_pallas.py:38-63
// (_pair_blocks :151, _lhs_rhs :394): no further suffix for highest, then
// _bf16x4 and _bf16.
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
// the tensor cores' bf16 rate) and the assembly, not device memory.
//
// cov_kernel (K1 in the modes) takes the dot products for every env pair;
// the element mask skips only the coefficients and the assembly.  Its
// design keeps every env-pair intermediate in registers: one block (8
// warps) owns a tile of 8 x 8 points and loops over 4-env chunks of both
// sides staged in shared memory; each thread owns a 2 x 2 env micro-tile
// of one point pair and its 16 dot products, reduces env -> point in
// registers across the chunks, then over the 4 threads of its point pair
// with warp shuffles.  It stages the bf16 parts env-major (k contiguous,
// the layout mma.row.col reads) and takes the dot products with mma.sync
// m16n8k16: warp (wa, wb) multiplies 16 lhs envs x 4 components (4
// m-tiles) by 8 rhs envs x 4 components (4 n-tiles), and the lhs envs are
// staged so that fragment row g holds env 2g and row g + 8 env 2g + 1:
// then each thread's accumulators hold all (c1, c2) products of its lhs
// envs 2g, 2g+1 and rhs envs 2q, 2q+1 (q = lane % 4), one point pair's
// 2 x 2 micro-tile, and the assembly is the same code.  The Dot variants
// differ from the RBF ones in the coefficients alone (KIND).  No block
// reads another's output, the ragged point and env edges are masked at
// load, and the (p,u) x (q,v) interleaved layout is written directly.  K1
// derives its upper-triangle tile pair (I <= J) from the linear block
// index and writes each tile and its transpose; on diagonal tiles only
// the upper entries are computed into the output, so the result is
// exactly symmetric.
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

#include "kff_common.cuh"

namespace {

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

// K1 in the bf16 modes: the upper-triangle tiles of a symmetric K_FF from
// the linear index k0 + blockIdx.x (X1 = X2, re1 = re2).
// SEL = KONLY: K into out; DUAL: K into out and dK/dgamma into outd;
// DERIV: dK/dgamma into out.
// KIND = RBF (gamma = 1 / (2 l^2)) or DOT (gamma unused).
// PREC = BF16X4 or BF16 (tensor cores).
// It asks for two resident blocks per SM, which caps it at 128 registers:
// left free, ptxas gave some instantiations 129-139 registers, the card
// then held one block per SM and they ran slower (PERF.md).
template <int SEL, int KIND, int PREC>
__global__ void __launch_bounds__(NT, 2)
cov_kernel(const void* __restrict__ X1, const float* __restrict__ re1,
           int m1, int B1, const void* __restrict__ X2,
           const float* __restrict__ re2, int m2, int B2,
           float* __restrict__ out, float* __restrict__ outd, long long ldo,
           float sigma2, float gamma, int zeta, long long k0) {
  static_assert(KIND == RBF || SEL == KONLY,
                "the Dot kernel has no dK/dgamma pass");
  constexpr int LC = 4;                  // lhs components [u; Jt]
  constexpr int NPL = 9;                 // planes per coefficient set
  constexpr int NS = SEL == DUAL ? 2 : 1;
  constexpr int NOUT = NPL * NS;
  constexpr int DSET = SEL == DUAL ? NPL : 0;   // first dK/dgamma plane
  constexpr int NP = PREC == BF16X4 ? 2 : 1;    // bf16 parts per value
  __shared__ __align__(16) Staged<LC, PREC> s1;
  __shared__ __align__(16) Staged<4, PREC> s2;
  __shared__ float sre1[2][NE];
  __shared__ float sre2[2][NE];

  int I, J;
  tri_tile(k0 + blockIdx.x, I, J);

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
          // A: coefficient of m_uv; Bc: of p1_u p2_v; both carry the pair
          // weight w
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
    if (I < J || pl < ql) {
#pragma unroll
      for (int u = 0; u < 3; ++u)
#pragma unroll
        for (int v = 0; v < 3; ++v)
          o[(long long)(3 * p + u) * ldo + 3 * q + v] =
              acc[a + u * 3 + v];
#pragma unroll
      for (int u = 0; u < 3; ++u)
#pragma unroll
        for (int v = 0; v < 3; ++v)
          o[(long long)(3 * q + v) * ldo + 3 * p + u] =
              acc[a + u * 3 + v];
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

// An empty kernel: the floor of one launch on this card.
__global__ void empty_kernel() {}

// Tiles [k0, k0 + nk) of the upper triangle of one (m1 = m2) point set;
// a range outside the triangle, or trans, is refused.  Returns the launch
// status.
template <int SEL, int KIND, int PREC>
int launch(const void* X1, const float* re1, int m1, int B1, const void* X2,
           const float* re2, int m2, int B2, float* out, float* outd,
           float sigma2, float gamma, int zeta, long long k0, long long nk,
           long long ldo, int trans, void* stream) {
  const long long nt = tiles(m1);
  if (trans || ldo < 3LL * m2 || k0 < 0 || nk < 1 || nk > 0x7fffffffLL ||
      k0 + nk > nt * (nt + 1) / 2)
    return (int)cudaErrorInvalidValue;
  cov_kernel<SEL, KIND, PREC>
      <<<dim3((unsigned)nk), NT, 0, (cudaStream_t)stream>>>(
          X1, re1, m1, B1, X2, re2, m2, B2, out, outd, ldo, sigma2, gamma,
          zeta, k0);
  return (int)cudaGetLastError();
}

}  // namespace

// Every entry point of the library: (X1, re1, m1, B1, X2, re2, m2, B2,
// out, outd, sigma2, gamma, zeta, k0, nk, ldo, trans, stream).  K_FF: out
// (3 m1, 3 m2); K_EF: out (m1, 3 m2) from energy operands (U1, w1 =
// [valid/count, element]) against force operands; ldo is the leading
// dimension of out and outd (at least 3 m2).  outd receives dK/dgamma for
// _dual and is unused otherwise; gamma is unused by _dot.  K1 (kff_tri*)
// takes re2 = re1, m2 = m1, B2 = B1, and X2 = X1 in the bf16 modes, but in
// highest X2 = the k-major copy of (X1, re1) (kff_tri.cu); it writes tiles
// [k0, k0 + nk) of the upper triangle and their transposes, nothing else:
// the whole range gives an exactly symmetric out (and outd), a part of it
// needs out zeroed by the caller.  k0 and nk are unused by the rectangular
// kernels.  trans != 0 (the kef_rect* kernels of every mode; K1 and K3
// refuse it) stores K_EF transposed, out (3 m2, m1) with ldo at least m1.
#define COV_ENTRY(NAME, SEL, KIND, PREC)                                    \
  int NAME(const void* X1, const float* re1, int m1, int B1,                \
           const void* X2, const float* re2, int m2, int B2, float* out,    \
           float* outd, float sigma2, float gamma, int zeta, long long k0,  \
           long long nk, long long ldo, int trans, void* stream) {          \
    return launch<SEL, KIND, PREC>(X1, re1, m1, B1, X2, re2, m2, B2, out,   \
                                   outd, sigma2, gamma, zeta, k0, nk, ldo,  \
                                   trans, stream);                          \
  }

#define TRI_FAMILY(SUFFIX, PREC)                             \
  COV_ENTRY(kff_tri##SUFFIX, KONLY, RBF, PREC)               \
  COV_ENTRY(kff_tri_dual##SUFFIX, DUAL, RBF, PREC)           \
  COV_ENTRY(kff_tri_deriv##SUFFIX, DERIV, RBF, PREC)         \
  COV_ENTRY(kff_tri_dot##SUFFIX, KONLY, DOT, PREC)

extern "C" {
TRI_FAMILY(_bf16x4, BF16X4)
TRI_FAMILY(_bf16, BF16)

// One launch of an empty kernel (the launch floor chip_smoke.py reports).
int kff_empty(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
}  // extern "C"
