// K1 (kff_tri*_f64), K2 (kef_rect*_f64) and K3 (kff_rect*_f64) in
// float64: the covariance blocks of a model in the JAX package's default
// x64 mode (GPR_CALC_TPU_X64=1), on tri_f64_kernel<SEL, KIND> and
// rect_f64_kernel<LC, SEL, KIND>.  Plain C interface, loaded with ctypes
// by ops/kff.py, which builds every source of this directory into one
// library; kff_common.cuh has the operands and the per-env-pair
// arithmetic, which these kernels compute in double (exp in double).
//
// They replace, for float64 operands, _kff_kernel_tri (kff_pallas.py:282,
// K1), _kef_kernel (kff_pallas.py:748, K2) and _kff_kernel
// (kff_pallas.py:269, K3).  The Pallas gate admits float32 operands
// alone (gpr_calculator_tpu/ops/kernels.py:787-801), so in float64 the
// JAX package builds these blocks with XLA: kff_self (:429), kef (:215)
// and kff (:365).
//
// What bounds them on this card: the FP64 FMA rate of the env-pair dot
// products and of the assembly (operations; the operands, 98 MB at 3000
// force points x 32 envs, stay in L2).  The design is the simple one:
//  * One stage in dynamic shared memory (70 KB: a chunk of 8 points x 4
//    envs of each side, k-major rows of stride KD doubles), filled by
//    plain 16-byte loads between two block barriers; no ring, no TMA, no
//    tensor cores (DMMA).  A lhs chunk already staged is not copied again.
//  * The element skip of the float32 kernels: every block first reads the
//    element range of each of its env chunks (chunk_range on double), a
//    chunk pair whose ranges cannot meet is never staged, and inside a
//    staged pair a warp whose own lhs point cannot meet the rhs chunk
//    skips its dot products.  A skipped pair is one whose every weight is
//    zero, which the assembly never adds: the sums are the same bit for
//    bit whatever is skipped.
//  * The order of the sums is the float32 kernels' (kff_common.cuh): a
//    thread owns the 2 x 2 env micro-tile of one point pair, adds its env
//    pairs in order over the chunk pairs in nested order, then the four
//    lanes of the pair are summed by shuffles.  It depends on the point
//    pair's own envs alone, never on the grid, so K3 stripes cut at whole
//    tiles equal the single launch, and a K1 tile range (the tile body
//    does not know the range) summed over shards equals the single launch
//    bit for bit.
//  * The 16 dot products of a micro-tile's four env pairs (K3, K1) stay in
//    registers as doubles (128 registers), so a block of 256 threads takes
//    an SM's register file alone: __launch_bounds__(NT, 1).
// K1 walks upper-triangle tiles [k0, k0 + gridDim.x), one a block, and
// writes each tile and its transpose (a diagonal tile's upper entries
// mirrored), so K is exactly symmetric.  K2 can store transposed (K_FE of
// a served block).

#include "kff_common.cuh"

namespace {

constexpr int KD = NE + 2;   // k-row stride (doubles) of a staged chunk:
                             // rows 16-byte aligned for the double2 loads

// doubles of the one stage: lhs chunk (LC components), rhs chunk (4), and
// the [weight, element] rows of both
template <int LC>
struct F64 {
  static constexpr int S1 = LC * DP * KD;
  static constexpr int S2 = 4 * DP * KD;
  static constexpr int STAGE = S1 + S2 + 4 * NE;
};

// Copy envs [e0, e0 + CB) of points [p0, p0 + TP) of one side's NC
// component rows into shared memory, k-major: s[(c * DP + k) * KD + env],
// env = point_local * CB + e; what lies past the point or env count
// arrives as zeros.  A thread reads two consecutive k (16 bytes).
template <int NC>
__device__ __forceinline__ void stage_f64(const double* __restrict__ X,
                                          int m, int B, int p0, int e0,
                                          double* __restrict__ s) {
  const long long N = (long long)m * B;
  constexpr int KP = DP / 2;
  for (int idx = threadIdx.x; idx < NC * NE * KP; idx += NT) {
    const int kp = idx % KP;
    const int env = (idx / KP) % NE;
    const int c = idx / (NE * KP);
    const int p = p0 + env / CB;
    const int e = e0 + env % CB;
    double2 v = make_double2(0.0, 0.0);
    if (p < m && e < B)
      v = *reinterpret_cast<const double2*>(
          X + (c * N + (long long)p * B + e) * DP + 2 * kp);
    double* const dst = s + (c * DP + 2 * kp) * KD + env;
    dst[0] = v.x;
    dst[KD] = v.y;
  }
}

// The [weight, element] rows of the same envs: sre[row * NE + env].
__device__ __forceinline__ void stage_re_f64(const double* __restrict__ re,
                                             int m, int B, int p0, int e0,
                                             double* __restrict__ sre) {
  const long long N = (long long)m * B;
  for (int idx = threadIdx.x; idx < 2 * NE; idx += NT) {
    const int row = idx / NE;
    const int env = idx % NE;
    const int p = p0 + env / CB;
    const int e = e0 + env % CB;
    sre[idx] = p < m && e < B ? re[row * N + (long long)p * B + e] : 0.0;
  }
}

// Accumulators of one point pair: 9 (K_FF) or 3 (K_EF) planes a set, one
// set (K, or dK/dgamma) or two (DUAL).
template <int LC, int SEL>
struct Acc {
  static constexpr int NPL = LC == 4 ? 9 : 3;
  static constexpr int NS = SEL == DUAL ? 2 : 1;
  static constexpr int NOUT = NPL * NS;
  static constexpr int DSET = SEL == DUAL ? NPL : 0;
};

// The sums of lhs tile I against rhs tile J into this thread's acc,
// reduced over the four lanes of its point pair (pl = warp, ql = lane /
// 4).  LC = 4: K_FF, both sides force operands; LC = 1: K_EF, the lhs
// side energy operands.  smem: the stage, then the chunk ranges.
template <int LC, int SEL, int KIND>
__device__ __forceinline__ void f64_tile(
    const double* __restrict__ X1, const double* __restrict__ re1, int m1,
    int B1, const double* __restrict__ X2, const double* __restrict__ re2,
    int m2, int B2, int I, int J, double sigma2, double gamma, int zeta,
    double* __restrict__ smem, double (&acc)[Acc<LC, SEL>::NOUT]) {
  static_assert(KIND == RBF || SEL == KONLY,
                "the Dot kernel has no dK/dgamma pass");
  using S = F64<LC>;
  constexpr int DSET = Acc<LC, SEL>::DSET;
  const int nca = (B1 + CB - 1) / CB;
  const int ncb = (B2 + CB - 1) / CB;
  double* const s1 = smem;
  double* const s2 = s1 + S::S1;
  double* const sw1 = s2 + S::S2;   // lhs weights, elements, rhs ...
  double* const se1 = sw1 + NE;
  double* const sw2 = se1 + NE;
  double* const se2 = sw2 + NE;
  double* const rng1 = smem + S::STAGE;
  double* const rng2 = rng1 + 2 * nca;

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int pl = warp;
  const int ql = lane >> 2;
  const int a0 = pl * CB + ((lane >> 1) & 1) * 2;
  const int b0 = ql * CB + (lane & 1) * 2;

  for (int ch = warp; ch < nca + ncb; ch += NT / 32) {
    if (ch < nca)
      chunk_range<NE, CB, double>(re1, m1, B1, I * TP, ch, rng1);
    else
      chunk_range<NE, CB, double>(re2, m2, B2, J * TP, ch - nca, rng2);
  }
#pragma unroll
  for (int i = 0; i < Acc<LC, SEL>::NOUT; ++i) acc[i] = 0.0;
  __syncthreads();

  int held = -1;   // the lhs chunk the stage holds
  for (int a = 0; a < nca; ++a) {
    for (int b = 0; b < ncb; ++b) {
      if (rng1[2 * a + 1] < rng2[2 * b] || rng2[2 * b + 1] < rng1[2 * a])
        continue;
      if (held != a) {
        stage_f64<LC>(X1, m1, B1, I * TP, a * CB, s1);
        stage_re_f64(re1, m1, B1, I * TP, a * CB, sw1);
        held = a;
      }
      stage_f64<4>(X2, m2, B2, J * TP, b * CB, s2);
      stage_re_f64(re2, m2, B2, J * TP, b * CB, sw2);
      __syncthreads();

      // this warp's lhs point against the rhs chunk's range
      double wlo = INFINITY, whi = -INFINITY;
#pragma unroll
      for (int i = 0; i < CB; ++i) {
        const double el = se1[pl * CB + i];
        if (sw1[pl * CB + i] != 0.0) {
          wlo = fmin(wlo, el);
          whi = fmax(whi, el);
        }
      }
      if (!(whi < rng2[2 * b] || rng2[2 * b + 1] < wlo)) {
        // G[c1 * 4 + c2][ia * 2 + ib] = X1[c1]_(a0+ia) . X2[c2]_(b0+ib)
        double G[LC * 4][4];
#pragma unroll
        for (int c = 0; c < LC * 4; ++c)
#pragma unroll
          for (int i = 0; i < 4; ++i) G[c][i] = 0.0;
#pragma unroll 2
        for (int k = 0; k < DP; ++k) {
          double2 l[LC], r[4];
#pragma unroll
          for (int c = 0; c < LC; ++c)
            l[c] = *reinterpret_cast<const double2*>(s1 + (c * DP + k) * KD +
                                                     a0);
#pragma unroll
          for (int c = 0; c < 4; ++c)
            r[c] = *reinterpret_cast<const double2*>(s2 + (c * DP + k) * KD +
                                                     b0);
#pragma unroll
          for (int c1 = 0; c1 < LC; ++c1)
#pragma unroll
            for (int c2 = 0; c2 < 4; ++c2) {
              double* gc = G[c1 * 4 + c2];
              gc[0] = fma(l[c1].x, r[c2].x, gc[0]);
              gc[1] = fma(l[c1].x, r[c2].y, gc[1]);
              gc[2] = fma(l[c1].y, r[c2].x, gc[2]);
              gc[3] = fma(l[c1].y, r[c2].y, gc[3]);
            }
        }
#pragma unroll
        for (int ia = 0; ia < 2; ++ia)
#pragma unroll
          for (int ib = 0; ib < 2; ++ib) {
            const int e = ia * 2 + ib;
            const double same = se1[a0 + ia] == se2[b0 + ib] ? 1.0 : 0.0;
            const double w = sw1[a0 + ia] * sw2[b0 + ib] * same;
            if (w == 0.0) continue;
            const double c = G[0][e];
            double d1, dm2;
            powers(c, zeta, d1, dm2);
            const double D = d1 * c;
            const double zd1 = (double)zeta * d1;
            const double b0c = (double)(zeta * (zeta - 1)) * dm2;
            // A: coefficient of m_uv (K_FF) and -A of p2_v (K_EF); Bc: of
            // p1_u p2_v (K_FF); both carry the pair weight w
            double k = 0.0, A, Bc;
            if constexpr (KIND == DOT) {
              A = sigma2 * zd1 * w;
              Bc = sigma2 * b0c * w;
            } else {
              k = sigma2 * exp((D - 1.0) * gamma);
              const double kg = k * gamma;
              A = kg * zd1 * w;
              Bc = kg * (b0c + zd1 * zd1 * gamma) * w;
            }
            if constexpr (LC == 4) {
              if constexpr (SEL != DERIV) {
#pragma unroll
                for (int u = 0; u < 3; ++u) {
                  const double Bp1 = Bc * G[(1 + u) * 4][e];
#pragma unroll
                  for (int v = 0; v < 3; ++v)
                    acc[u * 3 + v] += A * G[(1 + u) * 4 + 1 + v][e] +
                                      Bp1 * G[1 + v][e];
                }
              }
              if constexpr (SEL != KONLY) {
                const double Dm1 = D - 1.0;
                const double kw = k * w;
                const double dA = A * Dm1 + kw * zd1;
                const double dB =
                    Bc * Dm1 + kw * (b0c + 2.0 * zd1 * zd1 * gamma);
#pragma unroll
                for (int u = 0; u < 3; ++u) {
                  const double dBp1 = dB * G[(1 + u) * 4][e];
#pragma unroll
                  for (int v = 0; v < 3; ++v)
                    acc[DSET + u * 3 + v] +=
                        dA * G[(1 + u) * 4 + 1 + v][e] + dBp1 * G[1 + v][e];
                }
              }
            } else {
              const double A0 = -A;
              if constexpr (SEL != DERIV) {
#pragma unroll
                for (int v = 0; v < 3; ++v) acc[v] += A0 * G[1 + v][e];
              }
              if constexpr (SEL != KONLY) {
                const double dA0 = A0 * (D - 1.0) - k * w * zd1;
#pragma unroll
                for (int v = 0; v < 3; ++v)
                  acc[DSET + v] += dA0 * G[1 + v][e];
              }
            }
          }
      }
      __syncthreads();
    }
  }

  // reduce the micro-tiles of one point pair: lanes xor 1, xor 2
#pragma unroll
  for (int i = 0; i < Acc<LC, SEL>::NOUT; ++i) {
    acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], 1);
    acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], 2);
  }
}

// K2 (LC = 1) and K3 (LC = 4) in float64: blockIdx.y = lhs tile,
// blockIdx.x = rhs tile.  out (and outd for DUAL) have leading dimension
// ldo; trans (K_EF only) stores out[(3 q + v) * ldo + p].
template <int LC, int SEL, int KIND>
__global__ void __launch_bounds__(NT, 1)
rect_f64_kernel(const double* __restrict__ X1, const double* __restrict__ re1,
                int m1, int B1, const double* __restrict__ X2,
                const double* __restrict__ re2, int m2, int B2,
                double* __restrict__ out, double* __restrict__ outd,
                long long ldo, int trans, double sigma2, double gamma,
                int zeta) {
  using C = Acc<LC, SEL>;
  extern __shared__ __align__(16) double smem_f64[];
  const int I = blockIdx.y, J = blockIdx.x;
  double acc[C::NOUT];
  f64_tile<LC, SEL, KIND>(X1, re1, m1, B1, X2, re2, m2, B2, I, J, sigma2,
                          gamma, zeta, smem_f64, acc);
  const int lane = threadIdx.x & 31;
  if ((lane & 3) != 0) return;
  const int p = I * TP + (threadIdx.x >> 5);
  const int q = J * TP + (lane >> 2);
  if (p >= m1 || q >= m2) return;
#pragma unroll
  for (int sset = 0; sset < C::NS; ++sset) {
    double* __restrict__ o = sset == 0 ? out : outd;
    const int s0 = sset * C::NPL;
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

// K1 in float64: tiles [k0, k0 + gridDim.x) of the upper triangle of one
// operand (X, re), each written with its transpose.
template <int SEL, int KIND>
__global__ void __launch_bounds__(NT, 1)
tri_f64_kernel(const double* __restrict__ X, const double* __restrict__ re,
               int m, int B, double* __restrict__ out,
               double* __restrict__ outd, long long ldo, double sigma2,
               double gamma, int zeta, long long k0) {
  using C = Acc<4, SEL>;
  extern __shared__ __align__(16) double smem_f64[];
  int I, J;
  tri_tile(k0 + blockIdx.x, I, J);
  double acc[C::NOUT];
  f64_tile<4, SEL, KIND>(X, re, m, B, X, re, m, B, I, J, sigma2, gamma,
                         zeta, smem_f64, acc);
  const int lane = threadIdx.x & 31;
  if ((lane & 3) != 0) return;
  const int pl = threadIdx.x >> 5, ql = lane >> 2;
  const int p = I * TP + pl;
  const int q = J * TP + ql;
  if (p >= m || q >= m) return;
#pragma unroll
  for (int sset = 0; sset < C::NS; ++sset) {
    double* __restrict__ o = sset == 0 ? out : outd;
    const int s0 = sset * C::NPL;
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
          const double x = acc[s0 + u * 3 + v];
          o[(long long)(3 * p + u) * ldo + 3 * p + v] = x;
          o[(long long)(3 * p + v) * ldo + 3 * p + u] = x;
        }
    }
  }
}

template <int LC>
constexpr size_t f64_stage_bytes() {
  return sizeof(double) * (size_t)F64<LC>::STAGE;
}

// Every (lhs tile, rhs tile), the stage and the chunk ranges in dynamic
// shared memory.  Returns the launch status.
template <int LC, int SEL, int KIND>
int launch_rect_f64(const double* X1, const double* re1, int m1, int B1,
                    const double* X2, const double* re2, int m2, int B2,
                    double* out, double* outd, double sigma2, double gamma,
                    int zeta, long long ldo, int trans, void* stream) {
  if (trans ? (LC != 1 || ldo < m1) : ldo < 3LL * m2)
    return (int)cudaErrorInvalidValue;
  const int nca = (B1 + CB - 1) / CB;
  const int ncb = (B2 + CB - 1) / CB;
  const size_t ranges = sizeof(double) * 2 * ((size_t)nca + ncb);
  if (ranges > kRangeBytes) return (int)cudaErrorInvalidValue;
  dim3 grid(tiles(m2), tiles(m1));
  rect_f64_kernel<LC, SEL, KIND>
      <<<grid, NT, f64_stage_bytes<LC>() + ranges, (cudaStream_t)stream>>>(
          X1, re1, m1, B1, X2, re2, m2, B2, out, outd, ldo, trans, sigma2,
          gamma, zeta);
  return (int)cudaGetLastError();
}

// Tiles [k0, k0 + nk) of the upper triangle of one (m1 = m2) point set:
// X2, re2, m2, B2 must repeat X1, re1, m1, B1, and the range must lie
// inside the triangle.  Returns the launch status.
template <int SEL, int KIND>
int launch_tri_f64(const double* X1, const double* re1, int m1, int B1,
                   const double* X2, const double* re2, int m2, int B2,
                   double* out, double* outd, double sigma2, double gamma,
                   int zeta, long long k0, long long nk, long long ldo,
                   int trans, void* stream) {
  const int nc = (B1 + CB - 1) / CB;
  const size_t ranges = sizeof(double) * 4 * (size_t)nc;
  const long long nt = tiles(m1);
  if (trans || ldo < 3LL * m1 || X2 != X1 || re2 != re1 || m2 != m1 ||
      B2 != B1 || ranges > kRangeBytes || k0 < 0 || nk < 1 ||
      nk > 0x7fffffffLL || k0 + nk > nt * (nt + 1) / 2)
    return (int)cudaErrorInvalidValue;
  tri_f64_kernel<SEL, KIND>
      <<<dim3((unsigned)nk), NT, f64_stage_bytes<4>() + ranges,
         (cudaStream_t)stream>>>(X1, re1, m1, B1, out, outd, ldo, sigma2,
                                 gamma, zeta, k0);
  return (int)cudaGetLastError();
}

template <int LC, int SEL, int KIND>
cudaError_t rect_f64_init() {
  return smem_init(rect_f64_kernel<LC, SEL, KIND>,
                   f64_stage_bytes<LC>() + kRangeBytes);
}

template <int SEL, int KIND>
cudaError_t tri_f64_init() {
  return smem_init(tri_f64_kernel<SEL, KIND>,
                   f64_stage_bytes<4>() + kRangeBytes);
}

}  // namespace

cudaError_t kff::f64_init() {
  const cudaError_t rcs[] = {
      tri_f64_init<KONLY, RBF>(),     tri_f64_init<DUAL, RBF>(),
      tri_f64_init<DERIV, RBF>(),     tri_f64_init<KONLY, DOT>(),
      rect_f64_init<1, KONLY, RBF>(), rect_f64_init<1, DUAL, RBF>(),
      rect_f64_init<1, DERIV, RBF>(), rect_f64_init<1, KONLY, DOT>(),
      rect_f64_init<4, KONLY, RBF>(), rect_f64_init<4, DUAL, RBF>(),
      rect_f64_init<4, DERIV, RBF>(), rect_f64_init<4, KONLY, DOT>()};
  for (cudaError_t rc : rcs)
    if (rc != cudaSuccess) return rc;
  return cudaSuccess;
}

// Entry points: (X1, re1, m1, B1, X2, re2, m2, B2, out, outd, sigma2,
// gamma, zeta, k0, nk, ldo, trans, stream), as every entry point of the
// library (kff_common.cuh), with re, out, sigma2 and gamma in double and
// X float64 (4, N, 32) (K2's lhs (N, 32)).  K1: X2 = X1, tiles [k0, k0 +
// nk) of the upper triangle and their transposes written, nothing else;
// K2 and K3 ignore k0 and nk.
#define F64_ARGS                                                            \
  const void *X1, const double *re1, int m1, int B1, const void *X2,        \
      const double *re2, int m2, int B2, double *out, double *outd,         \
      double sigma2, double gamma, int zeta, long long k0, long long nk,    \
      long long ldo, int trans, void *stream
#define TRI_F64_ENTRY(NAME, SEL, KIND)                                      \
  int NAME(F64_ARGS) {                                                      \
    return launch_tri_f64<SEL, KIND>(                                       \
        static_cast<const double*>(X1), re1, m1, B1,                        \
        static_cast<const double*>(X2), re2, m2, B2, out, outd, sigma2,     \
        gamma, zeta, k0, nk, ldo, trans, stream);                           \
  }
#define RECT_F64_ENTRY(NAME, LC, SEL, KIND)                                 \
  int NAME(F64_ARGS) {                                                      \
    return launch_rect_f64<LC, SEL, KIND>(                                  \
        static_cast<const double*>(X1), re1, m1, B1,                        \
        static_cast<const double*>(X2), re2, m2, B2, out, outd, sigma2,     \
        gamma, zeta, ldo, trans, stream);                                   \
  }

extern "C" {
TRI_F64_ENTRY(kff_tri_f64, KONLY, RBF)
TRI_F64_ENTRY(kff_tri_dual_f64, DUAL, RBF)
TRI_F64_ENTRY(kff_tri_deriv_f64, DERIV, RBF)
TRI_F64_ENTRY(kff_tri_dot_f64, KONLY, DOT)
RECT_F64_ENTRY(kef_rect_f64, 1, KONLY, RBF)
RECT_F64_ENTRY(kef_rect_dual_f64, 1, DUAL, RBF)
RECT_F64_ENTRY(kef_rect_deriv_f64, 1, DERIV, RBF)
RECT_F64_ENTRY(kef_rect_dot_f64, 1, KONLY, DOT)
RECT_F64_ENTRY(kff_rect_f64, 4, KONLY, RBF)
RECT_F64_ENTRY(kff_rect_dual_f64, 4, DUAL, RBF)
RECT_F64_ENTRY(kff_rect_deriv_f64, 4, DERIV, RBF)
RECT_F64_ENTRY(kff_rect_dot_f64, 4, KONLY, DOT)
}  // extern "C"
