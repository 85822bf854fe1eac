// Force-force and energy-force covariance blocks of the RBF and Dot
// many-body kernels, exact fp32 FMA on CUDA cores (sm_90a).  Plain C
// interface, loaded from Python with ctypes
// (gpr_calculator_tpu_torch/ops/kff.py).
//
// Replaces the Pallas TPU kernels of gpr_calculator_tpu/ops/kff_pallas.py:
//   kff_tri  (K1) <- _kff_kernel_tri  (kff_pallas.py:282), symmetric K_FF
//   kef_rect (K2) <- _kef_kernel      (kff_pallas.py:748), K_EF
//   kff_rect (K3) <- _kff_kernel      (kff_pallas.py:269), rectangular K_FF
//   kff_tri_dual, kef_rect_dual: K1 and K2 with dual=True (the same Pallas
//      kernels' fused (K, dK/dgamma) pass, _coeff_sets kff_pallas.py:199-206
//      and kff_pallas.py:785-791): both planes from one set of env-pair dot
//      products and one expf, for the analytic NLL gradient
//   kff_tri_dot, kef_rect_dot, kff_rect_dot: K1, K2 and K3 with
//      kind="dot" (_coeff_sets kff_pallas.py:189-192, _kef_kernel :780-781)
//
// Operands (built once per block side by ops/kff.py, so every block of one
// training covariance reads the same rounded values):
//   X  (4, N, 32) f32: rows [u; Jt_x; Jt_y; Jt_z] per environment, with
//      u = x/|x| and Jt = J - (J.u) u; descriptor width zero-padded to 32
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
// enters K_EE only, and there is no expf.  The dual planes (dK/dg, RBF
// only) take dA = A (D-1) + k z c^(z-1), dB = B (D-1) + k (z(z-1) c^(z-2)
// + 2 (z c^(z-1))^2 g) and dA0 = A0 (D-1) - k z c^(z-1), with D = c^z.
//
// What bounds them on the card: each env pair costs 16 (K_FF) or 4 (K_EF)
// length-32 dot products -- a thin-k product of the operand rows -- plus
// the coefficients (one expf for RBF, none for Dot) and the assembly.  The
// operands are small (49 MB at 3000 force points x 32 envs) and stay in
// L2, so the kernels are bound by shared-memory bandwidth and fp32 FMA
// throughput, not device memory.  The dot products are taken for every
// env pair; the element mask skips only the coefficients and the
// assembly.
// The design keeps every env-pair intermediate in registers: one block
// owns a tile of 8 x 8 points and loops over 4-env chunks of both sides
// staged in shared memory (k-major, so a warp reads 16 consecutive
// float2); each thread owns a 2 x 2 env micro-tile of one point pair (64
// accumulators, 4 FMA per shared load) and reduces env -> point in
// registers, then over its 4 micro-tiles with warp shuffles.  The Dot
// variants differ from the RBF ones in the coefficients alone (KIND).
// No block reads another's output, the ragged point and env edges are
// masked at load, and the (p,u) x (q,v) interleaved layout is written
// directly.  K1 derives its upper-triangle
// tile pair (I <= J) from the linear block index and writes each tile and
// its transpose; on diagonal tiles only the upper entries are computed
// into the output, so the result is exactly symmetric.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int DP = 32;        // padded descriptor width
constexpr int TP = 8;         // points per tile side
constexpr int CB = 4;         // envs per point per chunk
constexpr int NE = TP * CB;   // envs per chunk per side
constexpr int NT = 256;       // threads per block: TP x TP x 2 x 2
constexpr int RBF = 0;        // kernel families (template KIND)
constexpr int DOT = 1;

// Stage envs [e0, e0+CB) of points [p0, p0+TP) of one side into shared
// memory, k-major: s[c][k][env], env = point_local * CB + e.  Envs past
// the point count or the env count load as zeros with zero weight.
template <int NC>
__device__ __forceinline__ void stage(const float* __restrict__ X,
                                      const float* __restrict__ re,
                                      int m, int B, int p0, int e0,
                                      float (*s)[DP][NE], float (*sre)[NE]) {
  const long long N = (long long)m * B;
  for (int idx = threadIdx.x; idx < NC * (DP / 4) * NE; idx += NT) {
    const int env = idx % NE;
    const int rest = idx / NE;
    const int k4 = rest % (DP / 4);
    const int c = rest / (DP / 4);
    const int p = p0 + env / CB;
    const int e = e0 + env % CB;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (p < m && e < B) {
      const long long n = (long long)p * B + e;
      v = *reinterpret_cast<const float4*>(X + (c * N + n) * DP + k4 * 4);
    }
    s[c][k4 * 4 + 0][env] = v.x;
    s[c][k4 * 4 + 1][env] = v.y;
    s[c][k4 * 4 + 2][env] = v.z;
    s[c][k4 * 4 + 3][env] = v.w;
  }
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
// MODE 1: upper-triangle tiles of a symmetric K_FF from the linear index.
// NS = 1: K into out; NS = 2 (dual): K into out and dK/dgamma into outd.
// KIND = RBF (gamma = 1 / (2 l^2)) or DOT (gamma unused).
// The K_FF instantiations ask for two resident blocks per SM, which caps
// them at 128 registers, and the K_EF ones for four (64 registers): left
// free, ptxas gave some K_FF ones 129-139 registers, the card then held
// one block per SM and they ran slower; a K_EF one given more than 64
// registers ran slower too (PERF.md).
template <int LC, int MODE, int NS, int KIND>
__global__ void __launch_bounds__(NT, LC == 4 ? 2 : 4)
cov_kernel(const float* __restrict__ X1, const float* __restrict__ re1,
           int m1, int B1, const float* __restrict__ X2,
           const float* __restrict__ re2, int m2, int B2,
           float* __restrict__ out, float* __restrict__ outd, long long ldo,
           float sigma2, float gamma, int zeta) {
  static_assert(KIND == RBF || NS == 1, "the Dot kernel has no dual pass");
  constexpr int NPL = LC == 4 ? 9 : 3;   // planes per coefficient set
  constexpr int NOUT = NPL * NS;
  __shared__ __align__(16) float s1[LC][DP][NE];
  __shared__ __align__(16) float s2[4][DP][NE];
  __shared__ float sre1[2][NE];
  __shared__ float sre2[2][NE];

  int I, J;
  if (MODE == 1) {
    const long long k = blockIdx.x;
    long long j = (long long)((sqrt(8.0 * (double)k + 1.0) - 1.0) * 0.5);
    while ((j + 1) * (j + 2) / 2 <= k) ++j;
    while (j * (j + 1) / 2 > k) --j;
    J = (int)j;
    I = (int)(k - j * (j + 1) / 2);
  } else {
    I = blockIdx.y;
    J = blockIdx.x;
  }

  const int t = threadIdx.x;
  const int bs = t & 1;
  const int as = (t >> 1) & 1;
  const int ql = (t >> 2) & (TP - 1);
  const int pl = t >> 5;
  const int a0 = pl * CB + as * 2;   // this thread's two lhs envs
  const int b0 = ql * CB + bs * 2;   // and two rhs envs

  float acc[NOUT];
#pragma unroll
  for (int i = 0; i < NOUT; ++i) acc[i] = 0.f;

  for (int ea = 0; ea < B1; ea += CB) {
    stage<LC>(X1, re1, m1, B1, I * TP, ea, s1, sre1);
    for (int eb = 0; eb < B2; eb += CB) {
      stage<4>(X2, re2, m2, B2, J * TP, eb, s2, sre2);
      __syncthreads();

      // g[ia][ib][c1 * 4 + c2] = X1[c1]_a . X2[c2]_b
      float g[2][2][LC * 4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int c = 0; c < LC * 4; ++c) g[i][j][c] = 0.f;

#pragma unroll 4
      for (int k = 0; k < DP; ++k) {
        float2 l[LC], r[4];
#pragma unroll
        for (int c = 0; c < LC; ++c)
          l[c] = *reinterpret_cast<const float2*>(&s1[c][k][a0]);
#pragma unroll
        for (int c = 0; c < 4; ++c)
          r[c] = *reinterpret_cast<const float2*>(&s2[c][k][b0]);
#pragma unroll
        for (int c1 = 0; c1 < LC; ++c1)
#pragma unroll
          for (int c2 = 0; c2 < 4; ++c2) {
            g[0][0][c1 * 4 + c2] = fmaf(l[c1].x, r[c2].x, g[0][0][c1 * 4 + c2]);
            g[0][1][c1 * 4 + c2] = fmaf(l[c1].x, r[c2].y, g[0][1][c1 * 4 + c2]);
            g[1][0][c1 * 4 + c2] = fmaf(l[c1].y, r[c2].x, g[1][0][c1 * 4 + c2]);
            g[1][1][c1 * 4 + c2] = fmaf(l[c1].y, r[c2].y, g[1][1][c1 * 4 + c2]);
          }
      }

#pragma unroll
      for (int ia = 0; ia < 2; ++ia)
#pragma unroll
        for (int ib = 0; ib < 2; ++ib) {
          const float same =
              sre1[1][a0 + ia] == sre2[1][b0 + ib] ? 1.f : 0.f;
          const float w = sre1[0][a0 + ia] * sre2[0][b0 + ib] * same;
          if (w == 0.f) continue;
          const float c = g[ia][ib][0];
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
#pragma unroll
            for (int u = 0; u < 3; ++u) {
              const float Bp1 = Bc * g[ia][ib][(1 + u) * 4];
#pragma unroll
              for (int v = 0; v < 3; ++v)
                acc[u * 3 + v] += A * g[ia][ib][(1 + u) * 4 + 1 + v] +
                                  Bp1 * g[ia][ib][1 + v];
            }
            if constexpr (NS == 2) {
              const float Dm1 = D - 1.f;
              const float kw = k * w;
              const float dA = A * Dm1 + kw * zd1;
              const float dB =
                  Bc * Dm1 + kw * (b0c + 2.f * zd1 * zd1 * gamma);
#pragma unroll
              for (int u = 0; u < 3; ++u) {
                const float dBp1 = dB * g[ia][ib][(1 + u) * 4];
#pragma unroll
                for (int v = 0; v < 3; ++v)
                  acc[9 + u * 3 + v] +=
                      dA * g[ia][ib][(1 + u) * 4 + 1 + v] +
                      dBp1 * g[ia][ib][1 + v];
              }
            }
          } else {
            const float A0 = -A;
#pragma unroll
            for (int v = 0; v < 3; ++v) acc[v] += A0 * g[ia][ib][1 + v];
            if constexpr (NS == 2) {
              const float dA0 = A0 * (D - 1.f) - k * w * zd1;
#pragma unroll
              for (int v = 0; v < 3; ++v)
                acc[3 + v] += dA0 * g[ia][ib][1 + v];
            }
          }
        }
      __syncthreads();
    }
  }

  // reduce the 2 x 2 micro-tiles of one point pair (lanes t^1, t^2)
#pragma unroll
  for (int i = 0; i < NOUT; ++i) {
    acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], 1);
    acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], 2);
  }
  if ((t & 3) != 0) return;
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

inline int tiles(int m) { return (m + TP - 1) / TP; }

}  // namespace

extern "C" {

// K3: out (3 m1, 3 m2) = K_FF of lhs force points against rhs force points.
int kff_rect(const float* X1, const float* re1, int m1, int B1,
             const float* X2, const float* re2, int m2, int B2, float* out,
             float sigma2, float gamma, int zeta, void* stream) {
  dim3 grid(tiles(m2), tiles(m1));
  cov_kernel<4, 0, 1, RBF><<<grid, NT, 0, (cudaStream_t)stream>>>(
      X1, re1, m1, B1, X2, re2, m2, B2, out, nullptr, 3LL * m2, sigma2,
      gamma, zeta);
  return (int)cudaGetLastError();
}

// K1: out (3 m, 3 m) = symmetric K_FF of one force-point set.
int kff_tri(const float* X, const float* re, int m, int B, float* out,
            float sigma2, float gamma, int zeta, void* stream) {
  const long long nt = tiles(m);
  cov_kernel<4, 1, 1, RBF><<<(unsigned)(nt * (nt + 1) / 2), NT, 0,
                         (cudaStream_t)stream>>>(
      X, re, m, B, X, re, m, B, out, nullptr, 3LL * m, sigma2, gamma, zeta);
  return (int)cudaGetLastError();
}

// K1-dual: out = K_FF and outd = dK_FF/dgamma, both (3 m, 3 m), exactly
// symmetric.
int kff_tri_dual(const float* X, const float* re, int m, int B, float* out,
                 float* outd, float sigma2, float gamma, int zeta,
                 void* stream) {
  const long long nt = tiles(m);
  cov_kernel<4, 1, 2, RBF><<<(unsigned)(nt * (nt + 1) / 2), NT, 0,
                         (cudaStream_t)stream>>>(
      X, re, m, B, X, re, m, B, out, outd, 3LL * m, sigma2, gamma, zeta);
  return (int)cudaGetLastError();
}

// K2: out (m1, 3 m2) = K_EF of energy points (U1 (N1, 32), w1 (2, N1)
// = [valid/count, element]) against force points.
int kef_rect(const float* U1, const float* w1, int m1, int A1,
             const float* X2, const float* re2, int m2, int B2, float* out,
             float sigma2, float gamma, int zeta, void* stream) {
  dim3 grid(tiles(m2), tiles(m1));
  cov_kernel<1, 0, 1, RBF><<<grid, NT, 0, (cudaStream_t)stream>>>(
      U1, w1, m1, A1, X2, re2, m2, B2, out, nullptr, 3LL * m2, sigma2,
      gamma, zeta);
  return (int)cudaGetLastError();
}

// K2-dual: out = K_EF and outd = dK_EF/dgamma, both (m1, 3 m2).
int kef_rect_dual(const float* U1, const float* w1, int m1, int A1,
                  const float* X2, const float* re2, int m2, int B2,
                  float* out, float* outd, float sigma2, float gamma,
                  int zeta, void* stream) {
  dim3 grid(tiles(m2), tiles(m1));
  cov_kernel<1, 0, 2, RBF><<<grid, NT, 0, (cudaStream_t)stream>>>(
      U1, w1, m1, A1, X2, re2, m2, B2, out, outd, 3LL * m2, sigma2, gamma,
      zeta);
  return (int)cudaGetLastError();
}

// K3-dot: out (3 m1, 3 m2) = Dot K_FF of lhs against rhs force points.
int kff_rect_dot(const float* X1, const float* re1, int m1, int B1,
                 const float* X2, const float* re2, int m2, int B2,
                 float* out, float sigma2, int zeta, void* stream) {
  dim3 grid(tiles(m2), tiles(m1));
  cov_kernel<4, 0, 1, DOT><<<grid, NT, 0, (cudaStream_t)stream>>>(
      X1, re1, m1, B1, X2, re2, m2, B2, out, nullptr, 3LL * m2, sigma2, 0.f,
      zeta);
  return (int)cudaGetLastError();
}

// K1-dot: out (3 m, 3 m) = symmetric Dot K_FF of one force-point set.
int kff_tri_dot(const float* X, const float* re, int m, int B, float* out,
                float sigma2, int zeta, void* stream) {
  const long long nt = tiles(m);
  cov_kernel<4, 1, 1, DOT><<<(unsigned)(nt * (nt + 1) / 2), NT, 0,
                             (cudaStream_t)stream>>>(
      X, re, m, B, X, re, m, B, out, nullptr, 3LL * m, sigma2, 0.f, zeta);
  return (int)cudaGetLastError();
}

// K2-dot: out (m1, 3 m2) = Dot K_EF of energy points against force points.
int kef_rect_dot(const float* U1, const float* w1, int m1, int A1,
                 const float* X2, const float* re2, int m2, int B2,
                 float* out, float sigma2, int zeta, void* stream) {
  dim3 grid(tiles(m2), tiles(m1));
  cov_kernel<1, 0, 1, DOT><<<grid, NT, 0, (cudaStream_t)stream>>>(
      U1, w1, m1, A1, X2, re2, m2, B2, out, nullptr, 3LL * m2, sigma2, 0.f,
      zeta);
  return (int)cudaGetLastError();
}

}  // extern "C"
