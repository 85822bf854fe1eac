// K3 (kff_rect*, LC = 4) and K2 (kef_rect*, LC = 1) in highest: the
// rectangular fp32 covariance blocks of every served request on
// rect_kernel<LC, SEL, KIND>.  Plain C interface, loaded with ctypes by
// ops/kff.py, which builds every source of this directory into one library;
// kff_common.cuh has the operands and the per-env-pair arithmetic.
//
// They replace _kff_kernel (kff_pallas.py:269, K3) and _kef_kernel
// (kff_pallas.py:748, K2) in the exact mode.  What bounds them on this
// card: the fp32 FMA rate of the env-pair dot products (operations; the
// operands stay in L2), and at the few-point shapes of one served request
// the length of one block's serial chain of chunk pairs.  What the design
// does about it:
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
//  * Staging overlaps the arithmetic: cp.async copies the next chunk pair
//    into the second stage of a ring in dynamic shared memory while the
//    block multiplies the current one.  The copies are 4 bytes wide and
//    transpose on the way (8 consecutive k of 4 consecutive envs per warp
//    instruction: whole 32-byte sectors from global, conflict-free k-major
//    rows of stride NE + 4 in shared memory), so the inner loop reads the
//    k-major layout it needs, one k a step; a lhs chunk already held by a
//    stage is not copied again.  (16-byte copies of env-major rows with a
//    float4 k-vector inner loop were measured slower, 14.2 against 12.2 ms
//    for K3 at 750 x 750 points of 32 envs on an NVIDIA H100 80GB HBM3,
//    700.00 W, and spilled.)
//  * K2 is no longer bound by shared-memory loads: a thread owns 4 lhs
//    envs x 2 rhs envs x 4 components (32 accumulators, 1 float4 + 4
//    float2 loads for 32 FMAs per k, against 5 float2 loads for 16
//    before), with 8-env lhs chunks of 8 energy points.  K3 keeps the
//    2 x 2 env micro-tile of 16 dot products and 4-env chunks.  All tiles
//    are 8 points x 8 points, one warp a lhs point.
//  * The output goes to out + row * ldo (the caller's buffer, any leading
//    dimension), and K2 can store transposed (K_FE of a served block).
// Every output element is written once by one thread; a point pair's sum
// is taken in an order that depends on its own envs alone (chunk pairs in
// nested order, then the lanes of the pair by shuffles), never on the
// grid, so stripes of a block cut at whole 8-point tiles equal the single
// launch bit for bit.  K1's highest kernel (kff_tri.cu) runs the same
// per-chunk-pair arithmetic with its own copy of it: shared as one
// function, it made the compiler emit slower code for K1 (111.8 against
// 88.8 ms at the 10k bench shape, NVIDIA H100 80GB HBM3, 700.00 W;
// PERF.md).

#include "kff_common.cuh"

namespace {

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

// LC = 4: K_FF (kff_rect*), LC = 1: K_EF (kef_rect*); SEL and KIND as in
// every kernel (kff_common.cuh).  blockIdx.y = lhs tile, blockIdx.x = rhs
// tile.  out (and outd for DUAL) have leading dimension ldo; trans (K_EF
// only) stores
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

template <int LC>
constexpr size_t rect_ring_bytes() {
  return sizeof(float) * 2 * (size_t)Rect<LC>::STAGE;
}

template <int LC, int SEL, int KIND>
cudaError_t rect_init() {
  return smem_init(rect_kernel<LC, SEL, KIND>,
                   rect_ring_bytes<LC>() + kRangeBytes);
}

// Every (lhs tile, rhs tile), with the two-stage ring and the chunk
// ranges in dynamic shared memory.  Returns the launch status.
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

}  // namespace

cudaError_t kff::rect_highest_init() {
  const cudaError_t rcs[] = {
      rect_init<1, KONLY, RBF>(), rect_init<1, DUAL, RBF>(),
      rect_init<1, DERIV, RBF>(), rect_init<1, KONLY, DOT>(),
      rect_init<4, KONLY, RBF>(), rect_init<4, DUAL, RBF>(),
      rect_init<4, DERIV, RBF>(), rect_init<4, KONLY, DOT>()};
  for (cudaError_t rc : rcs)
    if (rc != cudaSuccess) return rc;
  return cudaSuccess;
}

// Entry points: (X1, re1, m1, B1, X2, re2, m2, B2, out, outd, sigma2,
// gamma, zeta, k0, nk, ldo, trans, stream), as every entry point of the
// library (kff_common.cuh); k0 and nk are unused.  K_FF: out (3 m1, 3 m2);
// K_EF: out (m1, 3 m2) from energy operands, or with trans != 0 K_EF
// transposed, out (3 m2, m1) with ldo at least m1.
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

extern "C" {
RECT_ENTRY(kef_rect, 1, KONLY, RBF)
RECT_ENTRY(kef_rect_dual, 1, DUAL, RBF)
RECT_ENTRY(kef_rect_deriv, 1, DERIV, RBF)
RECT_ENTRY(kef_rect_dot, 1, KONLY, DOT)
RECT_ENTRY(kff_rect, 4, KONLY, RBF)
RECT_ENTRY(kff_rect_dual, 4, DUAL, RBF)
RECT_ENTRY(kff_rect_deriv, 4, DERIV, RBF)
RECT_ENTRY(kff_rect_dot, 4, KONLY, DOT)

// The shared-memory limits of the ring kernels of every source (K1-K3 in
// highest, in the modes and in float64) on the current device: the library's loader
// calls it once for each device before the first launch there.  Returns
// the first CUDA error.
int kff_rect_init() {
  const cudaError_t rcs[] = {kff::rect_highest_init(),
                             kff::tri_highest_init(), kff::rect_mma_init(),
                             kff::tri_mma_init(), kff::f64_init()};
  for (cudaError_t rc : rcs)
    if (rc != cudaSuccess) return (int)rc;
  return 0;
}
}  // extern "C"
