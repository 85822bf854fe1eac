// K1 (kff_tri*_<mode>_ks) in the bf16 modes for operands wider than one
// k-slice of DP = 32, on tri_mma_ks_kernel<SEL, KIND, PREC>: the kernel
// tri_mma_kernel (kff_tri_mma.cu) is for one slice, and ops/kff.py
// launches these entry points for operands of width dp > DP.  Plain C
// interface, loaded with ctypes by ops/kff.py, which builds every source
// of this directory into one library; kff_common.cuh has the operands and
// the per-env-pair arithmetic, kff_mma.cuh and kff_mma_ks.cuh the
// tensor-core path.
//
// It replaces _kff_kernel_tri (kff_pallas.py:282, body _kff_body :209) at
// mm_precision "bf16x4" and "bf16" and widths above 32, and in its
// tile-range form the cells= / owned= form (kff_pallas.py:592-596,
// :703-711).  The design is tri_mma_kernel's -- the upper-triangle tiles
// with their transposes, the element skip, the TMA ring, the 2 x 2 env
// micro-tile of one point pair a thread, the order of the sums -- with the
// ring over (chunk pair, k-slice), the box offset along k, and the
// products of the four lhs component rows kept in registers from a pair's
// first slice to its last (64 of them, 153-199 registers: one block an
// SM), then tri_mma_kernel's coefficients and fold, in its order.  A
// translation unit of its own (kff_rect_ks.cu says why).

#include "kff_mma_ks.cuh"

namespace {

// The geometry: rect_mma_kernel's K3 (LC = 4), staged by the TMA.
template <int PREC>
using Tri = Mma<4, PREC, true>;

// K1 in the bf16 modes for operands of width dp: tri_mma_kernel's tiles,
// skip and TMA ring (kff_tri_mma.cu), the ring over (chunk pair,
// k-slice), the box offset along k, the products of the four lhs component
// rows kept in registers from a pair's first slice to its last (64 of
// them), then tri_mma_kernel's coefficients and fold, in its order.  One
// block an SM.
template <int SEL, int KIND, int PREC>
__global__ void __launch_bounds__(NT, 1)
tri_mma_ks_kernel(const __grid_constant__ CUtensorMap map,
                  const float* __restrict__ re, int m, int B,
                  float* __restrict__ out, float* __restrict__ outd,
                  long long ldo, float sigma2, float gamma, int zeta,
                  long long k0, int dp) {
  static_assert(KIND == RBF || SEL == KONLY,
                "the Dot kernel has no dK/dgamma pass");
  using M = Tri<PREC>;
  constexpr int NP = M::NP, NE1 = M::NE1, S = M::STAGES;
  constexpr int NPL = 9;                 // planes per coefficient set
  constexpr int NS = SEL == DUAL ? 2 : 1;
  constexpr int NOUT = NPL * NS;
  static_assert(NE1 == NE && M::TP1 == TP && M::PL1 == M::PL2,
                "both roles stage the same box");
  extern __shared__ __align__(16) unsigned char tri_mma_raw[];
  // the first points of the tile's two sides, I TP and J TP: read from
  // here where they are needed, not held in registers through the loop
  __shared__ int tile0[2];
  // the ring at a 1024-byte boundary (the swizzled destinations), its
  // full barriers, then the chunk ranges
  unsigned char* const ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(tri_mma_raw) + 1023) & ~(uintptr_t)1023);
  uint64_t* const full = reinterpret_cast<uint64_t*>(ring + S * M::STAGE);

  int I, J;
  tri_tile(k0 + blockIdx.x, I, J);
  const int nc = (B + CB - 1) / CB;
  // a diagonal tile: both roles are one tile, whose chunk ranges are read
  // once
  const bool one_tile = I == J;
  float* const rng1 = reinterpret_cast<float*>(ring + M::RING);
  float* const rng2 = one_tile ? rng1 : rng1 + 2 * nc;

  // this warp's lhs group (4 points x CB envs) and n-tile (2 points x CB
  // envs); this thread's lhs envs 2g, 2g + 1 of the group (fragment rows
  // g, g + 8) and rhs envs 2 q4, 2 q4 + 1 of the n-tile: one point pair's
  // 2 x 2 micro-tile, whose other three threads are the lanes xor 1, xor 4
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int g = lane >> 2, q4 = lane & 3;
  const int grp = warp >> 2, nt = warp & 3;
  const Frag<true> frag(lane);

  for (int ch = warp; ch < (one_tile ? nc : 2 * nc); ch += NT / 32) {
    if (ch < nc)
      chunk_range<NE, CB>(re, m, B, I * TP, ch, rng1);
    else
      chunk_range<NE, CB>(re, m, B, J * TP, ch - nc, rng2);
  }
  if (t == 0) {
    tile0[0] = I * TP;
    tile0[1] = J * TP;
    for (int k = 0; k < S; ++k) mbar_init(&full[k], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the next (chunk pair, k-slice) after (a, b, ks): the pair's next
  // slice, or the first slice of the next pair in nested order whose
  // element ranges intersect
  const int ns = dp / DP;
  auto next = [&](int& a, int& b, int& ks) -> bool {
    if (++ks < ns) return true;
    ks = 0;
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
  // the producer's cursor, the (pair, slice) items issued, and how many of
  // them took lhs chunk pa: the stage the next item takes, last filled S
  // items ago, still holds chunk pa's slice when at least S did (pa never
  // decreases) and S is a multiple of the slice count.  Thread 0 copies
  // the rows with the TMA (the stage's full barrier counts their bytes);
  // every thread copies the weights and elements with cp.async (one group
  // an item)
  int pa = 0, pb = -1, pks = ns - 1, issued = 0, run = 0;
  bool more = next(pa, pb, pks);
  auto issue = [&]() {
    const int s = issued % S;
    uint16_t* const s1 = reinterpret_cast<uint16_t*>(ring + s * M::STAGE);
    uint16_t* const s2 = s1 + M::S1;
    float* const sre = reinterpret_cast<float*>(s2 + M::S2);
    const bool lhs = run < S || S % ns != 0;
    const int i0 = tile0[0], j0 = tile0[1];
    if (t == 0) {
      // the stage was last read by the generic proxy (ldmatrix) before
      // the block barrier this follows
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_expect_tx(&full[s], 2 * (M::S2 + (lhs ? M::S1 : 0)));
      const int k0 = pks * DP;
      if (lhs) tma_load4(s1, &map, &full[s], k0, pa * CB, i0);
      tma_load4(s2, &map, &full[s], k0, pb * CB, j0);
    }
    if (lhs) stage_re_async<NE, CB>(re, m, B, i0, pa * CB, sre);
    stage_re_async<NE, CB>(re, m, B, j0, pb * CB, sre + 2 * NE);
    ++issued;
    ++run;
    const int a = pa;
    more = next(pa, pb, pks);
    if (pa != a) run = 0;
  };

  float acc[NOUT];
#pragma unroll
  for (int i = 0; i < NOUT; ++i) acc[i] = 0.f;
  // the products of the four lhs component rows of a chunk pair, summed
  // over its slices
  float Gm[4][4][4];

  // S - 1 pairs in flight ahead of the one multiplied; one group of copies
  // committed a pair (empty past the last), one block barrier a pair: the
  // stage refilled after it is the one every warp finished before it
#pragma unroll
  for (int k = 0; k + 1 < S; ++k) {
    if (more) issue();
    cp_async_commit();
  }
  for (int it = 0; it < issued; ++it) {
    cp_async_wait<S - 2>();
    __syncthreads();
    if (more) issue();
    cp_async_commit();
    mbar_wait(&full[it % S], (it / S) & 1);

    const uint16_t* const s1 =
        reinterpret_cast<const uint16_t*>(ring + (it % S) * M::STAGE);
    const uint16_t* const s2 = s1 + M::S1;
    const float* const sw1 = reinterpret_cast<const float*>(s2 + M::S2);
    const float* const se1 = sw1 + NE;   // lhs elements
    const float* const sw2 = se1 + NE;   // rhs weights
    const float* const se2 = sw2 + NE;
    // the pair weight of env e = ia * 2 + ib of this thread's micro-tile,
    // and whether the warp has any pair to add
    float wv[4];
    bool any = false;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int ia = grp * 16 + 2 * g + (e >> 1);
      const int ib = nt * 8 + 2 * q4 + (e & 1);
      const float same = se1[ia] == se2[ib] ? 1.f : 0.f;
      wv[e] = sw1[ia] * sw2[ib] * same;
      any = any || wv[e] != 0.f;
    }
    if (!__any_sync(0xffffffffu, any)) continue;

    // the products of slice it % ns added into Gm (zeroed at a pair's
    // first slice), then after its last the coefficients and the fold
    // of the one-slice body below, in its order
    const int ks = it % ns;
#pragma unroll
    for (int c1 = 0; c1 < 4; ++c1) {
      if (ks == 0) {
#pragma unroll
        for (int c2 = 0; c2 < 4; ++c2)
#pragma unroll
          for (int e = 0; e < 4; ++e) Gm[c1][c2][e] = 0.f;
      }
      products_acc<4, NP, NE1, M::ROW, true>(s1, s2, c1, grp, nt, frag,
                                             Gm[c1]);
    }
    if (ks != ns - 1) continue;
    float cA[NS][4], cB[NS][4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float w = wv[e];
      float k, A, Bc, D, zd1, b0c;
      pair_coeffs<KIND>(Gm[0][0][e], w, sigma2, gamma, zeta, k, A, Bc, D,
                        zd1, b0c);
      if constexpr (SEL != DERIV) {
        cA[0][e] = A;
        cB[0][e] = Bc;
      }
      if constexpr (SEL != KONLY) {
        const float Dm1 = D - 1.f;
        const float kw = k * w;
        cA[NS - 1][e] = A * Dm1 + kw * zd1;
        cB[NS - 1][e] = Bc * Dm1 + kw * (b0c + 2.f * zd1 * zd1 * gamma);
      }
    }
#pragma unroll
    for (int u = 0; u < 3; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int s = 0; s < NS; ++s) {
          const float Bp1 = cB[s][e] * Gm[1 + u][0][e];
#pragma unroll
          for (int v = 0; v < 3; ++v)
            acc[s * NPL + u * 3 + v] +=
                cA[s][e] * Gm[1 + u][1 + v][e] + Bp1 * Gm[0][1 + v][e];
        }
  }

  // reduce the 2 x 2 micro-tiles of each point pair (lanes xor 1, xor 4)
#pragma unroll
  for (int i = 0; i < NOUT; ++i) {
    acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], 1);
    acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], 4);
  }
  if ((lane & 5) != 0) return;
  const int pl = 4 * grp + (g >> 1);
  const int ql = 2 * nt + (q4 >> 1);
  const int p = tile0[0] + pl;
  const int q = tile0[1] + ql;
  if (p >= m || q >= m) return;
#pragma unroll
  for (int sset = 0; sset < NS; ++sset) {
    float* __restrict__ o = sset == 0 ? out : outd;
    const int a = sset * NPL;   // this set's first accumulator
    if (tile0[0] < tile0[1] || pl < ql) {
#pragma unroll
      for (int u = 0; u < 3; ++u)
#pragma unroll
        for (int v = 0; v < 3; ++v)
          o[(long long)(3 * p + u) * ldo + 3 * q + v] = acc[a + u * 3 + v];
#pragma unroll
      for (int u = 0; u < 3; ++u)
#pragma unroll
        for (int v = 0; v < 3; ++v)
          o[(long long)(3 * q + v) * ldo + 3 * p + u] = acc[a + u * 3 + v];
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

template <int SEL, int KIND, int PREC>
cudaError_t init_tri_mma_ks() {
  return smem_init(tri_mma_ks_kernel<SEL, KIND, PREC>,
                   (size_t)Tri<PREC>::ALIGN + Tri<PREC>::RING + kRangeBytes);
}

// Tiles [k0, k0 + nk) of the upper triangle of one operand of width dp,
// with the ring, its barriers and the chunk ranges of both roles in
// dynamic shared memory: X2, re2, m2, B2 must repeat X1, re1, m1, B1 (X1
// 16-byte aligned), and the range must lie inside the triangle; trans is
// refused.  Returns the launch status.
template <int SEL, int KIND, int PREC>
int launch_tri_ks(const void* X1, const float* re1, int m1, int B1,
                  const void* X2, const float* re2, int m2, int B2,
                  float* out, float* outd, float sigma2, float gamma,
                  int zeta, long long k0, long long nk, long long ldo,
                  int trans, int dp, void* stream) {
  using M = Tri<PREC>;
  const int nc = (B1 + CB - 1) / CB;
  const size_t ranges = sizeof(float) * 4 * (size_t)nc;
  const long long nt = tiles(m1);
  if (trans || ldo < 3LL * m1 || X2 != X1 || re2 != re1 || m2 != m1 ||
      B2 != B1 || !slices(dp) || ranges > kRangeBytes ||
      ((uintptr_t)X1 & 15) || k0 < 0 || nk < 1 || nk > 0x7fffffffLL ||
      k0 + nk > nt * (nt + 1) / 2)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  if (mma_map(X1, m1, B1, dp, M::PL1, TP, &map) != 0)
    return (int)cudaErrorInvalidValue;
  tri_mma_ks_kernel<SEL, KIND, PREC>
      <<<dim3((unsigned)nk), NT, (size_t)M::ALIGN + M::RING + ranges,
         (cudaStream_t)stream>>>(map, re1, m1, B1, out, outd, ldo, sigma2,
                                 gamma, zeta, k0, dp);
  return (int)cudaGetLastError();
}

}  // namespace

cudaError_t kff::tri_mma_ks_init() {
  const cudaError_t rcs[] = {init_tri_mma_ks<KONLY, RBF, BF16X4>(),
                             init_tri_mma_ks<DUAL, RBF, BF16X4>(),
                             init_tri_mma_ks<DERIV, RBF, BF16X4>(),
                             init_tri_mma_ks<KONLY, DOT, BF16X4>(),
                             init_tri_mma_ks<KONLY, RBF, BF16>(),
                             init_tri_mma_ks<DUAL, RBF, BF16>(),
                             init_tri_mma_ks<DERIV, RBF, BF16>(),
                             init_tri_mma_ks<KONLY, DOT, BF16>()};
  for (cudaError_t rc : rcs)
    if (rc != cudaSuccess) return rc;
  return cudaSuccess;
}

// Entry points <name>_ks: the arguments of every entry point of the
// library (kff_common.cuh) and then the operands' width dp before the
// stream, X1 = X2 the bf16 parts of the mode: tiles [k0, k0 + nk) of the
// upper triangle and their transposes written, nothing else.
#define TRI_MMA_KS_ENTRY(NAME, SEL, KIND, PREC)                             \
  int NAME##_ks(const void* X1, const float* re1, int m1, int B1,           \
                const void* X2, const float* re2, int m2, int B2,           \
                float* out, float* outd, float sigma2, float gamma,         \
                int zeta, long long k0, long long nk, long long ldo,        \
                int trans, int dp, void* stream) {                          \
    return launch_tri_ks<SEL, KIND, PREC>(X1, re1, m1, B1, X2, re2, m2, B2, \
                                          out, outd, sigma2, gamma, zeta,   \
                                          k0, nk, ldo, trans, dp, stream);  \
  }

#define TRI_MMA_KS_FAMILY(SUFFIX, PREC)                      \
  TRI_MMA_KS_ENTRY(kff_tri##SUFFIX, KONLY, RBF, PREC)        \
  TRI_MMA_KS_ENTRY(kff_tri_dual##SUFFIX, DUAL, RBF, PREC)    \
  TRI_MMA_KS_ENTRY(kff_tri_deriv##SUFFIX, DERIV, RBF, PREC)  \
  TRI_MMA_KS_ENTRY(kff_tri_dot##SUFFIX, KONLY, DOT, PREC)

extern "C" {
TRI_MMA_KS_FAMILY(_bf16x4, BF16X4)
TRI_MMA_KS_FAMILY(_bf16, BF16)
}  // extern "C"
