// K3 (kff_rect*_<mode>_ks, LC = 4) and K2 (kef_rect*_<mode>_ks, LC = 1) in
// the bf16 modes for operands wider than one k-slice of DP = 32, on
// rect_mma_ks_kernel<LC, SEL, KIND, PREC>: the kernel rect_mma_kernel
// (kff_rect_mma.cu) is for one slice, and ops/kff.py launches these entry
// points for operands of width dp > DP.  Plain C interface, loaded with
// ctypes by ops/kff.py, which builds every source of this directory into
// one library; kff_common.cuh has the operands and the per-env-pair
// arithmetic, kff_mma.cuh and kff_mma_ks.cuh the tensor-core path.
//
// They replace _kff_kernel (kff_pallas.py:269, K3) and _kef_kernel
// (kff_pallas.py:748, K2) at mm_precision "bf16x4" and "bf16" and widths
// above 32.  The design is rect_mma_kernel's -- the element skip per
// chunk pair and per 16 x 8 env sub-tile, the ring (the TMA in bf16x4,
// cp.async in bf16), ldmatrix fragments, the 2 x 2 env micro-tile of one
// point pair a thread, the order of the sums -- with the ring over (chunk
// pair, k-slice): a stage holds one slice of both chunks (the TMA box or
// the cp.async copies offset along k), the products of every lhs
// component row (K3) or every group (K2) stay in registers from a pair's
// first slice to its last (64 of them), then the coefficients and the
// fold of rect_mma_kernel follow, in its order.  64 live products take
// 173-213 registers: one block an SM.  A translation unit of its own,
// beside the one-slice kernel's (kff_rect_ks.cu says why).

#include "kff_mma_ks.cuh"

namespace {

// K2 (LC = 1) and K3 (LC = 4) in the bf16 modes for operands of width dp:
// rect_mma_kernel's tiles, skip and ring (kff_rect_mma.cu), the ring over
// (chunk pair, k-slice) -- the TMA box or the cp.async copies offset along
// k --, the products of every lhs component row (K3) or every group (K2)
// kept in registers from a pair's first slice to its last (64 of them),
// then the coefficients and the fold of rect_mma_kernel, in its order.
// One block an SM (up to 255 registers a thread).
template <int LC, int SEL, int KIND, int PREC>
__global__ void __launch_bounds__(NT, 1)
rect_mma_ks_kernel(const __grid_constant__ CUtensorMap map1,
                   const __grid_constant__ CUtensorMap map2,
                   const uint16_t* __restrict__ X1,
                   const float* __restrict__ re1, int m1, int B1,
                   const uint16_t* __restrict__ X2,
                   const float* __restrict__ re2, int m2, int B2,
                   float* __restrict__ out, float* __restrict__ outd,
                   long long ldo, int trans, float sigma2, float gamma,
                   int zeta, int dp) {
  static_assert(KIND == RBF || SEL == KONLY,
                "the Dot kernel has no dK/dgamma pass");
  using M = Mma<LC, PREC>;
  constexpr int NP = M::NP, NE1 = M::NE1, WN = M::WN, S = M::STAGES;
  constexpr int NPL = LC == 4 ? 9 : 3;   // planes per coefficient set
  constexpr int NS = SEL == DUAL ? 2 : 1;
  constexpr int NOUT = NPL * NS;
  constexpr int DSET = SEL == DUAL ? NPL : 0;   // first dK/dgamma plane
  extern __shared__ __align__(16) unsigned char mma_raw[];
  // the ring (with the TMA at a 1024-byte boundary: the swizzled
  // destinations), its full barriers, then the chunk ranges
  unsigned char* const ring =
      M::TMA ? reinterpret_cast<unsigned char*>(
                   (reinterpret_cast<uintptr_t>(mma_raw) + 1023) &
                   ~(uintptr_t)1023)
             : mma_raw;
  uint64_t* const full =
      reinterpret_cast<uint64_t*>(ring + M::STAGES * M::STAGE);

  const int I = blockIdx.y, J = blockIdx.x;
  const int nca = (B1 + CB - 1) / CB;
  const int ncb = (B2 + CB - 1) / CB;
  float* const rng1 = reinterpret_cast<float*>(ring + M::RING);
  float* const rng2 = rng1 + 2 * nca;

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int g = lane >> 2, q4 = lane & 3;
  // this warp's n-tile and the lhs group of its j-th product (K3: one,
  // group warp / 4; K2: groups warp / 4, + 2, + 4, + 6, so that the first
  // groups of a tile, all a few-point request has, spread over the warps);
  // this thread's lhs envs 2g, 2g + 1 of the group (fragment rows g, g + 8)
  // and rhs envs 2 q4, 2 q4 + 1 of the n-tile; the other three threads of
  // its point pairs are the lanes xor 1, xor 4
  const int nt = warp & 3;
  auto group = [&](int j) { return 2 * j + (warp >> 2); };
  const Frag<M::TMA> frag(lane);

  for (int ch = warp; ch < nca + ncb; ch += NT / 32) {
    if (ch < nca)
      chunk_range<NE1, CB>(re1, m1, B1, I * M::TP1, ch, rng1);
    else
      chunk_range<NE, CB>(re2, m2, B2, J * TP, ch - nca, rng2);
  }
  if (M::TMA && t == 0) {
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
      if (++b >= ncb) {
        b = 0;
        ++a;
      }
      if (a >= nca) return false;
      if (!(rng1[2 * a + 1] < rng2[2 * b] || rng2[2 * b + 1] < rng1[2 * a]))
        return true;
    }
  };
  // the producer's cursor, the (pair, slice) items issued, and the lhs
  // chunk slices (a ns + ks) of the last S items issued (held[0]: the one
  // whose stage the next item takes).  With the TMA thread 0 copies the
  // rows (the stage's full barrier counts their bytes), else every thread
  // does with cp.async; every thread copies the weights and elements with
  // cp.async (one group an item)
  int pa = 0, pb = -1, pks = ns - 1, issued = 0;
  bool more = next(pa, pb, pks);
  int held[S];
#pragma unroll
  for (int k = 0; k < S; ++k) held[k] = -1;
  auto issue = [&]() {
    const int s = issued % S;
    unsigned char* const st = ring + s * M::STAGE;
    uint16_t* const s1 = reinterpret_cast<uint16_t*>(st);
    uint16_t* const s2 = s1 + M::S1;
    float* const sre = reinterpret_cast<float*>(s2 + M::S2);
    const int k0 = pks * DP;
    const bool lhs = held[0] != pa * ns + pks;
    if constexpr (M::TMA) {
      if (t == 0) {
        // the stage was last read by the generic proxy (ldmatrix) before
        // the block barrier this follows
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_expect_tx(&full[s], 2 * (M::S2 + (lhs ? M::S1 : 0)));
        if (lhs)
          tma_load4(s1, &map1, &full[s], k0, pa * CB, I * M::TP1);
        tma_load4(s2, &map2, &full[s], k0, pb * CB, J * TP);
      }
    } else {
      if (lhs)
        stage_rows<LC, NP, NE1, true>(X1, m1, B1, dp, k0, I * M::TP1,
                                      pa * CB, s1);
      stage_rows<4, NP, NE, false>(X2, m2, B2, dp, k0, J * TP,
                                   pb * CB, s2);
    }
    if (lhs) stage_re_async<NE1, CB>(re1, m1, B1, I * M::TP1, pa * CB, sre);
    stage_re_async<NE, CB>(re2, m2, B2, J * TP, pb * CB, sre + 2 * NE1);
#pragma unroll
    for (int k = 0; k + 1 < S; ++k) held[k] = held[k + 1];
    held[S - 1] = pa * ns + pks;
    ++issued;
    more = next(pa, pb, pks);
  };

  float acc[WN][NOUT];
#pragma unroll
  for (int j = 0; j < WN; ++j)
#pragma unroll
    for (int i = 0; i < NOUT; ++i) acc[j][i] = 0.f;
  // the products of a chunk pair summed over its slices, by lhs component
  // row (K3) or by product (K2)
  float Gm[LC == 4 ? 4 : WN][4][4];

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
    if constexpr (M::TMA) mbar_wait(&full[it % S], (it / S) & 1);

    const uint16_t* const s1 =
        reinterpret_cast<const uint16_t*>(ring + (it % S) * M::STAGE);
    const uint16_t* const s2 = s1 + M::S1;
    const float* const sw1 = reinterpret_cast<const float*>(s2 + M::S2);
    const float* const se1 = sw1 + NE1;   // lhs elements
    const float* const sw2 = se1 + NE1;   // rhs weights
    const float* const se2 = sw2 + NE;
    // the pair weight of env e = ia * 2 + ib of this thread's 2 x 2 env
    // micro-tile in the j-th product, and the products in which the warp
    // has any pair to add (bit j)
    auto weight = [&](int j, int e) -> float {
      const int ia = group(j) * 16 + 2 * g + (e >> 1);
      const int ib = nt * 8 + 2 * q4 + (e & 1);
      const float same = se1[ia] == se2[ib] ? 1.f : 0.f;
      return sw1[ia] * sw2[ib] * same;
    };
    unsigned todo = 0;
#pragma unroll
    for (int j = 0; j < WN; ++j) {
      bool any = false;
#pragma unroll
      for (int e = 0; e < 4; ++e) any = any || weight(j, e) != 0.f;
      if (__any_sync(0xffffffffu, any)) todo |= 1u << j;
    }

    // the products of slice ks added into Gm (zeroed at a pair's first
    // slice), then after its last the coefficients and the fold of the
    // one-slice kernel's body, in its order
    const int ks = it % ns;
    if constexpr (LC == 4) {
      if (!todo) continue;
#pragma unroll
      for (int c1 = 0; c1 < 4; ++c1) {
        if (ks == 0) {
#pragma unroll
          for (int c2 = 0; c2 < 4; ++c2)
#pragma unroll
            for (int e = 0; e < 4; ++e) Gm[c1][c2][e] = 0.f;
        }
        products_acc<LC, NP, NE1, M::ROW, M::TMA>(s1, s2, c1, group(0), nt,
                                                  frag, Gm[c1]);
      }
      if (ks != ns - 1) continue;
      float wv[4], cA[NS][4], cB[NS][4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        wv[e] = weight(0, e);
#pragma unroll
        for (int s = 0; s < NS; ++s) cA[s][e] = cB[s][e] = 0.f;
        const float w = wv[e];
        if (w == 0.f) continue;
        float k, A, Bc, D, zd1, b0c;
        pair_coeffs<KIND>(Gm[0][0][e], w, sigma2, gamma, zeta, k, A, Bc,
                          D, zd1, b0c);
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
        for (int e = 0; e < 4; ++e) {
          if (wv[e] == 0.f) continue;
#pragma unroll
          for (int s = 0; s < NS; ++s) {
            const float Bp1 = cB[s][e] * Gm[1 + u][0][e];
#pragma unroll
            for (int v = 0; v < 3; ++v)
              acc[0][s * NPL + u * 3 + v] +=
                  cA[s][e] * Gm[1 + u][1 + v][e] + Bp1 * Gm[0][1 + v][e];
          }
        }
    } else {
#pragma unroll
      for (int j = 0; j < WN; ++j) {
        if (!(todo >> j & 1u)) continue;
        if (ks == 0) {
#pragma unroll
          for (int c2 = 0; c2 < 4; ++c2)
#pragma unroll
            for (int e = 0; e < 4; ++e) Gm[j][c2][e] = 0.f;
        }
        products_acc<LC, NP, NE1, M::ROW, M::TMA>(s1, s2, 0, group(j), nt,
                                                  frag, Gm[j]);
      }
      if (ks != ns - 1) continue;
#pragma unroll
      for (int j = 0; j < WN; ++j) {
        if (!(todo >> j & 1u)) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float w = weight(j, e);
          if (w == 0.f) continue;
          float k, A, Bc, D, zd1, b0c;
          pair_coeffs<KIND>(Gm[j][0][e], w, sigma2, gamma, zeta, k, A, Bc,
                            D, zd1, b0c);
          const float A0 = -A;
          if constexpr (SEL != DERIV) {
#pragma unroll
            for (int v = 0; v < 3; ++v) acc[j][v] += A0 * Gm[j][1 + v][e];
          }
          if constexpr (SEL != KONLY) {
            const float dA0 = A0 * (D - 1.f) - k * w * zd1;
#pragma unroll
            for (int v = 0; v < 3; ++v)
              acc[j][DSET + v] += dA0 * Gm[j][1 + v][e];
          }
        }
      }
    }
  }

  // reduce the 2 x 2 micro-tiles of each point pair (lanes xor 1, xor 4)
#pragma unroll
  for (int j = 0; j < WN; ++j)
#pragma unroll
    for (int i = 0; i < NOUT; ++i) {
      acc[j][i] += __shfl_xor_sync(0xffffffffu, acc[j][i], 1);
      acc[j][i] += __shfl_xor_sync(0xffffffffu, acc[j][i], 4);
    }
  if ((lane & 5) != 0) return;
  const int q = J * TP + 2 * nt + (q4 >> 1);
  if (q >= m2) return;
#pragma unroll
  for (int j = 0; j < WN; ++j) {
    const int p = I * M::TP1 + group(j) * 4 + (g >> 1);
    if (p >= m1) continue;
#pragma unroll
    for (int sset = 0; sset < NS; ++sset) {
      float* __restrict__ o = sset == 0 ? out : outd;
      const int s0 = sset * NPL;   // this set's first accumulator
      if constexpr (LC == 1) {
#pragma unroll
        for (int v = 0; v < 3; ++v) {
          if (trans)
            o[(long long)(3 * q + v) * ldo + p] = acc[j][s0 + v];
          else
            o[(long long)p * ldo + 3 * q + v] = acc[j][s0 + v];
        }
      } else {
#pragma unroll
        for (int u = 0; u < 3; ++u)
#pragma unroll
          for (int v = 0; v < 3; ++v)
            o[(long long)(3 * p + u) * ldo + 3 * q + v] =
                acc[j][s0 + u * 3 + v];
      }
    }
  }
}


template <int LC, int SEL, int KIND, int PREC>
cudaError_t mma_ks_init() {
  return smem_init(rect_mma_ks_kernel<LC, SEL, KIND, PREC>,
                   (size_t)Mma<LC, PREC>::ALIGN + Mma<LC, PREC>::RING +
                       kRangeBytes);
}

// Every (lhs tile, rhs tile), with the ring, its barriers and the chunk
// ranges in dynamic shared memory; the operands 16-byte aligned, of width
// dp.  Returns the launch status.
template <int LC, int SEL, int KIND, int PREC>
int launch_mma_ks(const void* X1, const float* re1, int m1, int B1,
                  const void* X2, const float* re2, int m2, int B2,
                  float* out, float* outd, float sigma2, float gamma,
                  int zeta, long long ldo, int trans, int dp, void* stream) {
  using M = Mma<LC, PREC>;
  if ((trans ? (LC != 1 || ldo < m1) : ldo < 3LL * m2) || !slices(dp))
    return (int)cudaErrorInvalidValue;
  const int nca = (B1 + CB - 1) / CB;
  const int ncb = (B2 + CB - 1) / CB;
  const size_t ranges = sizeof(float) * 2 * ((size_t)nca + ncb);
  const long long lhs_tiles = ((long long)m1 + M::TP1 - 1) / M::TP1;
  if (ranges > kRangeBytes || lhs_tiles > 65535 || ((uintptr_t)X1 & 15) ||
      ((uintptr_t)X2 & 15))
    return (int)cudaErrorInvalidValue;
  CUtensorMap map1 = {}, map2 = {};
  if (M::TMA && (mma_map(X1, m1, B1, dp, M::PL1, M::TP1, &map1) != 0 ||
                 mma_map(X2, m2, B2, dp, M::PL2, TP, &map2) != 0))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(tiles(m2), (unsigned)lhs_tiles);
  rect_mma_ks_kernel<LC, SEL, KIND, PREC>
      <<<grid, NT, (size_t)M::ALIGN + M::RING + ranges,
         (cudaStream_t)stream>>>(
          map1, map2, static_cast<const uint16_t*>(X1), re1, m1, B1,
          static_cast<const uint16_t*>(X2), re2, m2, B2, out, outd, ldo,
          trans, sigma2, gamma, zeta, dp);
  return (int)cudaGetLastError();
}

}  // namespace

cudaError_t kff::rect_mma_ks_init() {
  const cudaError_t rcs[] = {
      mma_ks_init<1, KONLY, RBF, BF16X4>(),
      mma_ks_init<1, DUAL, RBF, BF16X4>(),
      mma_ks_init<1, DERIV, RBF, BF16X4>(),
      mma_ks_init<1, KONLY, DOT, BF16X4>(),
      mma_ks_init<4, KONLY, RBF, BF16X4>(),
      mma_ks_init<4, DUAL, RBF, BF16X4>(),
      mma_ks_init<4, DERIV, RBF, BF16X4>(),
      mma_ks_init<4, KONLY, DOT, BF16X4>(),
      mma_ks_init<1, KONLY, RBF, BF16>(),
      mma_ks_init<1, DUAL, RBF, BF16>(),
      mma_ks_init<1, DERIV, RBF, BF16>(),
      mma_ks_init<1, KONLY, DOT, BF16>(),
      mma_ks_init<4, KONLY, RBF, BF16>(),
      mma_ks_init<4, DUAL, RBF, BF16>(),
      mma_ks_init<4, DERIV, RBF, BF16>(),
      mma_ks_init<4, KONLY, DOT, BF16>()};
  for (cudaError_t rc : rcs)
    if (rc != cudaSuccess) return rc;
  return cudaSuccess;
}

// Entry points <name>_ks: the arguments of every entry point of the
// library (kff_common.cuh) and then the operands' width dp before the
// stream, X1 and X2 the bf16 parts of the mode; k0 and nk are unused.
#define MMA_KS_ENTRY(NAME, LC, SEL, KIND, PREC)                             \
  int NAME##_ks(const void* X1, const float* re1, int m1, int B1,           \
                const void* X2, const float* re2, int m2, int B2,           \
                float* out, float* outd, float sigma2, float gamma,         \
                int zeta, long long, long long, long long ldo, int trans,   \
                int dp, void* stream) {                                     \
    return launch_mma_ks<LC, SEL, KIND, PREC>(X1, re1, m1, B1, X2, re2, m2, \
                                              B2, out, outd, sigma2, gamma, \
                                              zeta, ldo, trans, dp,         \
                                              stream);                      \
  }

#define MMA_KS_FAMILY(SUFFIX, PREC)                               \
  MMA_KS_ENTRY(kef_rect##SUFFIX, 1, KONLY, RBF, PREC)             \
  MMA_KS_ENTRY(kef_rect_dual##SUFFIX, 1, DUAL, RBF, PREC)         \
  MMA_KS_ENTRY(kef_rect_deriv##SUFFIX, 1, DERIV, RBF, PREC)       \
  MMA_KS_ENTRY(kef_rect_dot##SUFFIX, 1, KONLY, DOT, PREC)         \
  MMA_KS_ENTRY(kff_rect##SUFFIX, 4, KONLY, RBF, PREC)             \
  MMA_KS_ENTRY(kff_rect_dual##SUFFIX, 4, DUAL, RBF, PREC)         \
  MMA_KS_ENTRY(kff_rect_deriv##SUFFIX, 4, DERIV, RBF, PREC)       \
  MMA_KS_ENTRY(kff_rect_dot##SUFFIX, 4, KONLY, DOT, PREC)

extern "C" {
MMA_KS_FAMILY(_bf16x4, BF16X4)
MMA_KS_FAMILY(_bf16, BF16)
}  // extern "C"
