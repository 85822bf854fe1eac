// K3 (kff_rect*, LC = 4) and K2 (kef_rect*, LC = 1) in the bf16 modes:
// the rectangular covariance blocks of every served request, and K2 of
// every training covariance, as bf16 tensor-core products with fp32 sums,
// on rect_mma_kernel<LC, SEL, KIND, PREC>.  Plain C interface, loaded with
// ctypes by ops/kff.py, which builds every source of this directory into
// one library; kff_common.cuh has the operands and the per-env-pair
// arithmetic, kff_mma.cuh the tensor-core path it shares with the mode
// K1 (kff_tri_mma.cu).
//
// They replace _kff_kernel (kff_pallas.py:269, K3) and _kef_kernel
// (kff_pallas.py:748, K2) at mm_precision "bf16x4" and "bf16" (_lhs_rhs
// :394, _pair_blocks :151).  Each block is the exact Gram of the same
// rounded rows as before: in bf16x4 every dot product is hi.hi + hi.lo +
// lo.hi + lo.lo, in bf16 the one product, all on mma.sync m16n8k16 with
// fp32 sums, so the covariance stays PSD by construction.
//
// What bounds them on this card: the tensor-core products of the env
// pairs that share an element (bf16x4 K3), or the CUDA-core coefficients
// and assembly of those pairs (one expf each for RBF; K2 and bf16), not
// device memory: the operands stay in L2.  What the design does about it,
// after rect_kernel (kff_rect.cu), fitted to the bf16 parts:
//  * The element skip.  Every block first reads the element range of the
//    valid envs of each of its env chunks (chunk_range); a chunk pair whose
//    ranges do not meet is never staged.  Inside a staged pair a warp
//    skips the products and the assembly of each of its 16 x 8 env
//    sub-tiles (a lhs group of 4 points x 4 envs against an n-tile of 2 rhs
//    points x 4 envs) in which no env pair shares an element and carries a
//    weight: every lane tests its own four pairs, and the warp votes.  A
//    skipped pair is one whose every weight is zero, which the assembly
//    never adds, so the sums are the same bit for bit whatever is skipped.
//  * Staging overlaps the arithmetic: the next chunk pairs stay in flight
//    in a ring of stages in dynamic shared memory while the block
//    multiplies the current one, with one block barrier a chunk pair; the
//    bf16 parts are env-major with k contiguous, the layout mma.row.col
//    reads, so whole 64-byte env rows are copied, untransposed, and a lhs
//    chunk already held by a stage is not copied again.  bf16x4 reads them
//    through the Tensor Memory Accelerator -- a 4-D tensor map (k, env,
//    point, plane) of each side, one box (32 k x CB envs x points x all
//    planes) a side and chunk, the 64-byte swizzle, zeros past the ragged
//    edges, a full mbarrier a stage, 3 stages -- and bf16 with 16-byte
//    cp.async copies into rows padded to 80 bytes, 4 stages.  Each is the
//    faster of the two in its mode, at the slice, mid and bench shapes
//    (PERF.md): the TMA saves bf16x4 the issue of twice the copies of bf16,
//    and costs bf16, whose chunk pairs carry a quarter of the products,
//    more than it saves.
//  * Fragments come from ldmatrix (.x4: one A fragment of 16 lhs envs x 16
//    k; .x2: one B fragment of 8 rhs envs x 16 k), one k half at a time.
//    Fragment row g reads env 2g of the group and row g + 8 env 2g + 1
//    (Frag): then each thread's accumulators hold one point pair's 2 x 2
//    env micro-tile (lhs envs 2g, 2g + 1, rhs envs 2q, 2q + 1, q = lane %
//    4), and the assembly is the per-pair code of kff_common.cuh, summed
//    in its order.
//  * Fewer live registers: K3 takes the lhs component rows one at a time,
//    row c1 = 0 (c and p2_v) first, which gives the coefficients; then
//    each c1 = 1 + u (p1_u and m_uv) in turn, folded into the accumulators
//    at once: 16 live products in place of 64.
//  * Tiles: K3 8 lhs points x 8 rhs points, warp w the lhs group w / 4
//    against n-tile w % 4.  K2 32 lhs energy points x 8 rhs points, so
//    each staged rhs chunk serves four times as many lhs points: warp w
//    takes n-tile w % 4 against the groups w / 4, + 2, + 4, + 6, so a
//    served request's one or few energy points still spread over four
//    warps.
//  * The output goes to out + row * ldo (a caller's buffer, any leading
//    dimension), and K2 can store transposed (K_FE of a served block).
// Every output element is written once by one thread; a point pair's sum
// is taken in an order that depends on its own envs alone (chunk pairs in
// nested order, then the lanes of the pair by shuffles), never on the
// grid, so stripes of a block equal the single launch bit for bit.

#include "kff_mma.cuh"

namespace {

// LC = 4: K_FF (kff_rect*), LC = 1: K_EF (kef_rect*); SEL and KIND as in
// every kernel (kff_common.cuh); PREC = BF16X4 or BF16: X1 and X2 the two
// sides' bf16 parts, read through the tensor maps map1 and map2 (mma_map)
// where the mode stages with the TMA; re1 and re2 their [weight, element]
// rows.  blockIdx.y = lhs tile (Mma::TP1 points), blockIdx.x = rhs tile
// (TP points).  out (and outd for DUAL) have leading dimension ldo; trans
// (K_EF only) stores out[(3 q + v) * ldo + p] instead of out[p * ldo + 3 q
// + v].  Two blocks an SM (128 registers a thread, up to 104 KB of ring a
// block).
template <int LC, int SEL, int KIND, int PREC>
__global__ void __launch_bounds__(NT, 2)
rect_mma_kernel(const __grid_constant__ CUtensorMap map1,
                const __grid_constant__ CUtensorMap map2,
                const uint16_t* __restrict__ X1,
                const float* __restrict__ re1, int m1, int B1,
                const uint16_t* __restrict__ X2,
                const float* __restrict__ re2, int m2, int B2,
                float* __restrict__ out, float* __restrict__ outd,
                long long ldo, int trans, float sigma2, float gamma,
                int zeta) {
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
  // the producer's cursor, the pairs issued, and the lhs chunks of the
  // last S pairs issued (held[0]: the one whose stage the next pair takes).
  // With the TMA thread 0 copies the rows (the stage's full barrier counts
  // their bytes), else every thread does with cp.async; every thread
  // copies the weights and elements with cp.async (one group a pair)
  int pa = 0, pb = -1, issued = 0;
  bool more = next(pa, pb);
  int held[S];
#pragma unroll
  for (int k = 0; k < S; ++k) held[k] = -1;
  auto issue = [&]() {
    const int s = issued % S;
    unsigned char* const st = ring + s * M::STAGE;
    uint16_t* const s1 = reinterpret_cast<uint16_t*>(st);
    uint16_t* const s2 = s1 + M::S1;
    float* const sre = reinterpret_cast<float*>(s2 + M::S2);
    const bool lhs = held[0] != pa;
    if constexpr (M::TMA) {
      if (t == 0) {
        // the stage was last read by the generic proxy (ldmatrix) before
        // the block barrier this follows
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_expect_tx(&full[s], 2 * (M::S2 + (lhs ? M::S1 : 0)));
        if (lhs) tma_load4(s1, &map1, &full[s], pa * CB, I * M::TP1);
        tma_load4(s2, &map2, &full[s], pb * CB, J * TP);
      }
    } else {
      if (lhs)
        stage_rows<LC, NP, NE1, true>(X1, m1, B1, I * M::TP1, pa * CB, s1);
      stage_rows<4, NP, NE, false>(X2, m2, B2, J * TP, pb * CB, s2);
    }
    if (lhs) stage_re_async<NE1, CB>(re1, m1, B1, I * M::TP1, pa * CB, sre);
    stage_re_async<NE, CB>(re2, m2, B2, J * TP, pb * CB, sre + 2 * NE1);
#pragma unroll
    for (int k = 0; k + 1 < S; ++k) held[k] = held[k + 1];
    held[S - 1] = pa;
    ++issued;
    more = next(pa, pb);
  };

  float acc[WN][NOUT];
#pragma unroll
  for (int j = 0; j < WN; ++j)
#pragma unroll
    for (int i = 0; i < NOUT; ++i) acc[j][i] = 0.f;

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

    if constexpr (LC == 4) {
      if (todo) {
        // row c1 = 0 (c, p2_v): the coefficients of each pair
        float wv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) wv[e] = weight(0, e);
        float G[4][4];
        products<LC, NP, NE1, M::ROW>(s1, s2, 0, group(0), nt, frag, G);
        float cA[NS][4], cB[NS][4], p2[3][4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
#pragma unroll
          for (int v = 0; v < 3; ++v) p2[v][e] = G[1 + v][e];
#pragma unroll
          for (int s = 0; s < NS; ++s) cA[s][e] = cB[s][e] = 0.f;
          const float w = wv[e];
          if (w == 0.f) continue;
          float k, A, Bc, D, zd1, b0c;
          pair_coeffs<KIND>(G[0][e], w, sigma2, gamma, zeta, k, A, Bc, D,
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
        // rows c1 = 1 + u (p1_u, m_uv), each folded in at once
#pragma unroll
        for (int u = 0; u < 3; ++u) {
          products<LC, NP, NE1, M::ROW>(s1, s2, 1 + u, group(0), nt, frag,
                                        G);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (wv[e] == 0.f) continue;
#pragma unroll
            for (int s = 0; s < NS; ++s) {
              const float Bp1 = cB[s][e] * G[0][e];
#pragma unroll
              for (int v = 0; v < 3; ++v)
                acc[0][s * NPL + u * 3 + v] +=
                    cA[s][e] * G[1 + v][e] + Bp1 * p2[v][e];
            }
          }
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < WN; ++j) {
        if (!(todo >> j & 1u)) continue;
        float G[4][4];
        products<LC, NP, NE1, M::ROW>(s1, s2, 0, group(j), nt, frag, G);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float w = weight(j, e);
          if (w == 0.f) continue;
          float k, A, Bc, D, zd1, b0c;
          pair_coeffs<KIND>(G[0][e], w, sigma2, gamma, zeta, k, A, Bc, D,
                            zd1, b0c);
          const float A0 = -A;
          if constexpr (SEL != DERIV) {
#pragma unroll
            for (int v = 0; v < 3; ++v) acc[j][v] += A0 * G[1 + v][e];
          }
          if constexpr (SEL != KONLY) {
            const float dA0 = A0 * (D - 1.f) - k * w * zd1;
#pragma unroll
            for (int v = 0; v < 3; ++v)
              acc[j][DSET + v] += dA0 * G[1 + v][e];
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
cudaError_t mma_init() {
  return smem_init(rect_mma_kernel<LC, SEL, KIND, PREC>,
                   (size_t)Mma<LC, PREC>::ALIGN + Mma<LC, PREC>::RING +
                       kRangeBytes);
}

// Every (lhs tile, rhs tile), with the ring, its barriers and the chunk
// ranges in dynamic shared memory; the operands 16-byte aligned.  Returns
// the launch status.
template <int LC, int SEL, int KIND, int PREC>
int launch_mma(const void* X1, const float* re1, int m1, int B1,
               const void* X2, const float* re2, int m2, int B2, float* out,
               float* outd, float sigma2, float gamma, int zeta,
               long long ldo, int trans, void* stream) {
  using M = Mma<LC, PREC>;
  if (trans ? (LC != 1 || ldo < m1) : ldo < 3LL * m2)
    return (int)cudaErrorInvalidValue;
  const int nca = (B1 + CB - 1) / CB;
  const int ncb = (B2 + CB - 1) / CB;
  const size_t ranges = sizeof(float) * 2 * ((size_t)nca + ncb);
  const long long lhs_tiles = ((long long)m1 + M::TP1 - 1) / M::TP1;
  if (ranges > kRangeBytes || lhs_tiles > 65535 || ((uintptr_t)X1 & 15) ||
      ((uintptr_t)X2 & 15))
    return (int)cudaErrorInvalidValue;
  CUtensorMap map1 = {}, map2 = {};
  if (M::TMA && (mma_map(X1, m1, B1, M::PL1, M::TP1, &map1) != 0 ||
                 mma_map(X2, m2, B2, M::PL2, TP, &map2) != 0))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(tiles(m2), (unsigned)lhs_tiles);
  rect_mma_kernel<LC, SEL, KIND, PREC>
      <<<grid, NT, (size_t)M::ALIGN + M::RING + ranges,
         (cudaStream_t)stream>>>(
          map1, map2, static_cast<const uint16_t*>(X1), re1, m1, B1,
          static_cast<const uint16_t*>(X2), re2, m2, B2, out, outd, ldo,
          trans, sigma2, gamma, zeta);
  return (int)cudaGetLastError();
}

}  // namespace

cudaError_t kff::rect_mma_init() {
  const cudaError_t rcs[] = {
      mma_init<1, KONLY, RBF, BF16X4>(), mma_init<1, DUAL, RBF, BF16X4>(),
      mma_init<1, DERIV, RBF, BF16X4>(), mma_init<1, KONLY, DOT, BF16X4>(),
      mma_init<4, KONLY, RBF, BF16X4>(), mma_init<4, DUAL, RBF, BF16X4>(),
      mma_init<4, DERIV, RBF, BF16X4>(), mma_init<4, KONLY, DOT, BF16X4>(),
      mma_init<1, KONLY, RBF, BF16>(),   mma_init<1, DUAL, RBF, BF16>(),
      mma_init<1, DERIV, RBF, BF16>(),   mma_init<1, KONLY, DOT, BF16>(),
      mma_init<4, KONLY, RBF, BF16>(),   mma_init<4, DUAL, RBF, BF16>(),
      mma_init<4, DERIV, RBF, BF16>(),   mma_init<4, KONLY, DOT, BF16>()};
  for (cudaError_t rc : rcs)
    if (rc != cudaSuccess) return rc;
  return cudaSuccess;
}

// Entry points as every entry point of the library (kff_common.cuh), X1 and
// X2 the bf16 parts of the mode; k0 and nk are unused.  K_FF: out (3 m1,
// 3 m2); K_EF: out (m1, 3 m2), or with trans != 0 K_EF transposed, out
// (3 m2, m1) with ldo at least m1.
#define MMA_ENTRY(NAME, LC, SEL, KIND, PREC)                                \
  int NAME(const void* X1, const float* re1, int m1, int B1,                \
           const void* X2, const float* re2, int m2, int B2, float* out,    \
           float* outd, float sigma2, float gamma, int zeta, long long,     \
           long long, long long ldo, int trans, void* stream) {             \
    return launch_mma<LC, SEL, KIND, PREC>(X1, re1, m1, B1, X2, re2, m2,    \
                                           B2, out, outd, sigma2, gamma,    \
                                           zeta, ldo, trans, stream);       \
  }

#define MMA_FAMILY(SUFFIX, PREC)                                  \
  MMA_ENTRY(kef_rect##SUFFIX, 1, KONLY, RBF, PREC)                \
  MMA_ENTRY(kef_rect_dual##SUFFIX, 1, DUAL, RBF, PREC)            \
  MMA_ENTRY(kef_rect_deriv##SUFFIX, 1, DERIV, RBF, PREC)          \
  MMA_ENTRY(kef_rect_dot##SUFFIX, 1, KONLY, DOT, PREC)            \
  MMA_ENTRY(kff_rect##SUFFIX, 4, KONLY, RBF, PREC)                \
  MMA_ENTRY(kff_rect_dual##SUFFIX, 4, DUAL, RBF, PREC)            \
  MMA_ENTRY(kff_rect_deriv##SUFFIX, 4, DERIV, RBF, PREC)          \
  MMA_ENTRY(kff_rect_dot##SUFFIX, 4, KONLY, DOT, PREC)

extern "C" {
MMA_FAMILY(_bf16x4, BF16X4)
MMA_FAMILY(_bf16, BF16)
}  // extern "C"
