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
// What bounds them on this card: the env-pair dot products, a Gram over k
// of the (component, env) rows of the two chunks of a chunk pair, at the
// FP64 tensor-core rate (DMMA, 67 TFLOP/s), and beside them the
// coefficients (one exp in double for RBF) and the assembly at the FP64
// CUDA-core rate (34 TFLOP/s); the operands, 98 MB at 3000 force points x
// 32 envs, stay in L2.  The design:
//  * The dot products on the FP64 tensor cores: mma.sync m16n8k4 .f64
//    (PTX ISA 7.8, sm_90), a warp multiplying 16 lhs envs (a group: 4
//    points x CB envs) by an n-tile of 8 rhs envs (2 points x CB envs) for
//    each of the 4 x 4 component pairs (c1, c2) -- one product a component
//    pair, so that each thread's accumulator fragments (rows lane / 4 and
//    lane / 4 + 8, columns 2 (lane % 4) and + 1) hold all 16 component
//    products of its own env pairs.  The lhs rows are staged so that
//    fragment row g reads env 2g of the group and row g + 8 env 2g + 1
//    (the mode kernels' order, kff_mma.cuh): a thread's four env pairs are
//    the 2 x 2 micro-tile of one point pair, whose coefficients, exp and
//    assembly then stay in registers, summed in e = ia * 2 + ib order, and
//    the four lanes of the point pair (xor 1, xor 4) are summed by
//    shuffles.  A lane's double2 load holds k and k + 1 of an 8-k block;
//    its two halves feed two successive k-steps (both operands read k in
//    the same order, so the product is the Gram).
//  * Staging overlaps the math: a ring of F64::STAGES stages over (chunk
//    pair, k-slice) in dynamic shared memory, filled with 16-byte cp.async
//    copies of whole 256-byte slice rows (env-major, k contiguous, the
//    layout the fragments read; rows padded to KS = 40 doubles, so a
//    quarter-warp's double2 loads fall in 8 distinct bank groups); the
//    next item's copies are in flight while the block multiplies the
//    current one, one block barrier an item.  A lhs chunk slice still held
//    by a stage is not copied again.
//  * Any width: a stage holds one k-slice of DP values; the 16 products
//    (K_FF) or 4 (K_EF) of each env pair stay in registers from a chunk
//    pair's first slice to its last, after which the coefficients and the
//    assembly run once.
//  * The element skip: every block first reads the element range of each
//    of its env chunks (chunk_range on double), a chunk pair whose ranges
//    cannot meet is never staged, and inside a staged pair a warp skips the
//    products and the assembly of a 16 x 8 env sub-tile in which no env
//    pair carries a weight and shares an element (the lanes' vote) -- the
//    granularity of the mode kernels, which ops/kff.py mma_pairs counts.
//    A skipped pair is one whose every weight is zero, which the assembly
//    never adds: the sums are the same bit for bit whatever is skipped.
//  * The tiles: K3 and K1 8 lhs points x 8 rhs points, warp w the lhs
//    group w / 4 against n-tile w % 4; K2 32 lhs energy points x 8 rhs
//    points, warp w n-tile w % 4 against the groups w / 4, + 2, + 4, + 6.
//    A point pair's sum depends on its own envs alone, never on the grid,
//    so K2/K3 stripes cut at whole tiles equal the single launch, and a K1
//    tile range (the tile body does not know the range) summed over shards
//    equals the single launch bit for bit.
//  * Registers: the 64 products of a thread's micro-tile (128 registers),
//    its accumulators and a k-block's fragments: one block of 8 warps an
//    SM (__launch_bounds__(NT, 1)), two stages of 81 KB (K3, K1) or 83 KB
//    (K2) and the chunk ranges in its shared memory.  ptxas: 255
//    registers, spill stores of 52-120 bytes (K3), 312-408 (K2), 468-568
//    (K1).  Measured on an NVIDIA H100 80GB HBM3 (700.00 W; PERF.md): two
//    m8n8k4 in place of one m16n8k4 read 17-37 % slower, the 8-k block
//    loop unrolled x2 4-12 % slower (K1, K3); at the 10k bench shape the
//    kernels reach 23-28 % (K1, K3) and 15 % (K2) of the bound, the block
//    barrier of each item keeping the products and the exp / assembly of
//    its warps from overlapping.
// K1 walks upper-triangle tiles [k0, k0 + gridDim.x), one a block, and
// writes each tile and its transpose (a diagonal tile's upper entries
// mirrored), so K is exactly symmetric.  K2 can store transposed (K_FE of
// a served block).  sigma2 and gamma stay double.

#include "kff_common.cuh"

namespace {

constexpr int KS = DP + 8;   // doubles a staged slice row (320 bytes)

// The geometry of the float64 kernels (K3 and K1: LC = 4; K2: LC = 1),
// that of the mode kernels (kff_mma.cuh Mma): GM groups of 16 lhs envs a
// chunk, WN products (16 x 8 env sub-tiles) a warp.  doubles a stage: the
// lhs chunk slice, the rhs one, the [weight; element] rows of both.
template <int LC>
struct F64 {
  static constexpr int GM = LC == 4 ? 2 : 8;
  static constexpr int WN = LC == 4 ? 1 : 4;
  static constexpr int NE1 = 16 * GM;      // lhs envs a chunk
  static constexpr int TP1 = NE1 / CB;     // lhs points a tile
  static constexpr int S1 = LC * NE1 * KS;
  static constexpr int S2 = 4 * NE * KS;
  static constexpr int STAGE = S1 + S2 + 2 * (NE1 + NE);
  static constexpr int STAGES = 2;
  static_assert(GM * 4 / WN == NT / 32, "one warp per WN products");
};

__device__ __forceinline__ void cp_async8(double* dst, const double* src,
                                          bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int n = valid ? 8 : 0;   // 0 source bytes: zero-filled
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async16d(double* dst, const double* src,
                                            bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(n)
               : "memory");
}

// Copy k-slice [k0, k0 + DP) of NC components of envs [e0, e0 + CB) of
// points [p0, p0 + NEX / CB) of one side (rows of dp doubles) into a
// stage, env-major: row (c * NEX + slot) of KS doubles; what lies past the
// point or env count arrives as zeros.  On the lhs (PERM) side env 2g + h
// of each 16-env group goes to slot g + 8 h, the fragment row that reads
// it.
template <int NC, int NEX, bool PERM>
__device__ __forceinline__ void stage_rows_f64(const double* __restrict__ X,
                                               int m, int B, int dp, int k0,
                                               int p0, int e0,
                                               double* __restrict__ s) {
  constexpr int K2 = DP / 2;                 // 16-byte copies a row
  constexpr int COPIES = NC * NEX * K2;
  static_assert(COPIES % NT == 0, "whole rounds of copies");
  const long long N = (long long)m * B;
#pragma unroll
  for (int i = 0; i < COPIES / NT; ++i) {
    const int idx = threadIdx.x + i * NT;
    const int k2 = idx % K2;
    const int env = (idx / K2) % NEX;
    const int c = idx / (K2 * NEX);
    const int p = p0 + env / CB;
    const int e = e0 + env % CB;
    const bool ok = p < m && e < B;
    const double* src =
        ok ? X + (c * N + (long long)p * B + e) * dp + k0 + 2 * k2 : X;
    const int slot =
        PERM ? (env & ~15) | ((env & 1) << 3) | ((env & 15) >> 1) : env;
    cp_async16d(s + (c * NEX + slot) * KS + 2 * k2, src, ok);
  }
}

// [weight, element] of the same envs, in env order: sre[row * NEX + env].
template <int NEX>
__device__ __forceinline__ void stage_re_f64(const double* __restrict__ re,
                                             int m, int B, int p0, int e0,
                                             double* __restrict__ sre) {
  const long long N = (long long)m * B;
  for (int idx = threadIdx.x; idx < 2 * NEX; idx += NT) {
    const int row = idx / NEX;
    const int env = idx % NEX;
    const int p = p0 + env / CB;
    const int e = e0 + env % CB;
    const bool ok = p < m && e < B;
    cp_async8(sre + idx, ok ? re + row * N + (long long)p * B + e : re, ok);
  }
}

// D += A B on the FP64 tensor cores, 16 x 8 x 4: a0 row lane / 4, a1 row
// lane / 4 + 8, both column lane % 4; b column lane / 4, row lane % 4; d
// rows lane / 4 (d[0], d[1]) and + 8 (d[2], d[3]), columns 2 (lane % 4)
// and + 1.
__device__ __forceinline__ void dmma(double (&d)[4], double a0, double a1,
                                     double b) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a0), "d"(a1), "d"(b));
}

// Accumulators of one point pair and product: 9 (K_FF) or 3 (K_EF)
// planes a set, one set (K, or dK/dgamma) or two (DUAL).
template <int LC, int SEL>
struct Acc {
  static constexpr int NPL = LC == 4 ? 9 : 3;
  static constexpr int NS = SEL == DUAL ? 2 : 1;
  static constexpr int NOUT = NPL * NS;
  static constexpr int DSET = SEL == DUAL ? NPL : 0;
};

// The sums of lhs tile I (F64<LC>::TP1 points from p1) against rhs tile J
// (TP points from p2) into this thread's acc[j] for each of its WN
// products, reduced over the four lanes of each point pair.  LC = 4: K_FF,
// both sides force operands; LC = 1: K_EF, the lhs side energy operands.
// smem: the ring, then the chunk ranges.
template <int LC, int SEL, int KIND>
__device__ __forceinline__ void f64_tile(
    const double* __restrict__ X1, const double* __restrict__ re1, int m1,
    int B1, const double* __restrict__ X2, const double* __restrict__ re2,
    int m2, int B2, int dp, int p1, int p2, bool one_tile, double sigma2,
    double gamma, int zeta, double* __restrict__ smem,
    double (&acc)[F64<LC>::WN][Acc<LC, SEL>::NOUT]) {
  static_assert(KIND == RBF || SEL == KONLY,
                "the Dot kernel has no dK/dgamma pass");
  using M = F64<LC>;
  using C = Acc<LC, SEL>;
  constexpr int WN = M::WN, NE1 = M::NE1, S = M::STAGES;
  constexpr int DSET = C::DSET;
  const int nca = (B1 + CB - 1) / CB;
  const int ncb = (B2 + CB - 1) / CB;
  double* const rng1 = smem + S * M::STAGE;
  double* const rng2 = one_tile ? rng1 : rng1 + 2 * nca;

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int g = lane >> 2, q4 = lane & 3;
  // this warp's n-tile and the lhs group of its j-th product (K3, K1: one,
  // group warp / 4; K2: groups warp / 4, + 2, + 4, + 6)
  const int nt = warp & 3;
  auto group = [&](int j) { return 2 * j + (warp >> 2); };

  for (int ch = warp; ch < (one_tile ? nca : nca + ncb); ch += NT / 32) {
    if (ch < nca)
      chunk_range<NE1, CB, double>(re1, m1, B1, p1, ch, rng1);
    else
      chunk_range<NE, CB, double>(re2, m2, B2, p2, ch - nca, rng2);
  }
#pragma unroll
  for (int j = 0; j < WN; ++j)
#pragma unroll
    for (int i = 0; i < C::NOUT; ++i) acc[j][i] = 0.0;
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
  // the producer's cursor, the items issued, and the lhs chunk slices (a
  // ns + ks) of the last S items issued (held[0]: the one whose stage the
  // next item takes); every thread copies with cp.async, one group an item
  int pa = 0, pb = -1, pks = ns - 1, issued = 0;
  bool more = next(pa, pb, pks);
  int held[S];
#pragma unroll
  for (int k = 0; k < S; ++k) held[k] = -1;
  auto issue = [&]() {
    double* const st = smem + (issued % S) * M::STAGE;
    const bool lhs = held[0] != pa * ns + pks;
    if (lhs) {
      stage_rows_f64<LC, NE1, true>(X1, m1, B1, dp, pks * DP, p1, pa * CB,
                                    st);
      stage_re_f64<NE1>(re1, m1, B1, p1, pa * CB, st + M::S1 + M::S2);
    }
    stage_rows_f64<4, NE, false>(X2, m2, B2, dp, pks * DP, p2, pb * CB,
                                 st + M::S1);
    stage_re_f64<NE>(re2, m2, B2, p2, pb * CB,
                     st + M::S1 + M::S2 + 2 * NE1);
#pragma unroll
    for (int k = 0; k + 1 < S; ++k) held[k] = held[k + 1];
    held[S - 1] = pa * ns + pks;
    ++issued;
    more = next(pa, pb, pks);
  };

  // G[c][c2][e]: the products of this thread's env pair e = ia * 2 + ib
  // (lhs env 2g + ia of the group, rhs env 2 q4 + ib of the n-tile) of lhs
  // component row c (K3, K1) or of product c (K2, row 0) with rhs
  // component c2, summed over the slices of one chunk pair
  constexpr int NG = LC == 4 ? 4 : WN;
  double G[NG][4][4];

  // S - 1 items in flight ahead of the one multiplied; one group of copies
  // committed an item (empty past the last), one block barrier an item:
  // the stage refilled after it is the one every warp finished before it
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

    const int ks = it % ns;
    const double* const s1 = smem + (it % S) * M::STAGE;
    const double* const s2 = s1 + M::S1;
    const double* const sw1 = s2 + M::S2;   // lhs weights
    const double* const se1 = sw1 + NE1;    // lhs elements
    const double* const sw2 = se1 + NE1;    // rhs weights
    const double* const se2 = sw2 + NE;
    auto weight = [&](int j, int e) -> double {
      const int ia = group(j) * 16 + 2 * g + (e >> 1);
      const int ib = nt * 8 + 2 * q4 + (e & 1);
      const double same = se1[ia] == se2[ib] ? 1.0 : 0.0;
      return sw1[ia] * sw2[ib] * same;
    };
    // the products in which the warp has any pair to add (bit j)
    unsigned todo = 0;
#pragma unroll
    for (int j = 0; j < WN; ++j) {
      bool any = false;
#pragma unroll
      for (int e = 0; e < 4; ++e) any = any || weight(j, e) != 0.0;
      if (__any_sync(0xffffffffu, any)) todo |= 1u << j;
    }
    if (!todo) continue;

    if (ks == 0) {
#pragma unroll
      for (int c = 0; c < NG; ++c)
#pragma unroll
        for (int c2 = 0; c2 < 4; ++c2)
#pragma unroll
          for (int e = 0; e < 4; ++e) G[c][c2][e] = 0.0;
    }
    // the slice's 8-k blocks: a lane loads k = 8 kb + 2 q4 and + 1 of its
    // rows, the .x halves one k-step and the .y halves the next
#pragma unroll 1
    for (int kb = 0; kb < DP / 8; ++kb) {
      const int k = kb * 8 + 2 * q4;
      double2 b[4];
#pragma unroll
      for (int c2 = 0; c2 < 4; ++c2)
        b[c2] = *reinterpret_cast<const double2*>(
            s2 + (c2 * NE + nt * 8 + g) * KS + k);
#pragma unroll
      for (int c = 0; c < NG; ++c) {
        if (LC == 1 && !(todo >> c & 1u)) continue;
        const int row = (LC == 4 ? c * NE1 + group(0) * 16
                                 : group(c) * 16) + g;
        const double2 a0 =
            *reinterpret_cast<const double2*>(s1 + row * KS + k);
        const double2 a1 =
            *reinterpret_cast<const double2*>(s1 + (row + 8) * KS + k);
#pragma unroll
        for (int c2 = 0; c2 < 4; ++c2) dmma(G[c][c2], a0.x, a1.x, b[c2].x);
#pragma unroll
        for (int c2 = 0; c2 < 4; ++c2) dmma(G[c][c2], a0.y, a1.y, b[c2].y);
      }
    }
    if (ks != ns - 1) continue;

    // the coefficients and the assembly, after the pair's last slice
#pragma unroll
    for (int j = 0; j < WN; ++j) {
      if (!(todo >> j & 1u)) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const double w = weight(j, e);
        if (w == 0.0) continue;
        const double c = LC == 4 ? G[0][0][e] : G[j][0][e];
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
              const double Bp1 = Bc * G[1 + u][0][e];
#pragma unroll
              for (int v = 0; v < 3; ++v)
                acc[0][u * 3 + v] +=
                    A * G[1 + u][1 + v][e] + Bp1 * G[0][1 + v][e];
            }
          }
          if constexpr (SEL != KONLY) {
            const double Dm1 = D - 1.0;
            const double kw = k * w;
            const double dA = A * Dm1 + kw * zd1;
            const double dB = Bc * Dm1 + kw * (b0c + 2.0 * zd1 * zd1 * gamma);
#pragma unroll
            for (int u = 0; u < 3; ++u) {
              const double dBp1 = dB * G[1 + u][0][e];
#pragma unroll
              for (int v = 0; v < 3; ++v)
                acc[0][DSET + u * 3 + v] +=
                    dA * G[1 + u][1 + v][e] + dBp1 * G[0][1 + v][e];
            }
          }
        } else {
          const double A0 = -A;
          if constexpr (SEL != DERIV) {
#pragma unroll
            for (int v = 0; v < 3; ++v) acc[j][v] += A0 * G[j][1 + v][e];
          }
          if constexpr (SEL != KONLY) {
            const double dA0 = A0 * (D - 1.0) - k * w * zd1;
#pragma unroll
            for (int v = 0; v < 3; ++v)
              acc[j][DSET + v] += dA0 * G[j][1 + v][e];
          }
        }
      }
    }
  }

  // reduce the 2 x 2 micro-tiles of each point pair (lanes xor 1, xor 4)
#pragma unroll
  for (int j = 0; j < WN; ++j)
#pragma unroll
    for (int i = 0; i < C::NOUT; ++i) {
      acc[j][i] += __shfl_xor_sync(0xffffffffu, acc[j][i], 1);
      acc[j][i] += __shfl_xor_sync(0xffffffffu, acc[j][i], 4);
    }
}

// K2 (LC = 1) and K3 (LC = 4) in float64: blockIdx.y = lhs tile
// (F64<LC>::TP1 points), blockIdx.x = rhs tile (TP points); dp the
// operands' width.  out (and outd for DUAL) have leading dimension ldo;
// trans (K_EF only) stores out[(3 q + v) * ldo + p].
template <int LC, int SEL, int KIND>
__global__ void __launch_bounds__(NT, 1)
rect_f64_kernel(const double* __restrict__ X1, const double* __restrict__ re1,
                int m1, int B1, const double* __restrict__ X2,
                const double* __restrict__ re2, int m2, int B2,
                double* __restrict__ out, double* __restrict__ outd,
                long long ldo, int trans, double sigma2, double gamma,
                int zeta, int dp) {
  using M = F64<LC>;
  using C = Acc<LC, SEL>;
  extern __shared__ __align__(16) double smem_f64[];
  const int I = blockIdx.y, J = blockIdx.x;
  double acc[M::WN][C::NOUT];
  f64_tile<LC, SEL, KIND>(X1, re1, m1, B1, X2, re2, m2, B2, dp, I * M::TP1,
                          J * TP, false, sigma2, gamma, zeta, smem_f64, acc);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if ((lane & 5) != 0) return;
  const int g = lane >> 2, q4 = lane & 3;
  const int q = J * TP + 2 * (warp & 3) + (q4 >> 1);
  if (q >= m2) return;
#pragma unroll
  for (int j = 0; j < M::WN; ++j) {
    const int p = I * M::TP1 + (2 * j + (warp >> 2)) * 4 + (g >> 1);
    if (p >= m1) continue;
#pragma unroll
    for (int sset = 0; sset < C::NS; ++sset) {
      double* __restrict__ o = sset == 0 ? out : outd;
      const int s0 = sset * C::NPL;
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

// K1 in float64: tiles [k0, k0 + gridDim.x) of the upper triangle of one
// operand (X, re) of width dp, each written with its transpose.
template <int SEL, int KIND>
__global__ void __launch_bounds__(NT, 1)
tri_f64_kernel(const double* __restrict__ X, const double* __restrict__ re,
               int m, int B, double* __restrict__ out,
               double* __restrict__ outd, long long ldo, double sigma2,
               double gamma, int zeta, long long k0, int dp) {
  using C = Acc<4, SEL>;
  extern __shared__ __align__(16) double smem_f64[];
  int I, J;
  tri_tile(k0 + blockIdx.x, I, J);
  double acc[1][C::NOUT];
  // a diagonal tile reads its chunk ranges once for both roles
  f64_tile<4, SEL, KIND>(X, re, m, B, X, re, m, B, dp, I * TP, J * TP,
                         I == J, sigma2, gamma, zeta, smem_f64, acc);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if ((lane & 5) != 0) return;
  const int g = lane >> 2, q4 = lane & 3;
  const int pl = 4 * (warp >> 2) + (g >> 1);
  const int ql = 2 * (warp & 3) + (q4 >> 1);
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
          o[(long long)(3 * p + u) * ldo + 3 * q + v] = acc[0][s0 + u * 3 + v];
          o[(long long)(3 * q + v) * ldo + 3 * p + u] = acc[0][s0 + u * 3 + v];
        }
    } else if (pl == ql) {
#pragma unroll
      for (int u = 0; u < 3; ++u)
#pragma unroll
        for (int v = u; v < 3; ++v) {
          const double x = acc[0][s0 + u * 3 + v];
          o[(long long)(3 * p + u) * ldo + 3 * p + v] = x;
          o[(long long)(3 * p + v) * ldo + 3 * p + u] = x;
        }
    }
  }
}

template <int LC>
constexpr size_t f64_ring_bytes() {
  return sizeof(double) * F64<LC>::STAGES * (size_t)F64<LC>::STAGE;
}

// Every (lhs tile, rhs tile), the ring and the chunk ranges in dynamic
// shared memory; the operands 16-byte aligned.  Returns the launch status.
template <int LC, int SEL, int KIND>
int launch_rect_f64(const double* X1, const double* re1, int m1, int B1,
                    const double* X2, const double* re2, int m2, int B2,
                    double* out, double* outd, double sigma2, double gamma,
                    int zeta, long long ldo, int trans, int dp,
                    void* stream) {
  using M = F64<LC>;
  if ((trans ? (LC != 1 || ldo < m1) : ldo < 3LL * m2) || !slices(dp) ||
      ((uintptr_t)X1 & 15) || ((uintptr_t)X2 & 15))
    return (int)cudaErrorInvalidValue;
  const int nca = (B1 + CB - 1) / CB;
  const int ncb = (B2 + CB - 1) / CB;
  const size_t ranges = sizeof(double) * 2 * ((size_t)nca + ncb);
  const long long lhs_tiles = ((long long)m1 + M::TP1 - 1) / M::TP1;
  if (ranges > kRangeBytes || lhs_tiles > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid(tiles(m2), (unsigned)lhs_tiles);
  rect_f64_kernel<LC, SEL, KIND>
      <<<grid, NT, f64_ring_bytes<LC>() + ranges, (cudaStream_t)stream>>>(
          X1, re1, m1, B1, X2, re2, m2, B2, out, outd, ldo, trans, sigma2,
          gamma, zeta, dp);
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
                   int trans, int dp, void* stream) {
  const int nc = (B1 + CB - 1) / CB;
  const size_t ranges = sizeof(double) * 4 * (size_t)nc;
  const long long nt = tiles(m1);
  if (trans || ldo < 3LL * m1 || X2 != X1 || re2 != re1 || m2 != m1 ||
      B2 != B1 || !slices(dp) || ((uintptr_t)X1 & 15) ||
      ranges > kRangeBytes || k0 < 0 || nk < 1 || nk > 0x7fffffffLL ||
      k0 + nk > nt * (nt + 1) / 2)
    return (int)cudaErrorInvalidValue;
  tri_f64_kernel<SEL, KIND>
      <<<dim3((unsigned)nk), NT, f64_ring_bytes<4>() + ranges,
         (cudaStream_t)stream>>>(X1, re1, m1, B1, out, outd, ldo, sigma2,
                                 gamma, zeta, k0, dp);
  return (int)cudaGetLastError();
}

template <int LC, int SEL, int KIND>
cudaError_t rect_f64_init() {
  return smem_init(rect_f64_kernel<LC, SEL, KIND>,
                   f64_ring_bytes<LC>() + kRangeBytes);
}

template <int SEL, int KIND>
cudaError_t tri_f64_init() {
  return smem_init(tri_f64_kernel<SEL, KIND>,
                   f64_ring_bytes<4>() + kRangeBytes);
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
// X float64 (4, N, 32) (K2's lhs (N, 32)); <name>_ks takes the operands'
// width dp (X (4, N, dp)) before the stream and runs the same kernel.  K1:
// X2 = X1, tiles [k0, k0 + nk) of the upper triangle and their transposes
// written, nothing else; K2 and K3 ignore k0 and nk.
#define F64_ARGS                                                            \
  const void *X1, const double *re1, int m1, int B1, const void *X2,        \
      const double *re2, int m2, int B2, double *out, double *outd,         \
      double sigma2, double gamma, int zeta, long long k0, long long nk,    \
      long long ldo, int trans
#define TRI_F64_CALL(SEL, KIND, DPW)                                        \
  launch_tri_f64<SEL, KIND>(static_cast<const double*>(X1), re1, m1, B1,    \
                            static_cast<const double*>(X2), re2, m2, B2,    \
                            out, outd, sigma2, gamma, zeta, k0, nk, ldo,    \
                            trans, DPW, stream)
#define TRI_F64_ENTRY(NAME, SEL, KIND)                                      \
  int NAME(F64_ARGS, void* stream) {                                        \
    return TRI_F64_CALL(SEL, KIND, DP);                                     \
  }                                                                         \
  int NAME##_ks(F64_ARGS, int dp, void* stream) {                           \
    return TRI_F64_CALL(SEL, KIND, dp);                                     \
  }
#define RECT_F64_CALL(LC, SEL, KIND, DPW)                                   \
  launch_rect_f64<LC, SEL, KIND>(static_cast<const double*>(X1), re1, m1,   \
                                 B1, static_cast<const double*>(X2), re2,   \
                                 m2, B2, out, outd, sigma2, gamma, zeta,    \
                                 ldo, trans, DPW, stream)
#define RECT_F64_ENTRY(NAME, LC, SEL, KIND)                                 \
  int NAME(F64_ARGS, void* stream) {                                        \
    return RECT_F64_CALL(LC, SEL, KIND, DP);                                \
  }                                                                         \
  int NAME##_ks(F64_ARGS, int dp, void* stream) {                           \
    return RECT_F64_CALL(LC, SEL, KIND, dp);                                \
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
