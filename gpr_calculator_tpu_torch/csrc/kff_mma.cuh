// The tensor-core path shared by the mode kernels, kff_rect_mma.cu (K2,
// K3) and kff_tri_mma.cu (K1): the geometry of a chunk pair on mma.sync
// (Mma), the fragment loads (ldmatrix, Frag), the two stagings of a chunk
// (cp.async into padded rows, stage_rows; the TMA through a 4-D tensor map,
// tma_load4 and mma_map), the products of one lhs component row against an
// n-tile (products) and the per-pair coefficients (pair_coeffs).  Each
// kernel keeps its own loop body: one per-chunk-pair function shared by
// K1-K3 made K1 slower (PERF.md).
#pragma once

#include "kff_tma.cuh"

namespace {

// The geometry of rect_mma_kernel<LC, ..., PREC> (and, LC = 4, of
// tri_mma_kernel<..., PREC>).  A warp multiplies 16 lhs envs (one group: 4
// points x CB envs of the chunk) by an n-tile of 8 rhs envs (2 points x CB
// envs), WN such products a chunk pair; GM groups make the lhs chunk.  A
// stage holds one chunk pair, STAGES stages make the ring.  TMA_: the rows
// are staged by the TMA (rows of DP bf16, swizzled) or with cp.async (rows
// padded to RS).  K2 and K3 take the TMA in bf16x4 and cp.async in bf16,
// K1 the TMA in both: each the faster of the two in its mode (PERF.md).
template <int LC, int PREC, bool TMA_ = PREC == BF16X4>
struct Mma {
  static constexpr bool TMA = TMA_;
  static constexpr int NP = PREC == BF16X4 ? 2 : 1;   // bf16 parts a value
  static constexpr int GM = LC == 4 ? 2 : 8;          // lhs groups a chunk
  static constexpr int WN = LC == 4 ? 1 : 4;          // products a warp
  static constexpr int NE1 = 16 * GM;                 // lhs envs a chunk
  static constexpr int TP1 = NE1 / CB;                // lhs points a tile
  static constexpr int PL1 = NP * LC;                 // lhs planes,
  static constexpr int PL2 = NP * 4;                  // rhs planes
  static constexpr int ROW = TMA ? DP : RS;           // bf16 a staged row
  static constexpr int S1 = PL1 * NE1 * ROW;          // bf16: lhs chunk,
  static constexpr int S2 = PL2 * NE * ROW;           // rhs chunk
  // bytes of one stage: both chunks, then [weight; element] of each side
  // (with the TMA rounded up to the 1024-byte alignment of its
  // destinations)
  static constexpr int STAGE0 =
      2 * (S1 + S2) + (int)sizeof(float) * 2 * (NE1 + NE);
  static constexpr int STAGE = TMA ? (STAGE0 + 1023) & ~1023 : STAGE0;
  static constexpr int STAGES = TMA ? 3 : 4;
  // the ring, then with the TMA a full barrier a stage; ALIGN bytes ahead
  // of it to align it
  static constexpr int RING = STAGES * STAGE + (TMA ? 8 * STAGES : 0);
  static constexpr int ALIGN = TMA ? 1024 : 0;
  static_assert(GM * 4 / WN == NT / 32, "one warp per WN products");
};

// Four (two) 8 x 8 b16 matrices from shared memory, lane l giving the
// address of row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const uint16_t* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"((unsigned)__cvta_generic_to_shared(p)));
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const uint16_t* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"((unsigned)__cvta_generic_to_shared(p)));
}

// The lane's part of the staged rows its fragment loads address, and its
// offsets in them for the two k halves (computed once).  cp.async stages
// the lhs envs so that fragment row g holds env 2g of the group and row
// g + 8 env 2g + 1 (stage_rows), in rows padded to RS bf16 (80 bytes):
// the 8 consecutive rows of one ldmatrix phase fall in 8 distinct bank
// groups.  The TMA lands the envs in their order, in rows of DP bf16 (64
// bytes) whose 16-byte chunk c lies at c ^ (r / 2 % 4) (the 64-byte
// swizzle, in a stage aligned to 1024 bytes): so fragment row g is read
// from row 2g, g + 8 from 2g + 1, a B phase's 8 rows fall in 8 bank groups
// and an A phase's in 4 (a 2-way conflict); the rows a lane addresses keep
// r / 2 % 4 fixed (A: lane % 4, B: lane / 2 % 4), and the second k half's
// chunks are the first's xor 2.
template <bool TMA>
struct Frag {
  int arow, brow;   // the lane's row in a group of 16 lhs / 8 rhs rows
  int a, b;         // element offsets of its chunk in the first k half
  __device__ __forceinline__ explicit Frag(int lane) {
    const int h = (lane >> 3) & 1;
    arow = TMA ? 2 * (lane & 7) + h : (lane & 7) + 8 * h;
    brow = lane & 7;
    a = 8 * ((lane >> 4) ^ (TMA ? lane & 3 : 0));
    b = 8 * (h ^ (TMA ? (lane >> 1) & 3 : 0));
  }
  // the offsets in k half ks
  __device__ __forceinline__ int ak(int ks) const {
    return TMA ? a ^ (16 * ks) : a + 16 * ks;
  }
  __device__ __forceinline__ int bk(int ks) const {
    return TMA ? b ^ (16 * ks) : b + 16 * ks;
  }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int n = valid ? 16 : 0;   // 0 source bytes: zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(n)
               : "memory");
}

// cp.async: copy the NP bf16 parts of NC components of envs [e0, e0 + CB)
// of points [p0, p0 + NEX / CB) of one side into a stage, env-major, row
// (part * NC + c) * NEX + slot of RS bf16; what lies past the point or
// env count arrives as zeros.  On the lhs (PERM) side env 2g + h of each
// 16-env group goes to slot g + 8 h, the fragment row that reads it.
template <int NC, int NP, int NEX, bool PERM>
__device__ __forceinline__ void stage_rows(const uint16_t* __restrict__ X,
                                           int m, int B, int p0, int e0,
                                           uint16_t* __restrict__ s) {
  constexpr int COPIES = NP * NC * NEX * (DP / 8);   // 16-byte copies
  static_assert(COPIES % NT == 0, "whole rounds of copies");
  const long long N = (long long)m * B;
#pragma unroll
  for (int i = 0; i < COPIES / NT; ++i) {
    const int idx = threadIdx.x + i * NT;
    const int k8 = idx % (DP / 8);
    const int env = (idx / (DP / 8)) % NEX;
    const int pc = idx / (DP / 8 * NEX);   // part * NC + c
    const int p = p0 + env / CB;
    const int e = e0 + env % CB;
    const bool ok = p < m && e < B;
    const uint16_t* src =
        ok ? X + ((long long)pc * N + (long long)p * B + e) * DP + k8 * 8 : X;
    const int slot =
        PERM ? (env & ~15) | ((env & 1) << 3) | ((env & 15) >> 1) : env;
    cp_async16(s + (pc * NEX + slot) * RS + k8 * 8, src, ok);
  }
}

// One box (32 k x CB envs x points x planes) of an operand's tensor map
// at env e0, point p0 into shared memory; its bytes complete the
// transaction count of ``bar``.
__device__ __forceinline__ void tma_load4(void* dst, const CUtensorMap* map,
                                          uint64_t* bar, int e0, int p0) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(
          smem_u32(dst)),
      "l"((uint64_t)map), "r"(smem_u32(bar)), "r"(0), "r"(e0), "r"(p0),
      "r"(0)
      : "memory");
}

// G[c2][ia * 2 + ib] = X1[c1]_(lhs env 2g + ia) . X2[c2]_(rhs env 2q + ib)
// for lhs component row c1 of group ``grp`` against n-tile ``nt``: every
// (lhs part, rhs part) product into one fp32 accumulator, k halves outer,
// in the order of kff_common.cuh.  A fragment (ldmatrix.x4, lane l addressing
// fragment row (l % 8) + 8 ((l / 8) % 2), chunk l / 16 of the k half) and
// B fragment (.x2, rhs env l % 8, chunk (l / 8) % 2) of one k half at a
// time, which keeps 12 fragment registers live in bf16x4.
template <int LC, int NP, int NE1, int ROW, bool TMA>
__device__ __forceinline__ void products(const uint16_t* __restrict__ s1,
                                         const uint16_t* __restrict__ s2,
                                         int c1, int grp, int nt,
                                         const Frag<TMA>& f,
                                         float (&G)[4][4]) {
  const int arow = c1 * NE1 + grp * 16 + f.arow;
  const int brow = nt * 8 + f.brow;
#pragma unroll
  for (int c2 = 0; c2 < 4; ++c2)
#pragma unroll
    for (int i = 0; i < 4; ++i) G[c2][i] = 0.f;
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    uint32_t a[NP][4];
#pragma unroll
    for (int p = 0; p < NP; ++p)
      ldsm_x4(a[p], s1 + (p * LC * NE1 + arow) * ROW + f.ak(ks));
#pragma unroll
    for (int c2 = 0; c2 < 4; ++c2) {
      uint32_t b[NP][2];
#pragma unroll
      for (int p = 0; p < NP; ++p)
        ldsm_x2(b[p], s2 + ((p * 4 + c2) * NE + brow) * ROW + f.bk(ks));
#pragma unroll
      for (int pa = 0; pa < NP; ++pa)
#pragma unroll
        for (int pb = 0; pb < NP; ++pb) mma_bf16(G[c2], a[pa], b[pb]);
    }
  }
}

// The per-pair scalars of one env pair with weight w != 0 and product c:
// k, A and Bc of the K set (both carrying w), D = c^z and the derivative
// pieces (kff_common.cuh).
template <int KIND>
__device__ __forceinline__ void pair_coeffs(float c, float w, float sigma2,
                                            float gamma, int zeta, float& k,
                                            float& A, float& Bc, float& D,
                                            float& zd1, float& b0c) {
  float d1, dm2;
  powers(c, zeta, d1, dm2);
  D = d1 * c;
  zd1 = (float)zeta * d1;
  b0c = (float)(zeta * (zeta - 1)) * dm2;
  k = 0.f;
  if constexpr (KIND == DOT) {
    A = sigma2 * zd1 * w;
    Bc = sigma2 * b0c * w;
  } else {
    k = sigma2 * expf((D - 1.f) * gamma);
    const float kg = k * gamma;
    A = kg * zd1 * w;
    Bc = kg * (b0c + zd1 * zd1 * gamma) * w;
  }
}

// The tensor map of one side's bf16 parts, (planes, N, DP) with N = m B
// rows of DP bf16 (64 bytes): a 4-D tensor (k, env, point, plane) of
// extents (DP, B, m, planes), boxes of (DP, CB, points, planes), the
// 64-byte swizzle.  The training side of a served block keeps its map
// (tensor_map); a request's new query side is encoded at its launch.
int mma_map(const void* X, int m, int B, int planes, int points,
            CUtensorMap* map) {
  const cuuint64_t row = sizeof(uint16_t) * DP;
  const cuuint64_t dims[4] = {DP, (cuuint64_t)B, (cuuint64_t)m,
                              (cuuint64_t)planes};
  const cuuint64_t strides[3] = {row, row * B, row * B * m};
  const cuuint32_t box[4] = {DP, CB, (cuuint32_t)points,
                             (cuuint32_t)planes};
  return tensor_map(CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, X, dims, strides,
                    box, CU_TENSOR_MAP_SWIZZLE_64B, map);
}

}  // namespace
