// The k-slice forms of the tensor-core path of kff_mma.cuh, for the mode
// kernels of operands wider than one k-slice of DP (kff_rect_mma_ks.cu,
// kff_tri_mma_ks.cu): stage_rows and tma_load4 at a k offset, the
// products added to those of a pair's earlier slices (products_acc), and
// the tensor map of a side of width dp.  kff_mma.cuh itself stays as it
// was before the width was free: the one-slice kernels include it.
#pragma once

#include "kff_mma.cuh"

namespace {

// stage_rows of k-slice [k0, k0 + DP) of rows of dp bf16.
template <int NC, int NP, int NEX, bool PERM>
__device__ __forceinline__ void stage_rows(const uint16_t* __restrict__ X,
                                           int m, int B, int dp, int k0,
                                           int p0, int e0,
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
        ok ? X + ((long long)pc * N + (long long)p * B + e) * dp + k0 + k8 * 8
           : X;
    const int slot =
        PERM ? (env & ~15) | ((env & 1) << 3) | ((env & 15) >> 1) : env;
    cp_async16(s + (pc * NEX + slot) * RS + k8 * 8, src, ok);
  }
}

// tma_load4 of the box at k k0.
__device__ __forceinline__ void tma_load4(void* dst, const CUtensorMap* map,
                                          uint64_t* bar, int k0, int e0,
                                          int p0) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(
          smem_u32(dst)),
      "l"((uint64_t)map), "r"(smem_u32(bar)), "r"(k0), "r"(e0), "r"(p0),
      "r"(0)
      : "memory");
}

// products added to G: the products of a chunk pair's earlier k-slices.
template <int LC, int NP, int NE1, int ROW, bool TMA>
__device__ __forceinline__ void products_acc(const uint16_t* __restrict__ s1,
                                             const uint16_t* __restrict__ s2,
                                             int c1, int grp, int nt,
                                             const Frag<TMA>& f,
                                             float (&G)[4][4]) {
  const int arow = c1 * NE1 + grp * 16 + f.arow;
  const int brow = nt * 8 + f.brow;
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

// mma_map of a side of width dp: extents (dp, B, m, planes), boxes of one
// k-slice (DP, CB, points, planes).
int mma_map(const void* X, int m, int B, int dp, int planes, int points,
            CUtensorMap* map) {
  const cuuint64_t row = sizeof(uint16_t) * (cuuint64_t)dp;
  const cuuint64_t dims[4] = {(cuuint64_t)dp, (cuuint64_t)B, (cuuint64_t)m,
                              (cuuint64_t)planes};
  const cuuint64_t strides[3] = {row, row * B, row * B * m};
  const cuuint32_t box[4] = {DP, CB, (cuuint32_t)points,
                             (cuuint32_t)planes};
  return tensor_map(CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, X, dims, strides,
                    box, CU_TENSOR_MAP_SWIZZLE_64B, map);
}

}  // namespace
