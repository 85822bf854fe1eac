// K1 (kff_tri*_ks) in highest for operands wider than one k-slice of DP =
// 32, on tri_ks_kernel<SEL, KIND>: the kernel tri_kernel (kff_tri.cu) is
// for one slice, and ops/kff.py launches these entry points for operands
// of width dp > DP.  Plain C interface, loaded with ctypes by ops/kff.py,
// which builds every source of this directory into one library;
// kff_common.cuh has the operands and the per-env-pair arithmetic.
//
// It replaces _kff_kernel_tri (kff_pallas.py:282, body _kff_body :209) at
// widths above 32, and in its tile-range form the cells= / owned= form
// (kff_pallas.py:592-596, :703-711).  The design is tri_kernel's -- the
// element skip, the TMA ring with full and empty mbarriers and no block
// barrier in the chunk loop, the 2 x 2 env micro-tile of one point pair a
// thread, the order of the sums, the upper-triangle tiles written with
// their transposes -- with the ring over (chunk pair, k-slice): the
// operand's k-major copy (ops/kff.py tri_operand) holds dp / DP blocks of
// TROWS rows, block s the rows [c][k] of slice s with the weights and
// elements behind them, so one box a side and item lands the slice's rows
// and the weights its skip reads; the dot products stay in registers from
// a pair's first slice to its last, and the coefficients and the assembly
// follow the last.  A translation unit of its own, beside the one-slice
// kernel's (kff_rect_ks.cu says why).

#include "kff_tma.cuh"

namespace {

// The TMA staging of tri_kernel (kff_tri.cu), a k-slice a stage: TROWS
// rows of the k-major copy a chunk and slice (4 DP rows [c][k], then the
// weight and the element), TSIDE floats a side (16 640 bytes), TSTAGES
// stages of both sides.
constexpr int TROWS = 4 * DP + 2;
constexpr int TSIDE = TROWS * NE;
constexpr int TSTAGES = 3;

// One box of the k-major copy (envs c0.., points c1.., rows c2..) into
// shared memory; its bytes complete the transaction count of ``bar``.
__device__ __forceinline__ void tma_load3(float* dst, const CUtensorMap* map,
                                          uint64_t* bar, int c0, int c1,
                                          int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(
          smem_u32(dst)),
      "l"((uint64_t)map), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// K1 in highest for operands of width dp: tri_kernel's tiles, skip and
// TMA ring (kff_tri.cu), the ring over (chunk pair, slice), a box of the
// slice's TROWS rows of the k-major copy (dp / DP blocks of TROWS rows,
// each with its weights and elements) a side and item, the dot products
// kept in registers from a pair's first slice to its last and the
// coefficients and the assembly of tri_kernel after it, in its order.
template <int SEL, int KIND>
__global__ void __launch_bounds__(NT, 2)
tri_ks_kernel(const __grid_constant__ CUtensorMap map,
              const float* __restrict__ re, int m, int B,
              float* __restrict__ out, float* __restrict__ outd, long long ldo,
              float sigma2, float gamma, int zeta, long long k0, int dp) {
  constexpr int NPL = 9, NS = SEL == DUAL ? 2 : 1, NOUT = NPL * NS;
  constexpr int DSET = SEL == DUAL ? NPL : 0;
  extern __shared__ __align__(16) float smem_raw[];
  // the ring first, at a 128-byte boundary (a TMA destination), then the
  // barriers and the chunk ranges
  float* const ring = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~(uintptr_t)127);
  uint64_t* const full = reinterpret_cast<uint64_t*>(
      ring + TSTAGES * 2 * TSIDE);
  uint64_t* const empty = full + TSTAGES;
  float* const rngs = reinterpret_cast<float*>(empty + TSTAGES);

  int I, J;
  tri_tile(k0 + blockIdx.x, I, J);
  const int nc = (B + CB - 1) / CB;
  // a diagonal tile: both sides are one tile, whose chunk ranges are read
  // once for both roles
  const bool one_tile = I == J;
  float* const rng1 = rngs;
  float* const rng2 = one_tile ? rng1 : rng1 + 2 * nc;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int pl = warp, ql = lane >> 2;
  const int a0 = pl * CB + ((lane >> 1) & 1) * 2;
  const int b0 = ql * CB + (lane & 1) * 2;

  for (int ch = warp; ch < (one_tile ? nc : 2 * nc); ch += NT / 32) {
    if (ch < nc)
      chunk_range<NE, CB>(re, m, B, I * TP, ch, rng1);
    else
      chunk_range<NE, CB>(re, m, B, J * TP, ch - nc, rng2);
  }
  if (t == 0) {
    for (int s = 0; s < TSTAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NT / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the next (chunk pair, k-slice) after (a, b, ks), as in rect_kernel
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
  // the producer (thread 0): its own cursor over the same chunk pairs and
  // slices, the next copy's index, and the lhs chunk slice (a ns + ks)
  // each stage holds
  int pa = 0, pb = -1, pks = ns - 1, jn = 0;
  int held[TSTAGES];
  bool phave = false;
  auto issue = [&]() {
    const int s = jn % TSTAGES;
    if (jn >= TSTAGES) mbar_wait(&empty[s], ((jn / TSTAGES) - 1) & 1);
    float* const st = ring + s * 2 * TSIDE;
    const bool lhs = held[s] != pa * ns + pks;
    mbar_expect_tx(&full[s], (lhs ? 2 : 1) * TSIDE * (uint32_t)sizeof(float));
    if (lhs) {
      tma_load3(st, &map, &full[s], pa * CB, I * TP,
                pks * TROWS);
      held[s] = pa * ns + pks;
    }
    tma_load3(st + TSIDE, &map, &full[s], pb * CB, J * TP,
              pks * TROWS);
    ++jn;
    phave = next(pa, pb, pks);
  };
  if (t == 0) {
    for (int s = 0; s < TSTAGES; ++s) held[s] = -1;
    phave = next(pa, pb, pks);
    for (int s = 0; s < TSTAGES - 1 && phave; ++s) issue();
  }

  float acc[NOUT];
#pragma unroll
  for (int i = 0; i < NOUT; ++i) acc[i] = 0.f;
  // the dot products of the 2 x 2 micro-tile, summed over the slices of
  // one chunk pair
  float G[16][4];

  int a = 0, b = -1, ks = ns - 1, it = 0;
  bool have = next(a, b, ks);
  while (have) {
    // keep TSTAGES - 1 chunk pairs in flight ahead of this one
    if (t == 0 && phave) issue();
    const int s = it % TSTAGES;
    mbar_wait(&full[s], (it / TSTAGES) & 1);
    const float* const s1 = ring + s * 2 * TSIDE;
    const float* const s2 = s1 + TSIDE;
    const float* const sw1 = s1 + 4 * DP * NE;
    const float* const se1 = sw1 + NE;
    const float* const sw2 = s2 + 4 * DP * NE;
    const float* const se2 = sw2 + NE;
    float wlo = INFINITY, whi = -INFINITY;
#pragma unroll
    for (int i = 0; i < CB; ++i) {
      const float el = se1[pl * CB + i];
      if (sw1[pl * CB + i] != 0.f) {
        wlo = fminf(wlo, el);
        whi = fmaxf(whi, el);
      }
    }
    if (!(whi < rng2[2 * b] || rng2[2 * b + 1] < wlo)) {
      if (ks == 0) {
#pragma unroll
        for (int c = 0; c < 16; ++c)
#pragma unroll
          for (int i = 0; i < 4; ++i) G[c][i] = 0.f;
      }
#pragma unroll 2
      for (int k = 0; k < DP; ++k) {
        float2 l[4], r[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          l[c] = *reinterpret_cast<const float2*>(s1 + (c * DP + k) * NE + a0);
          r[c] = *reinterpret_cast<const float2*>(s2 + (c * DP + k) * NE + b0);
        }
#pragma unroll
        for (int c1 = 0; c1 < 4; ++c1)
#pragma unroll
          for (int c2 = 0; c2 < 4; ++c2) {
            float* gc = G[c1 * 4 + c2];
            gc[0] = fmaf(l[c1].x, r[c2].x, gc[0]);
            gc[1] = fmaf(l[c1].x, r[c2].y, gc[1]);
            gc[2] = fmaf(l[c1].y, r[c2].x, gc[2]);
            gc[3] = fmaf(l[c1].y, r[c2].y, gc[3]);
          }
      }
      // the coefficients and the assembly, after the pair's last slice
      if (ks == ns - 1) {
#pragma unroll
        for (int ia = 0; ia < 2; ++ia)
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
              const float dB = Bc * Dm1 + kw * (b0c + 2.f * zd1 * zd1 * gamma);
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
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
    have = next(a, b, ks);
    ++it;
  }

#pragma unroll
  for (int i = 0; i < NOUT; ++i) {
    acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], 1);
    acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], 2);
  }
  if ((lane & 3) != 0) return;
  const int p = I * TP + pl;
  const int q = J * TP + ql;
  if (p >= m || q >= m) return;
#pragma unroll
  for (int sset = 0; sset < NS; ++sset) {
    float* __restrict__ o = sset == 0 ? out : outd;
    const int s0 = sset * NPL;
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
          const float x = acc[s0 + u * 3 + v];
          o[(long long)(3 * p + u) * ldo + 3 * p + v] = x;
          o[(long long)(3 * p + v) * ldo + 3 * p + u] = x;
        }
    }
  }
}

// 128 bytes to align the ring, the ring, 2 TSTAGES barriers
constexpr size_t tri_ring_bytes() {
  return 128 + sizeof(float) * TSTAGES * 2 * (size_t)TSIDE +
         2 * TSTAGES * sizeof(uint64_t);
}

// The tensor map of one k-major copy of ns k-slices: a 3-D float32 tensor
// (env, point, row) of extents (Bp, m, ns TROWS), boxes of one slice's
// rows (CB, TP, TROWS), no swizzle.
int tri_map(const void* Xt, int m, int Bp, int ns, CUtensorMap* map) {
  const cuuint64_t dims[3] = {(cuuint64_t)Bp, (cuuint64_t)m,
                              (cuuint64_t)ns * TROWS};
  const cuuint64_t strides[2] = {sizeof(float) * (cuuint64_t)Bp,
                                 sizeof(float) * (cuuint64_t)Bp * m};
  const cuuint32_t box[3] = {CB, TP, TROWS};
  return tensor_map(CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, Xt, dims, strides,
                    box, CU_TENSOR_MAP_SWIZZLE_NONE, map);
}

template <int SEL, int KIND>
cudaError_t init_tri_ks() {
  return smem_init(tri_ks_kernel<SEL, KIND>, tri_ring_bytes() + kRangeBytes);
}

// Tiles [k0, k0 + nk) of the upper triangle of one (m1 = m2) point set,
// with the TMA ring, its barriers and the chunk ranges.  X1 is unused,
// re1 gives the chunk ranges, X2 is the k-major copy of (X1, re1) at width
// dp (ops/kff.py tri_operand, 16-byte aligned); re2, m2, B2 must repeat
// re1, m1, B1, and the range must lie inside the triangle.  Returns the
// launch status.
template <int SEL, int KIND>
int launch_tri_ks(const float* re1, int m1, int B1, const float* X2,
                  const float* re2, int m2, int B2, float* out, float* outd,
                  float sigma2, float gamma, int zeta, long long k0,
                  long long nk, long long ldo, int trans, int dp,
                  void* stream) {
  const int nc = (B1 + CB - 1) / CB;
  const size_t ranges = sizeof(float) * 4 * (size_t)nc;
  const long long nt = tiles(m1);
  if (trans || ldo < 3LL * m1 || re2 != re1 || m2 != m1 || B2 != B1 ||
      !slices(dp) || ranges > kRangeBytes || ((uintptr_t)X2 & 15) ||
      k0 < 0 || nk < 1 || nk > 0x7fffffffLL || k0 + nk > nt * (nt + 1) / 2)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  if (tri_map(X2, m1, nc * CB, slices(dp), &map) != 0)
    return (int)cudaErrorInvalidValue;
  tri_ks_kernel<SEL, KIND>
      <<<dim3((unsigned)nk), NT, tri_ring_bytes() + ranges,
         (cudaStream_t)stream>>>(map, re1, m1, B1, out, outd, ldo, sigma2,
                                 gamma, zeta, k0, dp);
  return (int)cudaGetLastError();
}

}  // namespace

cudaError_t kff::tri_ks_init() {
  const cudaError_t rcs[] = {init_tri_ks<KONLY, RBF>(),
                             init_tri_ks<DUAL, RBF>(),
                             init_tri_ks<DERIV, RBF>(),
                             init_tri_ks<KONLY, DOT>()};
  for (cudaError_t rc : rcs)
    if (rc != cudaSuccess) return rc;
  return cudaSuccess;
}

// Entry points <name>_ks: the arguments of every entry point of the
// library (kff_common.cuh) and then the operands' width dp before the
// stream; X2 the k-major copy of (X1, re1) (dp / DP blocks of
// kff_tri_rows() rows of m1 points of B1 envs rounded up to 4), tiles [k0,
// k0 + nk) of the upper triangle and their transposes written, nothing
// else.
#define TRI_KS_ENTRY(NAME, SEL, KIND)                                       \
  int NAME##_ks(const void*, const float* re1, int m1, int B1,              \
                const void* X2, const float* re2, int m2, int B2,           \
                float* out, float* outd, float sigma2, float gamma,         \
                int zeta, long long k0, long long nk, long long ldo,        \
                int trans, int dp, void* stream) {                          \
    return launch_tri_ks<SEL, KIND>(re1, m1, B1,                            \
                                    static_cast<const float*>(X2), re2, m2, \
                                    B2, out, outd, sigma2, gamma, zeta, k0, \
                                    nk, ldo, trans, dp, stream);            \
  }

extern "C" {
TRI_KS_ENTRY(kff_tri, KONLY, RBF)
TRI_KS_ENTRY(kff_tri_dual, DUAL, RBF)
TRI_KS_ENTRY(kff_tri_deriv, DERIV, RBF)
TRI_KS_ENTRY(kff_tri_dot, KONLY, DOT)
}  // extern "C"
