// The SO(3) power-spectrum descriptor's core on the card: ops/so3.py's
// _so3_core -- the radial quadrature over the scaled Bessel functions of
// ops/bessel.py, the Y_lm and their covariant gradients of ops/sph.py,
// the per-centre sums c_nlm, the power spectrum x, its gradients dxdr with
// the translation-invariance self rows, and the strain rows -- in two
// launches, so3_pair_kernel<T> and so3_centre_kernel<T>, T float or
// double.  Plain C interface (so3_core_f32, so3_core_f64, so3_init),
// loaded with ctypes by ops/kff.py, which builds every source of this
// directory into one library; ops/so3.py's SO3._core packs the inputs
// (kernel_inputs) and launches it for tensors on a card.
//
// It replaces no TPU kernel: the JAX package's ops/so3.py is plain XLA.
// It was added because the plain version's ~1000 float64 launches bound a
// served structure: ~20 ms of host time for 1.64 ms of device work a
// request on an H100 (PERF.md).  On this card it is bound by launch
// latency, then by FP64 CUDA-core arithmetic: the Bessel recurrences (a
// division a step, 50 steps at lmax 4 below the switch) and exponentials
// at every quadrature node of every pair.  The design:
//  * so3_pair_kernel, one block a pair: the Legendre rows (a thread an
//    order m, each column's recurrence in l its own), cos / sin(m phi),
//    then the nodes in chunks of `ch` (a thread a node: E, b_l, db_l into
//    shared memory), each chunk reduced against G0 into I and dI/dr (a
//    thread an output, adding the nodes in order); it writes one record a
//    pair: a_nl = 4 pi w f_cut I_nl norm_l, bb_nl = 4 pi w norm_l (f_cut
//    dI_nl/dr + f_cut' I_nl), Y_lm and dY_lm/dr for m >= 0 (Y_l^-m =
//    (-1)^m conj(Y_l^m)), so c_nlm = a_nl Y_lm and dc_nlm = a_nl dY_lm +
//    bb_nl u Y_lm never reach device memory.  At the served structure the
//    records (352 pairs x 150 doubles) stay in L2.
//  * so3_centre_kernel, one block a centre atom: c_tot summed over the
//    centre's pairs in ascending pair order (the CSR of a stable argsort
//    by centre) into shared memory, x from it; then for each of the
//    centre's pairs in that order G_kld = sum_m dY_lmd . c_tot,klm and
//    H_kl = sum_m Y_lm . c_tot,klm (m < 0 as twice m > 0), dP = A_nk +
//    A_kn with A_nkld = a_nl G_kld + bb_nl u_d H_kl, added into the pair's
//    dxdr row (and R_j dP into its strain row, R_i dP into the centre's
//    sum); last the self rows: minus the sum of the centre's rows, in row
//    order.  A thread owns the same (coefficient, direction) entries of
//    every row from the zeroing to the self rows, so every sum is added in
//    one fixed order, with no atomics and no barrier between a thread's
//    read-modify-writes: repeats are bit for bit.
//  * The outputs go straight into SO3.calculate_device's layout: each
//    structure's dxdr (and rdxdr) rows followed by its zero pad row, which
//    the block of the structure's first atom writes.

#include <cuda_runtime.h>

namespace {

constexpr int NT_PAIR = 128;
constexpr int NT_CENTRE = 128;
constexpr double PI = 3.14159265358979323846;
// the pair kernel's node chunk is halved from NT_PAIR while its shared
// memory exceeds this
constexpr size_t PAIR_SMEM_CAP = 40 * 1024;

__device__ __forceinline__ double m_exp(double v) { return exp(v); }
__device__ __forceinline__ float m_exp(float v) { return expf(v); }
__device__ __forceinline__ double m_expm1(double v) { return expm1(v); }
__device__ __forceinline__ float m_expm1(float v) { return expm1f(v); }
__device__ __forceinline__ double m_sqrt(double v) { return sqrt(v); }
__device__ __forceinline__ float m_sqrt(float v) { return sqrtf(v); }
__device__ __forceinline__ double m_cos(double v) { return cos(v); }
__device__ __forceinline__ float m_cos(float v) { return cosf(v); }
__device__ __forceinline__ double m_sin(double v) { return sin(v); }
__device__ __forceinline__ float m_sin(float v) { return sinf(v); }
__device__ __forceinline__ double m_atan2(double y, double x) {
  return atan2(y, x);
}
__device__ __forceinline__ float m_atan2(float y, float x) {
  return atan2f(y, x);
}
__device__ __forceinline__ double m_abs(double v) { return fabs(v); }
__device__ __forceinline__ float m_abs(float v) { return fabsf(v); }

// ops/bessel.py's constants: float32 keeps every intermediate inside its
// exponent range (narrow Miller seeds, a wider small-z guard)
template <typename T> struct Limits;
template <> struct Limits<double> {
  __device__ static double tiny() { return 1e-280; }
  __device__ static double big() { return 1e250; }
  __device__ static double small() { return 1e-250; }
  __device__ static double z_cut() { return 1e-12; }
  __device__ static double b1_cut() { return 0.02; }
};
template <> struct Limits<float> {
  __device__ static float tiny() { return 1e-30f; }
  __device__ static float big() { return 1e30f; }
  __device__ static float small() { return 1e-30f; }
  __device__ static float z_cut() { return 1e-6f; }
  __device__ static float b1_cut() { return 0.3f; }
};

// the row l of a packed lower-triangle index lm = l (l + 1) / 2 + m,
// 0 <= m <= l: (l, m >= 0) of Y_lm, and (n1, n2 <= n1) of the radial pairs
__device__ __forceinline__ int row_of(int lm) {
  int l = (int)((sqrt(8.0 * lm + 1.0) - 1.0) * 0.5);
  while ((l + 1) * (l + 2) / 2 <= lm) ++l;
  while (l * (l + 1) / 2 > lm) --l;
  return l;
}

// b0 = e^-z i_0(z), b1 = e^-z i_1(z) (bessel.py _b01)
template <typename T>
__device__ void b01(T z, T& b0, T& b1) {
  const T em = m_exp(T(-2.0) * z);
  b0 = -m_expm1(T(-2.0) * z) / (T(2.0) * z);
  const T b1f = (z * (T(1.0) + em) - (T(1.0) - em)) / (T(2.0) * z * z);
  const T z2 = z * z;
  const T b1s = z / T(3.0) * (T(1.0) - z + T(0.6) * z2
                              - T(4.0 / 15.0) * z2 * z
                              + T(2.0 / 21.0) * z2 * z2);
  b1 = z < Limits<T>::b1_cut() ? b1s : b1f;
}

// b_l = e^-z i_l(z) and db_l = e^-z i_l'(z), l = 0..lmax, into b[l st] and
// db[l st]: bessel.py's scaled_in for one z -- upward from the closed forms
// at z >= 2 lmax + 2, Miller's downward recurrence from 2 lmax + 42 below,
// the z -> 0 limits under z_cut
template <typename T>
__device__ void scaled_in(int lmax, T z, T* b, T* db, int st) {
  if (z < Limits<T>::z_cut()) {
    const T b1 = z / T(3.0) * (T(1.0) - z);
    for (int l = 0; l <= lmax; ++l) {
      b[l * st] = l == 0 ? T(1.0) - z
                  : l == 1 ? b1 : l == 2 ? z * z / T(15.0) : T(0.0);
      db[l * st] = l == 0 ? b1
                   : l == 1 ? (T(1.0) - z) / T(3.0)
                   : l == 2 ? T(2.0) * z / T(15.0) : T(0.0);
    }
    return;
  }
  const int z_switch = 2 * lmax + 2;
  T b0, b1;
  b01(z, b0, b1);
  if (z >= T(z_switch)) {
    b[0] = b0;
    if (lmax >= 1) b[st] = b1;
    T prev = b0, cur = b1;
    for (int l = 1; l < lmax; ++l) {
      const T next = prev - T(2 * l + 1) / z * cur;
      b[(l + 1) * st] = next;
      prev = cur;
      cur = next;
    }
  } else {
    T fp = T(0.0), fc = Limits<T>::tiny();
    for (int l = z_switch + 40; l > 0; --l) {
      const T fm = fp + T(2 * l + 1) / z * fc;
      if (l - 1 <= lmax) b[(l - 1) * st] = fm;
      fp = fc;
      fc = fm;
      if (m_abs(fm) > Limits<T>::big()) {
        // keep the unnormalised sequence in range
        fp *= Limits<T>::small();
        fc *= Limits<T>::small();
        for (int k = l - 1; k <= lmax; ++k) b[k * st] *= Limits<T>::small();
      }
    }
    const T s = b0 / b[0];
    for (int l = 0; l <= lmax; ++l) b[l * st] *= s;
  }
  if (lmax >= 1) {
    db[0] = b[st];
    for (int l = 1; l <= lmax; ++l)
      db[l * st] = b[(l - 1) * st] - T(l + 1) / z * b[l * st];
  } else {
    db[0] = b1;
  }
}

// Y_{l'}^{m'} (re, im) from the Legendre rows and cos / sin(m phi) of
// m >= 0, for any m' (zero for |m'| > l')
template <typename T>
__device__ __forceinline__ void y_ext(const T* sP, const T* sCos,
                                      const T* sSin, int l, int m, T& re,
                                      T& im) {
  const int k = m < 0 ? -m : m;
  if (k > l) {
    re = T(0.0);
    im = T(0.0);
    return;
  }
  const T p = sP[l * (l + 1) / 2 + k];
  re = p * sCos[k];
  im = p * sSin[k];
  if (m < 0) {
    const T sign = (k & 1) ? T(-1.0) : T(1.0);
    re = sign * re;
    im = -sign * im;
  }
}

// One block a pair: the pair record (header comment).  Record layout:
// a (nmax, lmax+1), [bb (nmax, lmax+1)], Yre (LM), Yim (LM), [dYre (3,
// LM), dYim (3, LM)], the bracketed parts with derivatives; LM = (lmax+1)
// (lmax+2) / 2 entries (l, m >= 0).
template <typename T>
__global__ void __launch_bounds__(NT_PAIR)
so3_pair_kernel(const T* __restrict__ rij, const T* __restrict__ w,
                const T* __restrict__ q, const T* __restrict__ G0,
                T* __restrict__ rec, int nq, int nmax, int lmax, int ch,
                int deriv, double rcut, double alpha) {
  extern __shared__ __align__(16) unsigned char so3_smem[];
  T* smem = reinterpret_cast<T*>(so3_smem);
  const int L1 = lmax + 1, LM = L1 * (L1 + 1) / 2, NL = nmax * L1;
  const int nrow = deriv ? lmax + 2 : lmax + 1;  // Legendre rows 0..nrow-1
  T* sP = smem;
  T* sCos = sP + nrow * (nrow + 1) / 2;
  T* sSin = sCos + nrow;
  T* sAcc = sSin + nrow;                   // I, [dI/dr]: (nmax, lmax+1)
  T* sB = sAcc + (1 + deriv) * NL;         // (lmax+1, ch): E b
  T* sD = sB + L1 * ch;                    // (lmax+1, ch): d(E b)/dr
  const int p = blockIdx.x, tid = threadIdx.x;
  const T rx = rij[3 * p], ry = rij[3 * p + 1], rz = rij[3 * p + 2];
  const T r = m_sqrt(rx * rx + ry * ry + rz * rz);
  const T ux = rx / r, uy = ry / r, uz = rz / r;

  // Legendre column m, each row with the full Y_lm normalisation
  // (sph.py _legendre_rows), and the azimuthal phases
  if (tid < nrow) {
    const int m = tid;
    const T ct = uz, st = m_sqrt(ux * ux + uy * uy);
    T d = T(1.0 / sqrt(4.0 * PI));
    for (int k = 1; k <= m; ++k)
      d = T(-sqrt((2 * k + 1) / (2.0 * k))) * st * d;
    sP[m * (m + 1) / 2 + m] = d;
    if (m + 1 < nrow) {
      T p2 = d, p1 = T(sqrt(2.0 * m + 3.0)) * ct * d;
      sP[(m + 1) * (m + 2) / 2 + m] = p1;
      for (int l = m + 2; l < nrow; ++l) {
        const double a = sqrt((4.0 * l * l - 1.0)
                              / ((double)l * l - (double)m * m));
        const double b = sqrt(((l - 1.0) * (l - 1.0) - (double)m * m)
                              / (4.0 * (l - 1.0) * (l - 1.0) - 1.0));
        const T v = T(a) * (ct * p1) - T(a * b) * p2;
        sP[l * (l + 1) / 2 + m] = v;
        p2 = p1;
        p1 = v;
      }
    }
    const T mphi = m_atan2(uy, ux) * T(m);
    sCos[m] = m_cos(mphi);
    sSin[m] = m_sin(mphi);
  }

  // radial integrals I[n, l] = sum_j G0[n, j] E_j b_l(z_j), and dI/dr
  const int nout = (1 + deriv) * NL;
  for (int o = tid; o < nout; o += NT_PAIR) sAcc[o] = T(0.0);
  const T two_alpha = T(2.0 * alpha), neg_alpha = T(-alpha);
  for (int base = 0; base < nq; base += ch) {
    const int node = base + tid;
    if (tid < ch && node < nq) {
      const T qj = q[node];
      const T diff = r - qj;
      const T E = m_exp(neg_alpha * (diff * diff));
      scaled_in<T>(lmax, two_alpha * r * qj, sB + tid, sD + tid, ch);
      for (int l = 0; l < L1; ++l) {
        const T bl = sB[l * ch + tid];
        if (deriv)
          sD[l * ch + tid] = E * (two_alpha * qj * sD[l * ch + tid]
                                  - two_alpha * r * bl);
        sB[l * ch + tid] = E * bl;
      }
    }
    __syncthreads();
    const int cnt = min(ch, nq - base);
    for (int o = tid; o < nout; o += NT_PAIR) {
      const int which = o / NL, n = (o % NL) / L1, l = o % L1;
      const T* src = (which ? sD : sB) + l * ch;
      const T* g = G0 + (size_t)n * nq + base;
      T acc = sAcc[o];
      for (int k = 0; k < cnt; ++k) acc += g[k] * src[k];
      sAcc[o] = acc;
    }
    __syncthreads();
  }

  const int rlen = deriv ? 2 * NL + 8 * LM : NL + 2 * LM;
  T* out = rec + (size_t)p * rlen;
  const T wp = w[p];
  const T arg = T(PI) * r / T(rcut);
  const T fc = T(0.5) * (m_cos(arg) + T(1.0));
  const T dfc = T(-0.5 * PI / rcut) * m_sin(arg);
  const T fourpi = T(4.0 * PI);
  for (int o = tid; o < NL; o += NT_PAIR) {
    const int l = o % L1;
    const T norm = m_sqrt(T(2.0 * sqrt(2.0) * PI) / m_sqrt(T(2 * l + 1)));
    const T I = sAcc[o];
    out[o] = fourpi * (wp * fc) * I * norm;
    if (deriv)
      out[NL + o] = norm * (fourpi * wp) * (fc * sAcc[NL + o] + dfc * I);
  }
  T* Yre = out + (1 + deriv) * NL;
  T* Yim = Yre + LM;
  for (int e = tid; e < LM; e += NT_PAIR) {
    const int l = row_of(e), m = e - l * (l + 1) / 2;
    Yre[e] = sP[e] * sCos[m];
    Yim[e] = sP[e] * sSin[m];
  }
  if (!deriv) return;

  // Cartesian gradients of Y_lm, the covariant-component recurrence of
  // sph.py ylm_gradients_ri, from the rows l - 1 and l + 1
  T* dYre = Yim + LM;
  T* dYim = dYre + 3 * LM;
  const T inv_r = T(1.0) / r;
  const T s2 = T(1.0 / sqrt(2.0));
  for (int e = tid; e < LM; e += NT_PAIR) {
    const int l = row_of(e), m = e - l * (l + 1) / 2;
    if (l == 0) {
      for (int d = 0; d < 3; ++d) {
        dYre[d * LM + e] = T(0.0);
        dYim[d * LM + e] = T(0.0);
      }
      continue;
    }
    const double dl = l, dm = m;
    const bool in_l = m <= l;
    const double c0a = in_l ? -dl * sqrt(fmax((dl + 1) * (dl + 1) - dm * dm,
                                              0.0)
                                         / ((2 * dl + 1) * (2 * dl + 3)))
                            : 0.0;
    const double c0b = m <= l - 1
        ? (dl + 1) * sqrt((dl * dl - dm * dm)
                          / ((2 * dl - 1.0) * (2 * dl + 1))) : 0.0;
    const double cpa = in_l ? -dl * sqrt(fmax((dl + dm + 1) * (dl + dm + 2),
                                              0.0)
                                         / (2.0 * (2 * dl + 1)
                                            * (2 * dl + 3)))
                            : 0.0;
    const double cpb = m + 1 <= l - 1
        ? -(dl + 1) * sqrt((dl - dm - 1) * (dl - dm)
                           / (2.0 * (2 * dl - 1) * (2 * dl + 1))) : 0.0;
    const double cma = in_l ? -dl * sqrt(fmax((dl - dm + 1) * (dl - dm + 2),
                                              0.0)
                                         / (2.0 * (2 * dl + 1)
                                            * (2 * dl + 3)))
                            : 0.0;
    const double cmb = (m - 1 <= l - 1 && 1 - m <= l - 1)
        ? -(dl + 1) * sqrt((dl + dm - 1) * (dl + dm)
                           / (2.0 * (2 * dl - 1) * (2 * dl + 1))) : 0.0;
    T pr[3], pi[3], mr[3], mi[3];   // Y_{l+1}, Y_{l-1} at m-1, m, m+1
    for (int k = 0; k < 3; ++k) {
      y_ext(sP, sCos, sSin, l + 1, m - 1 + k, pr[k], pi[k]);
      y_ext(sP, sCos, sSin, l - 1, m - 1 + k, mr[k], mi[k]);
    }
    const T x0r = (T(c0a) * pr[1] + T(c0b) * mr[1]) * inv_r;
    const T x0i = (T(c0a) * pi[1] + T(c0b) * mi[1]) * inv_r;
    const T xpr = (T(cpa) * pr[2] + T(cpb) * mr[2]) * inv_r;
    const T xpi = (T(cpa) * pi[2] + T(cpb) * mi[2]) * inv_r;
    const T xmr = (T(cma) * pr[0] + T(cmb) * mr[0]) * inv_r;
    const T xmi = (T(cma) * pi[0] + T(cmb) * mi[0]) * inv_r;
    dYre[e] = s2 * (xmr - xpr);
    dYre[LM + e] = -(s2 * (xmi + xpi));
    dYre[2 * LM + e] = x0r;
    dYim[e] = s2 * (xmi - xpi);
    dYim[LM + e] = s2 * (xmr + xpr);
    dYim[2 * LM + e] = x0i;
  }
}

// One block a centre atom (header comment).  rows: the output rows of
// each centre [rbeg, rend), its self row and the pad row it zeroes (-1:
// none), four arrays of natoms.
template <typename T>
__global__ void __launch_bounds__(NT_CENTRE)
so3_centre_kernel(const long long* __restrict__ perm,
                  const long long* __restrict__ poff,
                  const long long* __restrict__ prow,
                  const long long* __restrict__ rows,
                  const T* __restrict__ rij, const T* __restrict__ Ri,
                  const T* __restrict__ Rj, const T* __restrict__ scale,
                  const T* __restrict__ rec, T* __restrict__ x,
                  T* __restrict__ dxdr, T* __restrict__ rdxdr,
                  T* __restrict__ rdpi, int natoms, int nmax, int lmax,
                  int deriv, int stress) {
  extern __shared__ __align__(16) unsigned char so3_smem[];
  T* smem = reinterpret_cast<T*>(so3_smem);
  const int L1 = lmax + 1, LM = L1 * (L1 + 1) / 2, NL = nmax * L1;
  const int ncoef = nmax * (nmax + 1) / 2 * L1;
  const int rlen = deriv ? 2 * NL + 8 * LM : NL + 2 * LM;
  const int yoff = deriv ? 2 * NL : NL;
  T* ctre = smem;               // (nmax, LM)
  T* ctim = ctre + nmax * LM;
  T* sGH = ctim + nmax * LM;    // (nmax, lmax+1, 4): G_x, G_y, G_z, H
  const int a = blockIdx.x, tid = threadIdx.x;
  const long long k0 = poff[a], k1 = poff[a + 1];

  // c_tot over the centre's pairs, in ascending pair order
  for (int e = tid; e < nmax * LM; e += NT_CENTRE) {
    const int n = e / LM, lm = e % LM, l = row_of(lm);
    T re = T(0.0), im = T(0.0);
    for (long long k = k0; k < k1; ++k) {
      const T* rp = rec + (size_t)perm[k] * rlen;
      const T av = rp[n * L1 + l];
      re += av * rp[yoff + lm];
      im += av * rp[yoff + LM + lm];
    }
    ctre[e] = re;
    ctim[e] = im;
  }
  __syncthreads();

  // x[a, (n1 n2) l] = sum_m Re c_n1lm conj(c_n2lm) over m = -l..l
  for (int c = tid; c < ncoef; c += NT_CENTRE) {
    const int n1 = row_of(c / L1), n2 = c / L1 - n1 * (n1 + 1) / 2;
    const int l = c % L1, b0 = l * (l + 1) / 2;
    const T* r1 = ctre + n1 * LM + b0;
    const T* r2 = ctre + n2 * LM + b0;
    const T* i1 = ctim + n1 * LM + b0;
    const T* i2 = ctim + n2 * LM + b0;
    T hre = T(0.0), him = T(0.0);
    for (int m = 1; m <= l; ++m) {
      hre += r1[m] * r2[m];
      him += i1[m] * i2[m];
    }
    x[(size_t)a * ncoef + c] = (r1[0] * r2[0] + T(2.0) * hre)
                               + (i1[0] * i2[0] + T(2.0) * him);
  }
  if (!deriv) return;

  const int nE = ncoef * 3;
  const long long rb = rows[a], re_ = rows[natoms + a];
  const long long srow = rows[2 * natoms + a], pad = rows[3 * natoms + a];
  if (pad >= 0) {
    for (int e = tid; e < nE; e += NT_CENTRE) dxdr[pad * nE + e] = T(0.0);
    if (stress)
      for (int e = tid; e < 3 * nE; e += NT_CENTRE)
        rdxdr[pad * 3 * nE + e] = T(0.0);
  }
  if (rb == re_) return;        // a centre outside the selection
  for (int e = tid; e < nE; e += NT_CENTRE) {
    for (long long s = rb; s < re_; ++s) dxdr[s * nE + e] = T(0.0);
    if (stress) {
      const int c = e / 3, d = e % 3;
      for (int nn = 0; nn < 3; ++nn) {
        for (long long s = rb; s < re_; ++s)
          rdxdr[(s * ncoef + c) * 9 + nn * 3 + d] = T(0.0);
        rdpi[((size_t)a * ncoef + c) * 9 + nn * 3 + d] = T(0.0);
      }
    }
  }

  for (long long k = k0; k < k1; ++k) {
    const long long p = perm[k], row = prow[p];
    if (row < 0) continue;
    const T* rp = rec + (size_t)p * rlen;
    const T* av = rp;
    const T* bb = rp + NL;
    const T* Yre = rp + yoff;
    const T* Yim = Yre + LM;
    const T* dYre = Yim + LM;
    const T* dYim = dYre + 3 * LM;
    for (int g = tid; g < NL * 4; g += NT_CENTRE) {
      const int kk = g / (L1 * 4), l = (g / 4) % L1, comp = g % 4;
      const T* vr = comp < 3 ? dYre + comp * LM : Yre;
      const T* vi = comp < 3 ? dYim + comp * LM : Yim;
      const int b0 = l * (l + 1) / 2;
      const T* cr = ctre + kk * LM + b0;
      const T* ci = ctim + kk * LM + b0;
      T h = T(0.0);
      for (int m = 1; m <= l; ++m) h += vr[b0 + m] * cr[m] + vi[b0 + m] * ci[m];
      sGH[g] = (vr[b0] * cr[0] + vi[b0] * ci[0]) + T(2.0) * h;
    }
    __syncthreads();
    const T rx = rij[3 * p], ry = rij[3 * p + 1], rz = rij[3 * p + 2];
    const T r = m_sqrt(rx * rx + ry * ry + rz * rz);
    const T u[3] = {rx / r, ry / r, rz / r};
    for (int e = tid; e < nE; e += NT_CENTRE) {
      const int c = e / 3, d = e % 3, l = c % L1;
      const int n1 = row_of(c / L1), n2 = c / L1 - n1 * (n1 + 1) / 2;
      const T* g1 = sGH + (n1 * L1 + l) * 4;
      const T* g2 = sGH + (n2 * L1 + l) * 4;
      const T a12 = av[n1 * L1 + l] * g2[d] + bb[n1 * L1 + l] * u[d] * g2[3];
      const T a21 = av[n2 * L1 + l] * g1[d] + bb[n2 * L1 + l] * u[d] * g1[3];
      const T dP = a12 + a21;
      dxdr[row * nE + e] += dP;
      if (stress) {
        for (int nn = 0; nn < 3; ++nn) {
          rdxdr[(row * ncoef + c) * 9 + nn * 3 + d] += Rj[3 * p + nn] * dP;
          rdpi[((size_t)a * ncoef + c) * 9 + nn * 3 + d] +=
              Ri[3 * p + nn] * dP;
        }
      }
    }
    __syncthreads();
  }

  // the self row: minus the sum of the centre's rows, in row order; the
  // strain rows -(their sum) (the self row's plus the centre's R_i dP sum)
  // times -1 / volume
  for (int e = tid; e < nE; e += NT_CENTRE) {
    T tot = T(0.0);
    for (long long s = rb; s < re_; ++s) tot += dxdr[s * nE + e];
    if (srow >= 0) dxdr[srow * nE + e] = dxdr[srow * nE + e] + (-tot);
    if (stress) {
      const int c = e / 3, d = e % 3;
      const T sc = scale[a];
      for (int nn = 0; nn < 3; ++nn) {
        for (long long s = rb; s < re_; ++s) {
          const long long i = (s * ncoef + c) * 9 + nn * 3 + d;
          T v = -rdxdr[i];
          if (s == srow) v = v + rdpi[((size_t)a * ncoef + c) * 9 + nn * 3 + d];
          rdxdr[i] = v * sc;
        }
      }
    }
  }
}

template <typename T>
size_t pair_smem(int nmax, int lmax, int deriv, int ch) {
  const int nrow = deriv ? lmax + 2 : lmax + 1;
  return sizeof(T) * (size_t)(nrow * (nrow + 1) / 2 + 2 * nrow
                              + (1 + deriv) * nmax * (lmax + 1)
                              + 2 * (lmax + 1) * ch);
}

template <typename T>
size_t centre_smem(int nmax, int lmax) {
  const int L1 = lmax + 1;
  return sizeof(T) * (size_t)(2 * nmax * L1 * (L1 + 1) / 2
                              + 4 * nmax * L1);
}

template <typename T>
int so3_core(const long long* perm, const long long* poff,
             const long long* prow, const long long* rows, const T* rij,
             const T* w, const T* Ri, const T* Rj, const T* scale,
             const T* q, const T* G0, T* rec, T* rdpi, T* x, T* dxdr,
             T* rdxdr, int P, int natoms, int nq, int nmax, int lmax,
             int deriv, int stress, double rcut, double alpha,
             cudaStream_t stream) {
  int ch = NT_PAIR;
  while (ch > 32 && pair_smem<T>(nmax, lmax, deriv, ch) > PAIR_SMEM_CAP)
    ch /= 2;
  if (P > 0) {
    so3_pair_kernel<T><<<P, NT_PAIR, pair_smem<T>(nmax, lmax, deriv, ch),
                         stream>>>(rij, w, q, G0, rec, nq, nmax, lmax, ch,
                                   deriv, rcut, alpha);
    const cudaError_t rc = cudaGetLastError();
    if (rc != cudaSuccess) return (int)rc;
  }
  so3_centre_kernel<T><<<natoms, NT_CENTRE, centre_smem<T>(nmax, lmax),
                         stream>>>(perm, poff, prow, rows, rij, Ri, Rj, scale,
                                   rec, x, dxdr, rdxdr, rdpi, natoms, nmax,
                                   lmax, deriv, stress);
  return (int)cudaGetLastError();
}

// the pair kernel stays under PAIR_SMEM_CAP, below the 48 KB default;
// only the centre kernel can need more
template <typename T>
cudaError_t so3_attributes(int bytes) {
  cudaFuncSetAttribute(so3_centre_kernel<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  return cudaGetLastError();
}

}  // namespace

#define SO3_ARGS(T)                                                         \
  const long long *perm, const long long *poff, const long long *prow,      \
      const long long *rows, const T *rij, const T *w, const T *Ri,         \
      const T *Rj, const T *scale, const T *q, const T *G0, T *rec,         \
      T *rdpi, T *x, T *dxdr, T *rdxdr, int P, int natoms, int nq,          \
      int nmax, int lmax, int deriv, int stress, double rcut, double alpha, \
      void *stream
#define SO3_CALL(T)                                                         \
  so3_core<T>(perm, poff, prow, rows, rij, w, Ri, Rj, scale, q, G0, rec,    \
              rdpi, x, dxdr, rdxdr, P, natoms, nq, nmax, lmax, deriv,       \
              stress, rcut, alpha, (cudaStream_t)stream)

extern "C" {
int so3_core_f32(SO3_ARGS(float)) { return SO3_CALL(float); }
int so3_core_f64(SO3_ARGS(double)) { return SO3_CALL(double); }

// the centre kernel's dynamic shared memory up to the card's opt-in limit
// (its c_tot takes 110 KB at nmax 11, lmax 32 in float64):
// once per card, before its first launch
int so3_init() {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  cudaError_t rc = so3_attributes<float>(optin);
  if (rc == cudaSuccess) rc = so3_attributes<double>(optin);
  return (int)rc;
}
}  // extern "C"
