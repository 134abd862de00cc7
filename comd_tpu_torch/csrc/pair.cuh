// Pair arithmetic shared by the pair kernels of this package: the
// cell-stencil sweeps (stencil.cu, K1/K2) and the neighbor-list kernels
// (nl.cu, NL1/NL2) test r2 rounded product by product by dist2, and K1, K2
// and NL2 evaluate every pair inside the cutoff with the same pair_eval.
// Also the staging helpers they share: the 16-byte record and cp.async.
//
// Evaluators (EVAL): 0 the shared-basis Chebyshev fit (EAM); 1 the
// quadratic interpolation of a table, the EAM phi/rho tables or, for LJ,
// the -I table of 4 eps (r6 (r6 - 1) - e_shift) (comd_tpu's
// lj_force_interp, gpu_utility.c:348-374); 2 the cubic spline in r2 of
// -P (gpu_common.h:95-129), EAM only.  LJ's EVAL 0 is the analytic pair.
//
// ops/cuda/nvcc.py hashes this header with every source that includes
// it, so a change here rebuilds them all.

#pragma once

#include <cuda_runtime.h>

constexpr int kMaxCheb = 40;    // coefficient slots per Chebyshev output


// Host-side parameters of the C interface (global scope: the extern "C"
// entry point takes pointers to them), doubles as the fit produced them.
// Slots of c: 0 phi value, 1 phi derivative, 2 rho value, 3 rho
// derivative; zero padded past each table's own length (exact:
// |T_k(t)| <= 1).
struct ChebParams {
  int transform;   // 0: w = u, 1: w = 1/u, 2: w = log u
  int n_terms;     // recurrence length for this pass's outputs
  double u_lo, u_hi, w_mid, w_scale;
  double c[4][kMaxCheb];
};

struct TableParams {
  int n;
  double x0, inv_dx;
  const void* phi;   // [n+4] device arrays of the kernel's precision
  const void* rho;
};

struct LjParams {
  double s6, eps4, e_shift;   // sigma^6, 4 epsilon, the cutoff shift
};

// The -P spline tables of phi and rho on one grid: n intervals, r in
// [x0, xn], interval floor(r inv_dx - x0_inv_dx) with x0_inv_dx the
// product x0 inv_dx taken in double (comd_tpu rounds it once, as a
// Python-float product), coefficients [n, 4] (a, b, c, d) of the kernel's
// precision, one 16-byte record an interval (32 in double).
struct SplineParams {
  int n;
  double x0, xn, inv_dx, x0_inv_dx;
  const void* phi;
  const void* rho;
};

namespace {

enum Pair { kEam1 = 0, kEam3 = 1, kLj = 2 };

// scalar outputs per pair function
template <int PAIR, bool ENERGY>
__host__ __device__ constexpr int n_scalars() {
  return PAIR == kEam1 ? (ENERGY ? 2 : 1) : (PAIR == kLj && ENERGY ? 1 : 0);
}

// The same parameters rounded once to the kernel's precision, passed by
// value (kernel parameter space), as comd_tpu rounds its trace constants.
template <typename T>
struct Cheb {
  int transform, n_terms;
  T u_lo, u_hi, w_mid, w_scale;
  T c[4][kMaxCheb];
};

template <typename T>
struct Table {
  int n;
  T x0, inv_dx;
  const T* phi;
  const T* rho;
};

template <typename T>
struct Lj {
  T s6, eps4, e_shift;
};

// One staged record: a position and, in EAM pass 3, dfEmbed (w; unused
// otherwise), so that a read is one 16-byte shared load (two for double).
template <typename T>
struct alignas(4 * sizeof(T)) Rec {
  T x, y, z, w;
};

template <typename T>
struct Spline {
  int n;
  T x0, xn, inv_dx, x0_inv_dx;
  const Rec<T>* phi;   // [n] records (a, b, c, d)
  const Rec<T>* rho;
};

// cp.async of one 4- or 8-byte value from global to shared memory
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void copy_async(double* dst, const double* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void copy_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

template <typename T>
__device__ __forceinline__ T dev_log(T x);
template <>
__device__ __forceinline__ float dev_log<float>(float x) { return logf(x); }
template <>
__device__ __forceinline__ double dev_log<double>(double x) { return log(x); }

template <typename T>
__device__ __forceinline__ T dev_sqrt(T x);
template <>
__device__ __forceinline__ float dev_sqrt<float>(float x) { return sqrtf(x); }
template <>
__device__ __forceinline__ double dev_sqrt<double>(double x) {
  return sqrt(x);
}

template <typename T>
__device__ __forceinline__ T dev_floor(T x);
template <>
__device__ __forceinline__ float dev_floor<float>(float x) {
  return floorf(x);
}
template <>
__device__ __forceinline__ double dev_floor<double>(double x) {
  return floor(x);
}

// r2 = (dx*dx + dy*dy) + dz*dz with every product and sum rounded on its
// own (no FMA contraction), exactly as the plain version computes it: the
// cutoff mask then selects the same pairs, and a pair within an ulp of the
// cutoff cannot flip in or out (rho' and the LJ force are not zero there).
__device__ __forceinline__ float dist2(float dx, float dy, float dz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}
__device__ __forceinline__ double dist2(double dx, double dy, double dz) {
  return __dadd_rn(__dadd_rn(__dmul_rn(dx, dx), __dmul_rn(dy, dy)),
                   __dmul_rn(dz, dz));
}

// One IEEE operation, rounded on its own: never contracted into an FMA.
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}

// The spline interval of r2 (comd_tpu's interpolate_spline): r = sqrt(r2)
// clipped to [x0, xn], floor(r inv_dx - x0_inv_dx) with the product and
// the difference rounded on their own, clipped to [0, n - 1].
template <typename T>
__device__ __forceinline__ int spline_index(const Spline<T>& sp, T r2) {
  T r = dev_sqrt<T>(r2);
  r = r < sp.x0 ? sp.x0 : r;
  r = r > sp.xn ? sp.xn : r;
  int k = static_cast<int>(
      dev_floor<T>(sub_rn(mul_rn(r, sp.inv_dx), sp.x0_inv_dx)));
  k = k < 0 ? 0 : k;
  return k > sp.n - 1 ? sp.n - 1 : k;
}

// The cubic of interval k at r2, op by op as the plain version (the
// cubic cancels strongly in f32, so no FMA): tmp = a r2 + b,
// f = (tmp r2 + c) r2 + d (if F) and df = (1/r) df/dr =
// 2 ((3 tmp - b) r2 + c) (if DF).  One 16-byte load a table.
template <typename T, bool F, bool DF>
__device__ __forceinline__ void spline_eval(const Rec<T>* __restrict__ tab,
                                            int k, T r2, T& f, T& df) {
  const Rec<T> c = tab[k];
  const T tmp = add_rn(mul_rn(c.x, r2), c.y);
  if constexpr (F) f = add_rn(mul_rn(add_rn(mul_rn(tmp, r2), c.z), r2), c.w);
  if constexpr (DF)
    df = mul_rn(T(2), add_rn(mul_rn(sub_rn(mul_rn(T(3), tmp), c.y), r2),
                             c.z));
}

// Shared-basis Chebyshev evaluation (tables.eval_cheb_fused): the outputs
// selected by WANT (bit k = slot k) from one basis recurrence.  Derivative
// outputs come back as (1/r) df/dr.
template <typename T, int WANT>
__device__ __forceinline__ void cheb_eval(const Cheb<T>& p, T r2, T out[4]) {
  T u = r2 < p.u_lo ? p.u_lo : r2;
  u = u > p.u_hi ? p.u_hi : u;
  T w, uinv = T(0);
  if (p.transform == 0) {
    w = u;
  } else if (p.transform == 1) {
    uinv = T(1) / u;
    w = uinv;
  } else {
    uinv = T(1) / u;
    w = dev_log<T>(u);
  }
  const T t = (w - p.w_mid) * p.w_scale;
  const T t2 = t + t;
  T acc[4];
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    if (WANT & (1 << s)) acc[s] = p.c[s][0] + p.c[s][1] * t;
  }
  T tm1 = T(1), tk = t;
  for (int k = 2; k < p.n_terms; ++k) {
    const T tn = t2 * tk - tm1;
    tm1 = tk;
    tk = tn;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      if (WANT & (1 << s)) acc[s] += p.c[s][k] * tk;
    }
  }
  T two_dwdu;
  if (p.transform == 0) {
    two_dwdu = T(2);
  } else if (p.transform == 1) {
    two_dwdu = T(-2) * w * w;
  } else {
    two_dwdu = T(2) * uinv;
  }
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    if (WANT & (1 << s)) out[s] = (s & 1) ? two_dwdu * acc[s] : acc[s];
  }
}

// Quadratic interpolation with 4-point derivative (eam.c:557-579) on the
// [n+4] padded table: returns f and df/dr.
template <typename T>
__device__ __forceinline__ void table_eval(const T* __restrict__ tab, int n,
                                           T x0, T inv_dx, T r, T& f,
                                           T& df) {
  r = r < x0 ? x0 : r;
  const T rr = (r - x0) * inv_dx;
  const T fl = dev_floor<T>(rr);
  long long ii = static_cast<long long>(fl);
  const bool over = ii > n;
  if (over) ii = n;
  const T frac = over ? T(0) : rr - fl;
  const T tm1 = tab[ii], t0 = tab[ii + 1], t1 = tab[ii + 2],
          t2 = tab[ii + 3];
  const T g1 = t1 - tm1;
  const T g2 = t2 - t0;
  f = t0 + T(0.5) * frac * (g1 + frac * (t1 + tm1 - T(2) * t0));
  df = T(0.5) * (g1 + frac * (g2 - g1)) * inv_dx;
}

// One pair inside the cutoff: returns the force coefficient fc (f_i +=
// fc * (r_i - r_j)) and writes the pair's scalars into sc (EAM pass 1:
// [phi,] rho; LJ: [e], the -I table's e carrying 4 eps already).
template <typename T, int PAIR, int EVAL, bool ENERGY>
__device__ __forceinline__ T pair_eval(const Cheb<T>& cp, const Table<T>& tp,
                                       const Lj<T>& lj, const Spline<T>& sp,
                                       T r2, T di, T dj, T* sc) {
  if constexpr (PAIR == kLj && EVAL == 1) {
    // -I: f_i = -(de/dr) / r (r_i - r_j) from the quadratic table
    const T rr = dev_sqrt<T>(r2);
    T e, de;
    table_eval<T>(tp.phi, tp.n, tp.x0, tp.inv_dx, rr, e, de);
    if constexpr (ENERGY) sc[0] = e;
    return -de / rr;
  } else if constexpr (PAIR == kLj) {
    const T inv_r2 = T(1) / r2;
    const T r6 = (lj.s6 * inv_r2) * (inv_r2 * inv_r2);
    if constexpr (ENERGY) sc[0] = r6 * (r6 - T(1)) - lj.e_shift;
    return lj.eps4 * r6 * inv_r2 * (T(12) * r6 - T(6));
  } else if constexpr (PAIR == kEam3) {
    T scale;
    if constexpr (EVAL == 0) {
      T out[4];
      cheb_eval<T, 0x8>(cp, r2, out);
      scale = out[3];
    } else if constexpr (EVAL == 2) {
      T unused;   // the spline's derivative is (1/r) drho/dr already
      spline_eval<T, false, true>(sp.rho, spline_index<T>(sp, r2), r2,
                                  unused, scale);
    } else {
      const T rr = dev_sqrt<T>(r2);
      T rho, drho;
      table_eval<T>(tp.rho, tp.n, tp.x0, tp.inv_dx, rr, rho, drho);
      scale = drho / rr;
    }
    return -(di + dj) * scale;
  } else {   // EAM pass 1
    T fc, phi, rho;
    if constexpr (EVAL == 0) {
      T out[4];
      cheb_eval<T, ENERGY ? 0x7 : 0x6>(cp, r2, out);
      fc = -out[1];
      phi = ENERGY ? out[0] : T(0);
      rho = out[2];
    } else if constexpr (EVAL == 2) {
      // one interval for both tables (one grid): 8 coefficient loads a pair
      // with the energy, phi's value skipped without it
      const int k = spline_index<T>(sp, r2);
      T dphi, unused;
      phi = T(0);
      spline_eval<T, ENERGY, true>(sp.phi, k, r2, phi, dphi);
      spline_eval<T, true, false>(sp.rho, k, r2, rho, unused);
      fc = -dphi;
    } else {
      const T rr = dev_sqrt<T>(r2);
      T dphi, drho;
      table_eval<T>(tp.phi, tp.n, tp.x0, tp.inv_dx, rr, phi, dphi);
      table_eval<T>(tp.rho, tp.n, tp.x0, tp.inv_dx, rr, rho, drho);
      fc = -dphi / rr;
    }
    if constexpr (ENERGY) {
      sc[0] = phi;
      sc[1] = rho;
    } else {
      sc[0] = rho;
    }
    return fc;
  }
}


// The host parameters rounded once to the kernel's precision, for the pair
// function PAIR and evaluator EVAL (the others stay zero).  The -I table
// (LJ, EVAL 1) comes as a TableParams whose phi is the table.
template <typename T, int PAIR, int EVAL>
void round_params(const ChebParams* cheb, const TableParams* tab,
                  const LjParams* ljp, const SplineParams* spl, Cheb<T>& cp,
                  Table<T>& tp, Lj<T>& lj, Spline<T>& sp) {
  if (EVAL == 2) {
    sp.n = spl->n;
    sp.x0 = static_cast<T>(spl->x0);
    sp.xn = static_cast<T>(spl->xn);
    sp.inv_dx = static_cast<T>(spl->inv_dx);
    sp.x0_inv_dx = static_cast<T>(spl->x0_inv_dx);
    sp.phi = static_cast<const Rec<T>*>(spl->phi);
    sp.rho = static_cast<const Rec<T>*>(spl->rho);
  } else if (PAIR == kLj && EVAL == 0) {
    lj.s6 = static_cast<T>(ljp->s6);
    lj.eps4 = static_cast<T>(ljp->eps4);
    lj.e_shift = static_cast<T>(ljp->e_shift);
  } else if (EVAL == 0) {
    cp.transform = cheb->transform;
    cp.n_terms = cheb->n_terms;
    cp.u_lo = static_cast<T>(cheb->u_lo);
    cp.u_hi = static_cast<T>(cheb->u_hi);
    cp.w_mid = static_cast<T>(cheb->w_mid);
    cp.w_scale = static_cast<T>(cheb->w_scale);
    for (int s = 0; s < 4; ++s)
      for (int k = 0; k < kMaxCheb; ++k)
        cp.c[s][k] = static_cast<T>(cheb->c[s][k]);
  } else {
    tp.n = tab->n;
    tp.x0 = static_cast<T>(tab->x0);
    tp.inv_dx = static_cast<T>(tab->inv_dx);
    tp.phi = static_cast<const T*>(tab->phi);
    tp.rho = static_cast<const T*>(tab->rho);
  }
}

}  // namespace
