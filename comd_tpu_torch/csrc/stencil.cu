// EAM cell-stencil pair sweep for Hopper (sm_90a): passes 1 and 3.
//
// Replaces comd_tpu/ops/pallas/stencil.py::_kernel (stencil_sweep with the
// eam_pass1_stencil / eam_pass3_stencil pair functions), which is the
// reference's CTA-per-cell design (gpu_eam_cta_cell.h:34-75).  For every
// local cell and i-slot it sums, over the 27 neighbor cells' j-slots inside
// the cutoff (0 < r2 <= rcut2):
//   pass 1: f_i += fc * (r_i - r_j) with fc = -(1/r) dphi/dr,
//           phi_sum_i += phi(r), rhobar_i += rho(r)
//   pass 3: f_i += fc * (r_i - r_j) with fc = -(dfe_i + dfe_j) (1/r) drho/dr
//
// Layout: positions are the state's own [3, B, A] planes (B boxes incl.
// halo, A slots per box, empty slots at the 1e10 sentinel so they never
// fall inside the cutoff); nbr[n_local, 27] lists each local cell's 27
// neighbor boxes (self included).  Outputs are [3, n_local, A] and
// [n_local, A]; every slot of every local cell is written (empty i-slots
// write exactly 0), so the caller allocates them uninitialized.
//
// Bound: pair arithmetic.  At the 63^3 headline (74,088 cells, A = 16) a
// pass visits 512 M candidate pairs and reads ~22 MB.  Design: a block
// covers `cpb` cells with one thread per i-slot (cpb * A >= 128 threads).
// For each of the 27 neighbor offsets the block stages, per cell, that
// neighbor's A slots (x, y, z and, in pass 3, dfEmbed) in shared memory --
// thread (c, s) loads slot s of its cell's neighbor -- and each i-thread
// walks the staged j-slots.  The pair evaluation (Chebyshev recurrence or
// table interpolation) runs only inside the cutoff.
//
// Variants: pass (1 with/without phi energy, 3) x precision (float,
// double) x evaluator (shared-basis Chebyshev in w(u = r^2), or the exact
// quadratic interpolation of the phi/rho tables, eam.c:557-579).  Built
// without fast math: the evaluators need IEEE 1/u, log and sqrt.
//
// Plain C interface for ctypes: comd_stencil_eam returns the cudaError_t
// of the launch (0 = success).

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

constexpr int kMaxCheb = 40;   // coefficient slots per Chebyshev output

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

namespace {

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
// cutoff cannot flip in or out (rho' is not zero there).
__device__ __forceinline__ float dist2(float dx, float dy, float dz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}
__device__ __forceinline__ double dist2(double dx, double dy, double dz) {
  return __dadd_rn(__dadd_rn(__dmul_rn(dx, dx), __dmul_rn(dy, dy)),
                   __dmul_rn(dz, dz));
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

// PASS 1: fc, phi (when ENERGY) and rho for one pair inside the cutoff.
template <typename T, int EVAL, bool ENERGY>
__device__ __forceinline__ void pair1(const Cheb<T>& cp, const Table<T>& tp,
                                      T r2, T& fc, T& phi, T& rho) {
  if (EVAL == 0) {
    T out[4];
    cheb_eval<T, ENERGY ? 0x7 : 0x6>(cp, r2, out);
    fc = -out[1];
    phi = ENERGY ? out[0] : T(0);
    rho = out[2];
  } else {
    const T rr = dev_sqrt<T>(r2);
    T dphi, drho;
    table_eval<T>(tp.phi, tp.n, tp.x0, tp.inv_dx, rr, phi, dphi);
    table_eval<T>(tp.rho, tp.n, tp.x0, tp.inv_dx, rr, rho, drho);
    fc = -dphi / rr;
  }
}

// PASS 3: (1/r) drho/dr for one pair inside the cutoff.
template <typename T, int EVAL>
__device__ __forceinline__ T pair3_scale(const Cheb<T>& cp,
                                         const Table<T>& tp, T r2) {
  if (EVAL == 0) {
    T out[4];
    cheb_eval<T, 0x8>(cp, r2, out);
    return out[3];
  }
  const T rr = dev_sqrt<T>(r2);
  T rho, drho;
  table_eval<T>(tp.rho, tp.n, tp.x0, tp.inv_dx, rr, rho, drho);
  return drho / rr;
}

template <typename T, int PASS, int EVAL, bool ENERGY>
__global__ void __launch_bounds__(256) stencil_eam_kernel(
    const T* __restrict__ r, const int* __restrict__ nbr,
    const T* __restrict__ dfe, T* __restrict__ f, T* __restrict__ phi_sum,
    T* __restrict__ rho_sum, int n_local, int n_boxes, int A, int cpb,
    T rcut2, Cheb<T> cp, Table<T> tp) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nthr = cpb * A;
  T* sx = reinterpret_cast<T*>(smem_raw);
  T* sy = sx + nthr;
  T* sz = sy + nthr;
  T* sd = sz + nthr;

  const int t = threadIdx.x;
  const int c = t / A;
  const int i = t - c * A;
  const int cell = blockIdx.x * cpb + c;
  const bool active = cell < n_local;
  const size_t plane = static_cast<size_t>(n_boxes) * A;

  T xi = T(0), yi = T(0), zi = T(0), di = T(0);
  if (active) {
    const size_t o = static_cast<size_t>(cell) * A + i;
    xi = r[o];
    yi = r[plane + o];
    zi = r[2 * plane + o];
    if (PASS == 3) di = dfe[o];
  }
  T fx = T(0), fy = T(0), fz = T(0), sphi = T(0), srho = T(0);
  const T* cx = sx + c * A;
  const T* cy = sy + c * A;
  const T* cz = sz + c * A;
  const T* cd = sd + c * A;

  for (int k = 0; k < 27; ++k) {
    if (active) {
      const int nb = nbr[static_cast<size_t>(cell) * 27 + k];
      const size_t o = static_cast<size_t>(nb) * A + i;
      sx[t] = r[o];
      sy[t] = r[plane + o];
      sz[t] = r[2 * plane + o];
      if (PASS == 3) sd[t] = dfe[o];
    }
    __syncthreads();
    if (active) {
      for (int j = 0; j < A; ++j) {
        const T dx = xi - cx[j];
        const T dy = yi - cy[j];
        const T dz = zi - cz[j];
        const T r2 = dist2(dx, dy, dz);
        if (r2 <= rcut2 && r2 > T(0)) {
          T fc;
          if (PASS == 1) {
            T phi, rho;
            pair1<T, EVAL, ENERGY>(cp, tp, r2, fc, phi, rho);
            if (ENERGY) sphi += phi;
            srho += rho;
          } else {
            fc = -(di + cd[j]) * pair3_scale<T, EVAL>(cp, tp, r2);
          }
          fx += fc * dx;
          fy += fc * dy;
          fz += fc * dz;
        }
      }
    }
    __syncthreads();
  }

  if (active) {
    const size_t o = static_cast<size_t>(cell) * A + i;
    const size_t fplane = static_cast<size_t>(n_local) * A;
    f[o] = fx;
    f[fplane + o] = fy;
    f[2 * fplane + o] = fz;
    if (PASS == 1) {
      if (ENERGY) phi_sum[o] = sphi;
      rho_sum[o] = srho;
    }
  }
}

struct Launch {
  const void* r;
  const int* nbr;
  const void* dfe;
  void* f;
  void* phi;
  void* rho;
  int n_local, n_boxes, A, cpb;
  double rcut2;
  const ChebParams* cheb;
  const TableParams* tab;
  cudaStream_t stream;
};

template <typename T, int PASS, int EVAL, bool ENERGY>
cudaError_t launch(const Launch& a) {
  Cheb<T> cp{};
  Table<T> tp{};
  if (EVAL == 0) {
    cp.transform = a.cheb->transform;
    cp.n_terms = a.cheb->n_terms;
    cp.u_lo = static_cast<T>(a.cheb->u_lo);
    cp.u_hi = static_cast<T>(a.cheb->u_hi);
    cp.w_mid = static_cast<T>(a.cheb->w_mid);
    cp.w_scale = static_cast<T>(a.cheb->w_scale);
    for (int s = 0; s < 4; ++s)
      for (int k = 0; k < kMaxCheb; ++k)
        cp.c[s][k] = static_cast<T>(a.cheb->c[s][k]);
  } else {
    tp.n = a.tab->n;
    tp.x0 = static_cast<T>(a.tab->x0);
    tp.inv_dx = static_cast<T>(a.tab->inv_dx);
    tp.phi = static_cast<const T*>(a.tab->phi);
    tp.rho = static_cast<const T*>(a.tab->rho);
  }
  const int threads = a.cpb * a.A;
  const int blocks = (a.n_local + a.cpb - 1) / a.cpb;
  const size_t smem = 4 * static_cast<size_t>(threads) * sizeof(T);
  if (blocks > 0) {
    stencil_eam_kernel<T, PASS, EVAL, ENERGY>
        <<<blocks, threads, smem, a.stream>>>(
            static_cast<const T*>(a.r), a.nbr, static_cast<const T*>(a.dfe),
            static_cast<T*>(a.f), static_cast<T*>(a.phi),
            static_cast<T*>(a.rho), a.n_local, a.n_boxes, a.A, a.cpb,
            static_cast<T>(a.rcut2), cp, tp);
  }
  return cudaGetLastError();
}

template <typename T, int EVAL>
cudaError_t dispatch_pass(int pass, int want_energy, const Launch& a) {
  if (pass == 3) return launch<T, 3, EVAL, false>(a);
  if (want_energy) return launch<T, 1, EVAL, true>(a);
  return launch<T, 1, EVAL, false>(a);
}

template <typename T>
cudaError_t dispatch_eval(int eval, int pass, int want_energy,
                          const Launch& a) {
  if (eval == 0) return dispatch_pass<T, 0>(pass, want_energy, a);
  return dispatch_pass<T, 1>(pass, want_energy, a);
}

}  // namespace

extern "C" {

// pass: 1 or 3; dtype: 0 float, 1 double; eval: 0 Chebyshev, 1 table.
// Returns the launch's cudaError_t (0 on success); does not synchronize.
int comd_stencil_eam(int pass, int dtype, int eval, int want_energy,
                     const void* r, const void* nbr, const void* dfe,
                     void* f, void* phi, void* rho, int n_local, int n_boxes,
                     int A, int cpb, double rcut2, const ChebParams* cheb,
                     const TableParams* tab, void* stream) {
  if ((pass != 1 && pass != 3) || (eval == 0 && cheb == nullptr) ||
      (eval == 1 && tab == nullptr) || (pass == 3 && dfe == nullptr) ||
      (eval == 0 && (cheb->n_terms < 2 || cheb->n_terms > kMaxCheb)))
    return static_cast<int>(cudaErrorInvalidValue);
  Launch a{r, static_cast<const int*>(nbr), dfe, f, phi, rho, n_local,
           n_boxes, A, cpb, rcut2, cheb, tab,
           static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return dispatch_eval<float>(eval, pass, want_energy, a);
  if (dtype == 1) return dispatch_eval<double>(eval, pass, want_energy, a);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* comd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
