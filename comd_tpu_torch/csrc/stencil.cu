// Cell-stencil pair sweeps for Hopper (sm_90a): the full-shell sweep (K1)
// and the half-shell sweep (K2), for EAM passes 1 and 3 and for LJ.
//
// K1 replaces comd_tpu/ops/pallas/stencil.py::_kernel (stencil_sweep with
// the eam_pass1_stencil / eam_pass3_stencil / _lj_pair pair functions), the
// reference's CTA-per-cell design (gpu_eam_cta_cell.h:34-75,
// gpu_lj_cta_cell.h:29-122).  For every local cell and i-slot it sums, over
// the 27 neighbor cells' j-slots inside the cutoff (0 < r2 <= rcut2):
//   EAM pass 1: f_i += fc * (r_i - r_j) with fc = -(1/r) dphi/dr,
//               phi_sum_i += phi(r), rhobar_i += rho(r)
//   EAM pass 3: f_i += fc * (r_i - r_j),
//               fc = -(dfe_i + dfe_j) (1/r) drho/dr
//   LJ:         f_i += fc * (r_i - r_j) with fc = 4 eps r6 / r2 (12 r6 - 6),
//               e_i += r6 (r6 - 1) - e_shift   (r6 = s6 / r2^3)
//
// K2 replaces stencil.py::_kernel_half (stencil_sweep_half), the pair-once
// sweep of the reference's half-list kernels (ljForce.c:146-265,
// eam.c:266-419).  The i side covers the local cells only; the j side the
// 14 half-map cells (self first, with slot_i < slot_j, then 13 offsets, one
// of each +/- pair).  Each pair within the cutoff is evaluated once and
// delivered to both atoms: the i side gets +fc * dr and the scalars, the j
// side -fc * dr and the same scalars.  Outputs are DENSE over every box
// (local and halo); halo rows are folded to their owners by the caller.
//
// Layout: positions are the state's own [3, B, A] planes (B boxes incl.
// halo, A slots per box, empty slots at the 1e10 sentinel so they never
// fall inside the cutoff); nbr[n_local, n_nbr] lists each local cell's 27
// (K1) or 14 (K2) neighbor boxes.  The output is one buffer of 3 + ns
// planes (force x, y, z, then the scalars): K1 writes [3+ns, n_local, A],
// every slot of every local cell (empty i-slots write exactly 0), so the
// caller allocates it uninitialized; K2 adds into [3+ns, B, A], which the
// caller zeroes.
//
// Bound: pair arithmetic.  At the 63^3 EAM headline (74,088 cells, A = 16)
// a K1 pass visits 512 M candidate pairs and reads ~22 MB; K2 visits 255 M.
// Design: a block covers `cpb` cells with TI = min(A, 128) threads per cell
// (cpb * TI >= 128 threads); each thread owns one i-slot and loops over
// i-slots in steps of TI when A > TI.  For each neighbor cell the block
// stages, per cell, that neighbor's slots (x, y, z and, in EAM pass 3,
// dfEmbed) in shared memory in tiles of TI slots, and each i-thread walks the
// staged tile.  The pair evaluation runs only inside the cutoff.  K2 adds
// each pair's j-side terms into per-slot shared-memory accumulators (each
// thread starts its walk at its own slot, so the threads of a warp hit
// different accumulators), then flushes every non-zero accumulator with one
// global atomicAdd per (j-slot, output) per tile; the i side goes in with
// atomicAdd as well, since other blocks' j deliveries land on local rows.
// The atomics make K2's float sums run-to-run non-deterministic in the last
// bits.
//
// Variants: pair (EAM 1 with/without phi energy, EAM 3, LJ with/without
// energy) x half (K1, K2) x precision (float, double) x evaluator (EAM:
// shared-basis Chebyshev in w(u = r^2), or the exact quadratic
// interpolation of the phi/rho tables, eam.c:557-579).  Built without fast
// math: the evaluators need IEEE 1/u, log and sqrt.
//
// Plain C interface for ctypes: comd_stencil returns the cudaError_t of the
// launch (0 = success).

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

constexpr int kMaxCheb = 40;    // coefficient slots per Chebyshev output
constexpr int kMaxTile = 128;   // i-slots per cell per round, j-slots per tile

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
// [phi,] rho; LJ: [e]).
template <typename T, int PAIR, int EVAL, bool ENERGY>
__device__ __forceinline__ T pair_eval(const Cheb<T>& cp, const Table<T>& tp,
                                       const Lj<T>& lj, T r2, T di, T dj,
                                       T* sc) {
  if constexpr (PAIR == kLj) {
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

// TILED (A > kMaxTile): i-slots in rounds of TI, j-slots in tiles of TI.
// Otherwise TI == A and both loops run once with bounds the compiler sees,
// so the loop state costs no registers.  Measured on an H100 at the 63^3
// EAM headline: with runtime-bounded loops the f32 K1 passes took 44-46
// registers and 1.61-1.69 / 1.42-1.51 ms (passes 1 / 3); with the untiled
// variant 28-31 registers and 1.36 / 1.21 ms.
template <typename T, int PAIR, int EVAL, bool ENERGY, bool HALF, bool TILED>
__global__ void __launch_bounds__(256) stencil_kernel(
    const T* __restrict__ r, const int* __restrict__ nbr,
    const T* __restrict__ dfe, T* __restrict__ out, int n_local,
    int n_boxes, int A, int TI, int cpb, T rcut2, Cheb<T> cp,
    Table<T> tp, Lj<T> lj) {
  constexpr int NS = n_scalars<PAIR, ENERGY>();
  constexpr int NOUT = 3 + NS;
  constexpr int NNBR = HALF ? 14 : 27;   // neighbor cells per local cell
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nthr = cpb * TI;
  T* sx = reinterpret_cast<T*>(smem_raw);
  T* sy = sx + nthr;
  T* sz = sy + nthr;
  T* sd = sz + nthr;
  T* sacc = sd + nthr;   // K2: NOUT planes of j-side accumulators

  const int t = threadIdx.x;
  const int c = t / TI;
  const int ti = t - c * TI;
  const int cell = blockIdx.x * cpb + c;
  const bool cell_ok = cell < n_local;
  const size_t plane = static_cast<size_t>(n_boxes) * A;
  const size_t oplane = static_cast<size_t>(HALF ? n_boxes : n_local) * A;
  const T* cx = sx + c * TI;
  const T* cy = sy + c * TI;
  const T* cz = sz + c * TI;
  const T* cd = sd + c * TI;
  T* cacc = sacc + c * TI;
  if (HALF) {
#pragma unroll
    for (int q = 0; q < NOUT; ++q) sacc[q * nthr + t] = T(0);
  }

  const int span = TILED ? A : 1;
  const int step = TILED ? TI : 1;
  for (int i0 = 0; i0 < span; i0 += step) {
    const int i = i0 + ti;
    const bool active = cell_ok && i < A;
    T xi = T(0), yi = T(0), zi = T(0), di = T(0);
    if (active) {
      const size_t o = static_cast<size_t>(cell) * A + i;
      xi = r[o];
      yi = r[plane + o];
      zi = r[2 * plane + o];
      if (PAIR == kEam3) di = dfe[o];
    }
    T fx = T(0), fy = T(0), fz = T(0);
    T si[NS > 0 ? NS : 1];
#pragma unroll
    for (int q = 0; q < NS; ++q) si[q] = T(0);

    for (int k = 0; k < NNBR; ++k) {
      const int nb = cell_ok ? nbr[static_cast<size_t>(cell) * NNBR + k] : 0;
      for (int j0 = 0; j0 < span; j0 += step) {
        const int nj = TILED ? min(TI, A - j0) : A;
        if (cell_ok && ti < nj) {
          const size_t o = static_cast<size_t>(nb) * A + j0 + ti;
          sx[t] = r[o];
          sy[t] = r[plane + o];
          sz[t] = r[2 * plane + o];
          if (PAIR == kEam3) sd[t] = dfe[o];
        }
        __syncthreads();
        if (active) {
          // K2 walks from its own slot (distinct accumulators per warp);
          // the self cell (k == 0) takes only j > i
          const int jstart = HALF ? ti % nj : 0;
          const int jmin = (HALF && k == 0) ? i - j0 : -1;
          for (int jj = 0; jj < nj; ++jj) {
            int j = jj;
            if constexpr (HALF) {
              j += jstart;
              if (j >= nj) j -= nj;
              if (j <= jmin) continue;
            }
            const T dx = xi - cx[j];
            const T dy = yi - cy[j];
            const T dz = zi - cz[j];
            const T r2 = dist2(dx, dy, dz);
            if (r2 <= rcut2 && r2 > T(0)) {
              T sc[NS > 0 ? NS : 1];
              const T fc = pair_eval<T, PAIR, EVAL, ENERGY>(
                  cp, tp, lj, r2, di, PAIR == kEam3 ? cd[j] : T(0), sc);
              const T px = fc * dx, py = fc * dy, pz = fc * dz;
              fx += px;
              fy += py;
              fz += pz;
#pragma unroll
              for (int q = 0; q < NS; ++q) si[q] += sc[q];
              if constexpr (HALF) {
                atomicAdd(&cacc[j], -px);
                atomicAdd(&cacc[nthr + j], -py);
                atomicAdd(&cacc[2 * nthr + j], -pz);
#pragma unroll
                for (int q = 0; q < NS; ++q)
                  atomicAdd(&cacc[(3 + q) * nthr + j], sc[q]);
              }
            }
          }
        }
        __syncthreads();
        if (HALF && cell_ok && ti < nj) {
          // flush this tile's j side to the neighbor's dense rows; the
          // zeroed accumulators are reused after the next staging barrier
          const size_t o = static_cast<size_t>(nb) * A + j0 + ti;
#pragma unroll
          for (int q = 0; q < NOUT; ++q) {
            const T v = cacc[q * nthr + ti];
            if (v != T(0)) {
              atomicAdd(&out[q * oplane + o], v);
              cacc[q * nthr + ti] = T(0);
            }
          }
        }
      }
    }

    if (active) {
      const size_t o = static_cast<size_t>(cell) * A + i;
      T v[NOUT];
      v[0] = fx;
      v[1] = fy;
      v[2] = fz;
#pragma unroll
      for (int q = 0; q < NS; ++q) v[3 + q] = si[q];
#pragma unroll
      for (int q = 0; q < NOUT; ++q) {
        if (!HALF) {
          out[q * oplane + o] = v[q];
        } else if (v[q] != T(0)) {
          atomicAdd(&out[q * oplane + o], v[q]);
        }
      }
    }
  }
}

struct Launch {
  const void* r;
  const int* nbr;
  const void* dfe;
  void* out;
  int n_local, n_boxes, A;
  double rcut2;
  const ChebParams* cheb;
  const TableParams* tab;
  const LjParams* lj;
  cudaStream_t stream;
};

template <typename T, int PAIR, int EVAL, bool ENERGY, bool HALF>
cudaError_t launch(const Launch& a) {
  Cheb<T> cp{};
  Table<T> tp{};
  Lj<T> lj{};
  if (PAIR == kLj) {
    lj.s6 = static_cast<T>(a.lj->s6);
    lj.eps4 = static_cast<T>(a.lj->eps4);
    lj.e_shift = static_cast<T>(a.lj->e_shift);
  } else if (EVAL == 0) {
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
  constexpr int NOUT = 3 + n_scalars<PAIR, ENERGY>();
  const int TI = a.A < kMaxTile ? a.A : kMaxTile;
  const int cpb = (kMaxTile + TI - 1) / TI;
  const int threads = cpb * TI;
  const int blocks = (a.n_local + cpb - 1) / cpb;
  const size_t smem =
      (4 + (HALF ? NOUT : 0)) * static_cast<size_t>(threads) * sizeof(T);
  const T* r = static_cast<const T*>(a.r);
  const T* dfe = static_cast<const T*>(a.dfe);
  T* out = static_cast<T*>(a.out);
  const T rcut2 = static_cast<T>(a.rcut2);
  if (blocks > 0 && a.A > kMaxTile) {
    stencil_kernel<T, PAIR, EVAL, ENERGY, HALF, true>
        <<<blocks, threads, smem, a.stream>>>(
            r, a.nbr, dfe, out, a.n_local, a.n_boxes, a.A, TI, cpb, rcut2,
            cp, tp, lj);
  } else if (blocks > 0) {
    stencil_kernel<T, PAIR, EVAL, ENERGY, HALF, false>
        <<<blocks, threads, smem, a.stream>>>(
            r, a.nbr, dfe, out, a.n_local, a.n_boxes, a.A, TI, cpb, rcut2,
            cp, tp, lj);
  }
  return cudaGetLastError();
}

template <typename T, int EVAL, bool HALF>
cudaError_t dispatch_pair(int pair, int want_energy, const Launch& a) {
  if (pair == kEam3) return launch<T, kEam3, EVAL, false, HALF>(a);
  if (pair == kEam1) {
    if (want_energy) return launch<T, kEam1, EVAL, true, HALF>(a);
    return launch<T, kEam1, EVAL, false, HALF>(a);
  }
  if (EVAL != 0) return cudaErrorInvalidValue;   // LJ has one evaluator
  if (want_energy) return launch<T, kLj, 0, true, HALF>(a);
  return launch<T, kLj, 0, false, HALF>(a);
}

template <typename T, bool HALF>
cudaError_t dispatch_eval(int eval, int pair, int want_energy,
                          const Launch& a) {
  if (eval == 0) return dispatch_pair<T, 0, HALF>(pair, want_energy, a);
  return dispatch_pair<T, 1, HALF>(pair, want_energy, a);
}

template <typename T>
cudaError_t dispatch_half(int half, int eval, int pair, int want_energy,
                          const Launch& a) {
  if (half) return dispatch_eval<T, true>(eval, pair, want_energy, a);
  return dispatch_eval<T, false>(eval, pair, want_energy, a);
}

}  // namespace

extern "C" {

// pair: 0 EAM pass 1, 1 EAM pass 3, 2 LJ; half: 0 K1 (full shell, n_nbr
// 27), 1 K2 (half shell, n_nbr 14, self first); dtype: 0 float, 1 double;
// eval (EAM): 0 Chebyshev, 1 table.  Returns the launch's cudaError_t (0 on
// success); does not synchronize.
int comd_stencil(int pair, int half, int dtype, int eval, int want_energy,
                 const void* r, const void* nbr, int n_nbr, const void* dfe,
                 void* out, int n_local, int n_boxes, int A, double rcut2,
                 const ChebParams* cheb, const TableParams* tab,
                 const LjParams* lj, void* stream) {
  const bool eam = pair == kEam1 || pair == kEam3;
  if ((pair != kEam1 && pair != kEam3 && pair != kLj) ||
      n_nbr != (half ? 14 : 27) || A < 1 ||
      (eam && eval == 0 && cheb == nullptr) ||
      (eam && eval == 1 && tab == nullptr) ||
      (pair == kLj && (lj == nullptr || eval != 0)) ||
      (pair == kEam3 && dfe == nullptr) ||
      (eam && eval == 0 &&
       (cheb->n_terms < 2 || cheb->n_terms > kMaxCheb)))
    return static_cast<int>(cudaErrorInvalidValue);
  Launch a{r, static_cast<const int*>(nbr), dfe, out, n_local,
           n_boxes, A, rcut2, cheb, tab, lj,
           static_cast<cudaStream_t>(stream)};
  if (dtype == 0)
    return dispatch_half<float>(half, eval, pair, want_energy, a);
  if (dtype == 1)
    return dispatch_half<double>(half, eval, pair, want_energy, a);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* comd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
