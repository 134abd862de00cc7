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
// fall inside the cutoff).  The output is one buffer of 3 + ns planes
// (force x, y, z, then the scalars): K1 writes [3+ns, n_local, A], every
// slot of every local cell (empty i-slots write exactly 0), so the caller
// allocates it uninitialized; K2 adds into [3+ns, B, A], which the caller
// zeroes.  The cells come grouped in bricks by a static plan
// (ops/binning.BrickPlan, built once per geometry from the cells' grid
// coordinates and the neighbor map): each brick's local cells, the box ids
// of the union of their neighbor boxes (its region) and, per (cell,
// neighbor column), that box's place in the region.
//
// What bounds them: at the 63^3 EAM headline (74,088 cells, A = 16, 42^3
// grid) a K1 pass tests 512 M slot pairs (364 M of occupied slots), 43 M of
// them inside the cutoff, and reads ~22 MB: by the flops the function
// needs (r2 on every candidate, the pair function inside the cutoff) the
// bound is 0.09 ms at 67 TFLOP/s.  The first design (one thread per i-slot
// evaluating the pair function under `if (r2 <= rcut2)`) ran at 4-9% of
// it: in ~94% of j iterations some lane of a warp is inside the cutoff, so
// the whole warp executes the ~65-instruction Chebyshev chain with ~2 of 32
// lanes useful, and K2 also paid 3 + ns shared atomics per pair and ~66 M
// global atomics per pass flushing every (cell, neighbor) tile.
//
// Design (one block per brick; bricks of ~256 slots, e.g. 4x2x2 cells at
// A = 16):
//  - Staging: the region's slots are copied once per brick into shared
//    memory as one 16-byte record (x, y, z, dfEmbed or pad) per slot, with
//    cp.async, so a j read is one LDS.128 (two in f64).  A region that does
//    not fit (large A in f64) is staged in chunks of whole boxes.
//  - Split test and evaluation: each i-thread walks its candidate j-slots,
//    tests r2 exactly as the plain version rounds it, and appends the
//    staged index of each j inside the cutoff to its own 16-bit list in
//    shared memory.  When any lane's list nears capacity (__any_sync), and
//    at the end of the walk, the warp drains: each lane evaluates the pair
//    function on its own entries, so most lanes do useful work.  Per i the
//    pairs are summed in traversal order: K1 is deterministic.
//  - K2's j side goes into per-(staged slot, output) shared accumulators
//    and is flushed to the dense output once per brick with one global
//    atomicAdd per non-zero value; its i side accumulates in registers and
//    goes in with one atomicAdd per slot and output (other bricks deliver
//    to the same rows).  The atomics make K2's float sums run-to-run
//    non-deterministic in the last bits.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W, 63^3 headline states
// (chip_smoke.py; the first design's times in parentheses): K1 EAM pass 1
// 0.69 ms (1.37), pass 3 0.64 (1.21), LJ 0.92 (1.05); K2 EAM pass 1 0.72
// (1.28), pass 3 0.66 (1.09), LJ 1.05 (1.24).  K1 tests a candidate pair
// in ~1.9 ps and reaches ~8.8 TFLOP/s of needed flops, ~13% of its bound.
// Where the time goes (stencil_breakdown.py, which times copies of this
// source with parts cut out): K1 EAM pass 1 spends ~0.11 ms staging, 0.31
// in the r2 walk (the largest share), 0.07 reading lists and records in
// the drain and 0.17 in the pair function; K1-LJ's walk is 0.51 of its
// 0.93.  What bounds K2 beyond that is the j side: sm_90 has no
// shared-memory float add, and the 128-bit compare-and-swap a pair costs
// 0.19 ms of EAM pass 1's 0.72 and 0.35 of LJ's 1.08 over plain adds, most
// of it the atomics themselves (on slots no other thread shares they still
// cost 0.14 and 0.29).
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
constexpr int kThreads = 256;   // threads a block at most (a brick's slots)

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

// One staged slot: position and, in EAM pass 3, dfEmbed (w; unused
// otherwise), so that a j read is one 16-byte shared load (two for double).
template <typename T>
struct alignas(4 * sizeof(T)) Rec {
  T x, y, z, w;
};

template <typename T>
__device__ __forceinline__ T quiet_nan();
template <>
__device__ __forceinline__ float quiet_nan<float>() {
  return __int_as_float(0x7fffffff);
}
template <>
__device__ __forceinline__ double quiet_nan<double>() {
  return __longlong_as_double(0x7ff8000000000000LL);
}

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

// The brick plan (ops/binning.BrickPlan), device arrays.
struct Plan {
  const int* cells;        // [n_bricks, cpb] local box ids, -1 past the grid
  const int* region_ptr;   // [n_bricks + 1] CSR offsets into region_box
  const int* region_box;   // box ids of each brick's staged region
  const short* slot;       // [n_bricks, cpb, n_nbr] region index of each
                           // (cell, neighbor column)
  int n_bricks, cpb, max_region;
};

// K2's j-side accumulators: n_acc values a staged slot, the slot's outputs
// side by side (f32: padded to a 16-byte group, plus a second group when
// there are 5).
template <typename T, int NOUT>
__host__ __device__ constexpr int n_acc() {
  return sizeof(T) == 4 ? (NOUT <= 4 ? 4 : 8) : NOUT;
}

// Launch shape shared by the kernel and the host: nthr threads a block
// (min(A, kThreads) a cell of the brick, rounded up to whole warps), nbc
// region boxes staged a chunk (the whole region unless it does not fit),
// cap list entries a thread, jt candidates between capacity checks (a
// warp drains once a list passes cap - jt), stride records a staged box (A
// rounded up to odd: the same slot of two boxes lies in other banks, so
// lanes of one warp on different cells do not conflict).
//
// List sizes: a full-shell walk finds ~2.2-2.7 A pairs an atom inside the
// cutoff in CoMD's cells (EAM A = 16: ~43; LJ A = 32: ~69), a half-shell
// walk half as many.  K1 keeps 64 entries and tests tiles of up to 32,
// which keeps 3 blocks an SM at the headlines.  K2 drains once a list
// passes 2A (cap 2A + 16, tiles of up to 16): with K1's rule, draining at
// 32 entries, half-shell LJ took 1.31 ms against 1.08 (stencil_breakdown.py
// on an H100).
struct Shape {
  int nthr, nbc, cap, jt, stride;
  size_t rec_bytes, acc_bytes, slot_bytes, list_bytes, meta_bytes, smem;
};

__host__ __device__ constexpr size_t align16(size_t v) {
  return (v + 15) / 16 * 16;
}

template <typename T, int NOUT, bool HALF, int NNBR>
__host__ __device__ Shape make_shape(int A, int cpb, int nbc) {
  Shape s{};
  const int ti = A < kThreads ? A : kThreads;
  s.nthr = (cpb * ti + 31) / 32 * 32;
  const int jt_max = HALF ? 16 : 32;
  s.jt = A < jt_max ? A : jt_max;
  s.cap = HALF ? (2 * A + 16 < 120 ? 2 * A + 16 : 120) : 64;
  s.nbc = nbc;
  s.stride = A | 1;
  s.rec_bytes = static_cast<size_t>(nbc) * s.stride * sizeof(Rec<T>);
  s.acc_bytes = HALF ? static_cast<size_t>(n_acc<T, NOUT>()) * nbc *
                          s.stride * sizeof(T)
                    : 0;
  s.slot_bytes = align16(static_cast<size_t>(cpb) * NNBR * sizeof(short));
  s.list_bytes = static_cast<size_t>(s.cap) * s.nthr * sizeof(unsigned short);
  s.meta_bytes = align16((static_cast<size_t>(nbc) + cpb + 1) * sizeof(int));
  s.smem = s.rec_bytes + s.acc_bytes + s.slot_bytes + s.list_bytes +
           s.meta_bytes;
  return s;
}

// Shared-memory float atomicAdd compiles to a compare-and-swap loop
// (ATOMS.CAST.SPIN) on sm_90, one loop per value.  K2 adds a slot's four
// f32 j-side terms with one 128-bit compare-and-swap (atom.shared.cas.b128,
// sm_90) instead: p[0..3] += a atomically.
__device__ __forceinline__ unsigned long long pack2(float lo, float hi) {
  return static_cast<unsigned long long>(__float_as_uint(hi)) << 32 |
         __float_as_uint(lo);
}

__device__ __forceinline__ void atomic_add4(float* p, const float4& a) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  float4 old = *reinterpret_cast<const float4*>(p);
  for (;;) {
    const unsigned long long e0 = pack2(old.x, old.y);
    const unsigned long long e1 = pack2(old.z, old.w);
    const unsigned long long d0 = pack2(old.x + a.x, old.y + a.y);
    const unsigned long long d1 = pack2(old.z + a.z, old.w + a.w);
    unsigned long long o0, o1;
    asm volatile(
        "{\n\t.reg .b128 e, d, o;\n\t"
        "mov.b128 e, {%2, %3};\n\t"
        "mov.b128 d, {%4, %5};\n\t"
        "atom.shared.cas.b128 o, [%6], e, d;\n\t"
        "mov.b128 {%0, %1}, o;\n\t}"
        : "=l"(o0), "=l"(o1)
        : "l"(e0), "l"(e1), "l"(d0), "l"(d1), "r"(addr)
        : "memory");
    if (o0 == e0 && o1 == e1) return;
    old = make_float4(__uint_as_float(static_cast<unsigned>(o0)),
                      __uint_as_float(static_cast<unsigned>(o0 >> 32)),
                      __uint_as_float(static_cast<unsigned>(o1)),
                      __uint_as_float(static_cast<unsigned>(o1 >> 32)));
  }
}

// Empty slots sit at the 1e10 sentinel (ops/binning.EMPTY_POS); no atom
// comes near 1e9.
template <typename T>
__device__ __forceinline__ bool occupied(T x) {
  return x < T(1e9) && x > T(-1e9);
}

// The cutoff test of candidate j of the staged box at ``rj`` (region
// slot base + j): inside the cutoff, append it to this thread's list.
template <typename T, bool HALF>
__device__ __forceinline__ void test_pair(const Rec<T>* rj, int j, int jmin,
                                          int base, T xi, T yi, T zi,
                                          T rcut2, unsigned short* slist,
                                          int& lo, int nthr) {
  const Rec<T> v = rj[j];
  const T r2 = dist2(xi - v.x, yi - v.y, zi - v.z);
  if ((!HALF || j >= jmin) && r2 <= rcut2 && r2 > T(0)) {
    slist[lo] = static_cast<unsigned short>(base + j);
    lo += nthr;
  }
}

// One block per brick.  The brick's atoms are packed onto its threads:
// thread t owns the t-th used slot of the brick's cells in cell order (a
// cell's used slots are those up to its last occupied one; the rest hold
// the sentinel, sum to exactly 0 and are not walked), in rounds of nthr.
// Per chunk of the region: stage the chunk's boxes with cp.async, count
// each staged box's used slots, and walk the 27 (K1) or 14 (K2) neighbor
// columns over the used slots only, testing r2 and appending the staged
// index of every j inside the cutoff to the thread's own list in shared
// memory.  When any lane's list nears its capacity, and after the last
// column, the warp drains: each lane evaluates the pair function on its own
// entries into registers.  K1 drains in the order found, so it is
// bit-for-bit deterministic.  K2 adds the j side into per-(staged slot,
// output) shared accumulators (each lane starting its drain at another
// entry, so that the lanes of a warp hit different accumulators) and
// flushes them once per chunk (once per brick unless the region is
// chunked) with one global atomicAdd per non-zero value; its i side goes
// in with one atomicAdd per slot and output.
template <typename T, int PAIR, int EVAL, bool ENERGY, bool HALF>
__global__ void stencil_kernel(const T* __restrict__ r,
                               const T* __restrict__ dfe, T* __restrict__ out,
                               int n_local, int n_boxes, int A, Plan plan,
                               Shape sh, T rcut2, Cheb<T> cp, Table<T> tp,
                               Lj<T> lj) {
  constexpr int NS = n_scalars<PAIR, ENERGY>();
  constexpr int NOUT = 3 + NS;
  constexpr int NNBR = HALF ? 14 : 27;
  constexpr int NACC = n_acc<T, NOUT>();
  constexpr unsigned kAll = 0xffffffffu;
  extern __shared__ __align__(32) unsigned char smem_raw[];
  unsigned char* p = smem_raw;
  Rec<T>* srec = reinterpret_cast<Rec<T>*>(p);
  T* sacc = reinterpret_cast<T*>(p += sh.rec_bytes);
  short* sslot = reinterpret_cast<short*>(p += sh.acc_bytes);
  unsigned short* slist =
      reinterpret_cast<unsigned short*>(p += sh.slot_bytes);
  int* sjn = reinterpret_cast<int*>(p += sh.list_bytes);  // [nbc] used slots
  int* spre = sjn + sh.nbc;   // [cpb + 1] prefix sums of the cells' used slots

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int nthr = sh.nthr;
  const int brick = blockIdx.x;
  const int cpb = plan.cpb;
  const int* cells = plan.cells + static_cast<size_t>(brick) * cpb;
  const int rbeg = plan.region_ptr[brick];
  const int rn = plan.region_ptr[brick + 1] - rbeg;
  const int stride = sh.stride;
  const int nslot = sh.nbc * stride;   // staged records of a full chunk
  const size_t plane = static_cast<size_t>(n_boxes) * A;
  const size_t oplane = static_cast<size_t>(HALF ? n_boxes : n_local) * A;
  for (int s = t; s < cpb * NNBR; s += nthr)
    sslot[s] = plan.slot[static_cast<size_t>(brick) * cpb * NNBR + s];
  if (HALF) {
    for (int s = t; s < NACC * nslot; s += nthr) sacc[s] = T(0);
  }
  for (int s = t; s <= cpb; s += nthr) spre[s] = 0;
  __syncthreads();
  // the used slots of each cell of the brick, then their prefix sums
  for (int s = t; s < cpb * A; s += nthr) {
    const int c = s / A;
    const int j = s - c * A;
    if (cells[c] >= 0 && occupied(r[static_cast<size_t>(cells[c]) * A + j]))
      atomicMax(&spre[c + 1], j + 1);
  }
  __syncthreads();
  if (t < 32) {
    int carry = 0;
    for (int c0 = 1; c0 <= cpb; c0 += 32) {
      int v = c0 + t <= cpb ? spre[c0 + t] : 0;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int u = __shfl_up_sync(kAll, v, d);
        if (t >= d) v += u;
      }
      if (c0 + t <= cpb) spre[c0 + t] = carry + v;
      carry += __shfl_sync(kAll, v, 31);
    }
  }
  __syncthreads();
  const int total = spre[cpb];
  if (!HALF) {
    // K1 writes every slot: exact zeros past each cell's used slots
    for (int s = t; s < cpb * A; s += nthr) {
      const int c = s / A;
      const int j = s - c * A;
      if (cells[c] >= 0 && j >= spre[c + 1] - spre[c]) {
        const size_t o = static_cast<size_t>(cells[c]) * A + j;
#pragma unroll
        for (int q = 0; q < NOUT; ++q) out[q * oplane + o] = T(0);
      }
    }
  }
  const int jt = sh.jt;
  // list entry e of this thread is slist[e * nthr + t]; ``lo`` is the
  // offset of the next free entry, and the warp drains once a list
  // passes cap - jt entries (a tile of jt candidates cannot overflow it)
  const int lo0 = t;
  const int lo_full = (sh.cap - jt) * nthr + t;

  for (int a0 = 0; a0 < total; a0 += nthr) {
    const int a = a0 + t;
    const bool active = a < total;
    // this thread's cell: the last c with spre[c] <= a
    int c = 0;
    if (active) {
      int hi = cpb;
      while (hi - c > 1) {
        const int mid = (c + hi) >> 1;
        if (spre[mid] <= a) c = mid; else hi = mid;
      }
    }
    const int i = a - spre[c];
    const int cell = active ? cells[c] : -1;
    const bool busy = __any_sync(kAll, active);   // warp-uniform
    // inactive lanes of a busy warp walk with a NaN position
    T xi = quiet_nan<T>(), yi = xi, zi = xi, di = T(0);
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
    const short* my_slot = sslot + c * NNBR;
    int lo = lo0;

    for (int b0 = 0; b0 < rn; b0 += sh.nbc) {
      const int nb = min(sh.nbc, rn - b0);
      for (int s = t; s < nb; s += nthr) sjn[s] = 0;
      __syncthreads();
      // stage boxes [b0, b0 + nb) of the region, one record per slot
      for (int s = t; s < nb * A; s += nthr) {
        const int bl = s / A;
        const int j = s - bl * A;
        const size_t o =
            static_cast<size_t>(plan.region_box[rbeg + b0 + bl]) * A + j;
        Rec<T>* d = srec + bl * stride + j;
        copy_async(&d->x, r + o);
        copy_async(&d->y, r + plane + o);
        copy_async(&d->z, r + 2 * plane + o);
        if (PAIR == kEam3) copy_async(&d->w, dfe + o);
      }
      copy_async_wait_all();
      // a thread sees its own copies: count the staged boxes' used slots
      for (int s = t; s < nb * A; s += nthr) {
        const int bl = s / A;
        const int j = s - bl * A;
        if (occupied(srec[bl * stride + j].x)) atomicMax(&sjn[bl], j + 1);
      }
      __syncthreads();

      for (int k = 0; busy && k < NNBR; ++k) {
        const int q = my_slot[k] - b0;
        // a column outside this chunk is walked with a NaN position
        const bool in = static_cast<unsigned>(q) < static_cast<unsigned>(nb);
        const int base = in ? q * stride : 0;
        const T xk = in ? xi : quiet_nan<T>();
        const Rec<T>* rj = srec + base;
        // the warp walks the used slots of the fullest of its boxes
        const int jn = __reduce_max_sync(kAll, in ? sjn[q] : 0);
        // K2's self cell (column 0) takes only j > i
        const int jmin = (HALF && k == 0) ? i + 1 : 0;
        int j0 = 0;
        do {
          const int j1 = min(j0 + jt, jn);
          int j = j0;
          for (; j + 8 <= j1; j += 8) {
            // eight records loaded before any is tested
            Rec<T> v[8];
#pragma unroll
            for (int u = 0; u < 8; ++u) v[u] = rj[j + u];
            bool hit[8];
#pragma unroll
            for (int u = 0; u < 8; ++u) {
              const T r2 = dist2(xk - v[u].x, yi - v[u].y, zi - v[u].z);
              hit[u] = (!HALF || j + u >= jmin) && r2 <= rcut2 && r2 > T(0);
            }
#pragma unroll
            for (int u = 0; u < 8; ++u) {
              if (hit[u]) {
                slist[lo] = static_cast<unsigned short>(base + j + u);
                lo += nthr;
              }
            }
          }
          for (; j < j1; ++j)
            test_pair<T, HALF>(rj, j, jmin, base, xk, yi, zi, rcut2, slist,
                               lo, nthr);
          // drain when a list nears capacity, and after the last tile
          // (one call site: the pair function is inlined once)
          const bool last = k == NNBR - 1 && j1 == jn;
          if (__any_sync(kAll, last || lo > lo_full)) {
            const int cnt = (lo - lo0) / nthr;
            // K1: in the order found; K2: from another entry each lane
            const int m0 = HALF && cnt > 0 ? lane % cnt : 0;
            for (int m = 0; m < cnt; ++m) {
              int mm = m + m0;
              if (HALF && mm >= cnt) mm -= cnt;
              const int idx = slist[lo0 + mm * nthr];
              const Rec<T> v = srec[idx];
              const T dx = xi - v.x;
              const T dy = yi - v.y;
              const T dz = zi - v.z;
              const T r2 = dist2(dx, dy, dz);
              T sc[NS > 0 ? NS : 1];
              const T fc = pair_eval<T, PAIR, EVAL, ENERGY>(
                  cp, tp, lj, r2, di, PAIR == kEam3 ? v.w : T(0), sc);
              const T px = fc * dx, py = fc * dy, pz = fc * dz;
              fx += px;
              fy += py;
              fz += pz;
#pragma unroll
              for (int q = 0; q < NS; ++q) si[q] += sc[q];
              if constexpr (HALF) {
                T* acc = sacc + idx * NACC;
                if constexpr (sizeof(T) == 4) {
                  const float4 v =
                      make_float4(-px, -py, -pz, NS > 0 ? sc[0] : 0.f);
                  atomic_add4(acc, v);
                  if constexpr (NS > 1) atomicAdd(acc + 4, sc[1]);
                } else {
                  atomicAdd(acc, -px);
                  atomicAdd(acc + 1, -py);
                  atomicAdd(acc + 2, -pz);
#pragma unroll
                  for (int q = 0; q < NS; ++q) atomicAdd(acc + 3 + q, sc[q]);
                }
              }
            }
            lo = lo0;
          }
          j0 += jt;
        } while (j0 < jn);
      }

      if (HALF) {
        // the chunk's j side, once: one global atomic per non-zero value,
        // or in f32 one 16-byte vector atomic per four slots of a plane
        __syncthreads();
        constexpr bool kVec = sizeof(T) == 4;
        const int w = kVec && A % 4 == 0 ? 4 : 1;
        const int per_box = A / w;
        for (int s = t; s < NOUT * nb * per_box; s += nthr) {
          const int q = s / (nb * per_box);
          const int rest = s - q * nb * per_box;
          const int bl = rest / per_box;
          const int j = (rest - bl * per_box) * w;
          // output q of staged slots j .. j + w - 1
          T* acc = sacc + (bl * stride + j) * NACC + q;
          T* dst = out + q * oplane +
                   static_cast<size_t>(plan.region_box[rbeg + b0 + bl]) * A +
                   j;
          if constexpr (kVec) {
            if (w == 4) {
              const float4 v = make_float4(acc[0], acc[NACC], acc[2 * NACC],
                                           acc[3 * NACC]);
              if (v.x != 0.f || v.y != 0.f || v.z != 0.f || v.w != 0.f)
                atomicAdd(reinterpret_cast<float4*>(dst), v);
              continue;
            }
          }
          if (acc[0] != T(0)) atomicAdd(dst, acc[0]);
        }
      }
      __syncthreads();   // the chunk's records are read no more
      if (HALF) {   // zeroed for the next chunk or round
        for (int s = t; s < NACC * nslot; s += nthr) sacc[s] = T(0);
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
  const void* dfe;
  void* out;
  int n_local, n_boxes, A;
  Plan plan;
  double rcut2;
  const ChebParams* cheb;
  const TableParams* tab;
  const LjParams* lj;
  cudaStream_t stream;
  int* shape_out;   // non-null: report the launch shape, do not launch
};

template <typename T, int PAIR, int EVAL, bool ENERGY, bool HALF>
cudaError_t launch(const Launch& a) {
  constexpr int NOUT = 3 + n_scalars<PAIR, ENERGY>();
  constexpr int NNBR = HALF ? 14 : 27;
  auto kern = stencil_kernel<T, PAIR, EVAL, ENERGY, HALF>;
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  // the whole region if it fits, else as many boxes a chunk as fit
  const Shape one = make_shape<T, NOUT, HALF, NNBR>(a.A, a.plan.cpb, 1);
  if (one.nthr > kThreads || one.smem > static_cast<size_t>(max_smem))
    return cudaErrorInvalidValue;
  const size_t per_box = one.rec_bytes + one.acc_bytes;
  const size_t room = (max_smem - one.smem) / per_box + 1;
  const int nbc = room < static_cast<size_t>(a.plan.max_region)
                      ? static_cast<int>(room)
                      : a.plan.max_region;
  const Shape sh = make_shape<T, NOUT, HALF, NNBR>(a.A, a.plan.cpb, nbc);
  // raise the dynamic shared-memory limit once per instantiation and size
  static size_t smem_set = 0;
  if (sh.smem > smem_set) {
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(sh.smem));
    if (err != cudaSuccess) return err;
    smem_set = sh.smem;
  }
  if (a.shape_out != nullptr) {
    int blocks_per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks_per_sm, kern, sh.nthr, sh.smem);
    a.shape_out[0] = sh.nthr;
    a.shape_out[1] = sh.nbc;
    a.shape_out[2] = static_cast<int>(sh.smem);
    a.shape_out[3] = blocks_per_sm;
    a.shape_out[4] = sh.cap;
    return err;
  }
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
  if (a.plan.n_bricks > 0) {
    kern<<<a.plan.n_bricks, sh.nthr, sh.smem, a.stream>>>(
        static_cast<const T*>(a.r), static_cast<const T*>(a.dfe),
        static_cast<T*>(a.out), a.n_local, a.n_boxes, a.A, a.plan, sh,
        static_cast<T>(a.rcut2), cp, tp, lj);
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

// pair: 0 EAM pass 1, 1 EAM pass 3, 2 LJ; half: 0 K1 (full shell, 27
// neighbor columns), 1 K2 (half shell, 14, self first); dtype: 0 float, 1
// double; eval (EAM): 0 Chebyshev, 1 table.  The brick plan's arrays
// (cells, region_ptr, region_box, slot) come from ops/binning.BrickPlan
// for the same half flag.  shape_out:
// null to launch; else five ints (threads, boxes a chunk, shared bytes,
// blocks an SM, list capacity) are written and nothing runs.  Returns the
// launch's cudaError_t (0 on success); does not synchronize.
int comd_stencil(int pair, int half, int dtype, int eval, int want_energy,
                 const void* r, const void* dfe, void* out, int n_local,
                 int n_boxes, int A, const void* cells,
                 const void* region_ptr, const void* region_box,
                 const void* slot, int n_bricks, int cpb, int max_region,
                 double rcut2, const ChebParams* cheb,
                 const TableParams* tab, const LjParams* lj, void* stream,
                 int* shape_out) {
  const bool eam = pair == kEam1 || pair == kEam3;
  if ((pair != kEam1 && pair != kEam3 && pair != kLj) || A < 1 ||
      cpb < 1 || max_region < 1 ||
      (eam && eval == 0 && cheb == nullptr) ||
      (eam && eval == 1 && tab == nullptr) ||
      (pair == kLj && (lj == nullptr || eval != 0)) ||
      (pair == kEam3 && dfe == nullptr) ||
      (eam && eval == 0 &&
       (cheb->n_terms < 2 || cheb->n_terms > kMaxCheb)))
    return static_cast<int>(cudaErrorInvalidValue);
  Plan plan{static_cast<const int*>(cells),
            static_cast<const int*>(region_ptr),
            static_cast<const int*>(region_box),
            static_cast<const short*>(slot), n_bricks, cpb, max_region};
  Launch a{r, dfe, out, n_local, n_boxes, A, plan, rcut2,
           cheb, tab, lj, static_cast<cudaStream_t>(stream), shape_out};
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
