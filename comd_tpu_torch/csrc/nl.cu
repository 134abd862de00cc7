// Verlet neighbor lists for Hopper (sm_90a): the list build (NL1) and the
// list pair sweep (NL2), for EAM passes 1 and 3 and for LJ.
//
// comd_tpu computes both in XLA, not Pallas: NL1 replaces
// comd_tpu/ops/neighborlist.py::build, NL2 ::pair_sweep_nl.  They are the
// reference's own GPU kernels for the *_nl methods: the ballot/popc list
// build (gpu_kernels.cu:1494-2029) and the warp-per-atom list sweep
// (warp_atom_nl, gpu_eam_thread_atom.h:144-266).
//
// Layout: positions are the state's [3, B, A] planes (empty slots at the
// 1e10 sentinel); a list row is one compacted local atom, a_list[row] its
// flat slot id, and nl[row, 0..K-1] the flat slot ids of its j.
//
// NL1, one warp a row: the row's 27 boxes (nbr_map[box] in column order)
// are flattened to their occupied slots, min(n_atoms, A) a box, and the
// warp walks them 32 candidates at a time, lane = candidate, finding its
// box by a binary search over the warp's prefix sums (shuffles).  Each lane
// tests r2 <= (rcut + skin)^2 (and r2 > 0) with r2 rounded product by
// product (dist2), so the lists equal the plain version's bit for bit;
// __ballot_sync and __popc give each hit its rank, and the first K hits in
// candidate order (boxes in column order, slots ascending; an empty slot
// is never a hit) are written.  The rest of the row is padded with the
// row's own slot id, the row's full count is written, and a count above K
// on a valid row sets the overflow flag.  Invalid rows (past the real
// atoms) get an all-padding list and count 0.
//
// NL2, one warp a row (the warp_atom_nl analog): lanes stride over the K
// entries, gather r_j (and dfEmbed_j in EAM pass 3), test r2 <= rcut^2 and
// evaluate K1's own pair function (pair.cuh: pair_eval) on the pairs
// inside; each lane sums its own entries in order and a fixed xor-butterfly
// shuffle adds the 32 lanes, so every launch gives the same bits.  Invalid
// rows write zeros.  Outputs are per row, [3 + ns, R]: force, then the
// pass's scalars (EAM pass 1: [phi,] rho; LJ: [e]).
//
// What bounds them at the 63^3 EAM headline (A = 32 on 41^3 classic
// cells, R = 2.2 M rows of which 1.0 M are atoms, K = 96): NL1 writes the
// whole [R, K] list, 0.85 GB, against ~3 GFLOP of r2 tests, so bytes bound
// it (~0.26 ms); NL2 reads the real rows' lists, 0.38 GB, so bytes bound
// it too (~0.11 ms).  A simple first design: only ~45% of a warp's lanes
// hold an entry inside the cutoff in NL2's pair function.
//
// Plain C interface for ctypes: each entry point returns the cudaError_t
// of its launch (0 = success) and does not synchronize.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "pair.cuh"

constexpr int kRowsABlock = 8;   // warps, one row each, a block
constexpr unsigned kFull = 0xffffffffu;

namespace {

template <typename T>
__global__ void __launch_bounds__(32 * kRowsABlock)
nl_build_kernel(const T* __restrict__ r, int plane,
                const int* __restrict__ a_list,
                const unsigned char* __restrict__ a_valid,
                const int* __restrict__ nbr_map,
                const int* __restrict__ n_atoms, int n_rows, int A, int K,
                T rcut2, int* __restrict__ nl, int* __restrict__ count,
                int* __restrict__ overflow) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsABlock + (threadIdx.x >> 5);
  if (row >= n_rows) return;   // whole warps
  const int i = a_list[row];
  int* __restrict__ out = nl + static_cast<size_t>(row) * K;
  int n = 0;
  if (a_valid[row]) {
    const T xi = r[i], yi = r[plane + i], zi = r[2 * plane + i];
    // lane c < 27: column c's box, its occupied slots and the prefix end
    int nb = 0, cnt = 0;
    if (lane < 27) {
      nb = nbr_map[(i / A) * 27 + lane];
      cnt = min(n_atoms[nb], A);
    }
    int end = cnt;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(kFull, end, d);
      if (lane >= d) end += v;
    }
    const int total = __shfl_sync(kFull, end, 26);
    for (int base = 0; base < total; base += 32) {
      const int t = base + lane;
      // column of candidate t: the number of columns ending at or before t
      int c = 0;
#pragma unroll
      for (int step = 16; step > 0; step >>= 1) {
        const int probe = c + step - 1;
        const int e = __shfl_sync(kFull, end, probe < 27 ? probe : 26);
        if (probe < 27 && e <= t) c += step;
      }
      c = c < 27 ? c : 26;
      const int e_c = __shfl_sync(kFull, end, c);
      const int n_c = __shfl_sync(kFull, cnt, c);
      const int b_c = __shfl_sync(kFull, nb, c);
      const int j = b_c * A + (t - (e_c - n_c));
      bool hit = false;
      if (t < total) {
        const T r2 = dist2(xi - r[j], yi - r[plane + j], zi - r[2 * plane + j]);
        hit = r2 <= rcut2 && r2 > T(0);
      }
      const unsigned mask = __ballot_sync(kFull, hit);
      const int pos = n + __popc(mask & ((1u << lane) - 1u));
      if (hit && pos < K) out[pos] = j;
      n += __popc(mask);
    }
  }
  for (int p = min(n, K) + lane; p < K; p += 32) out[p] = i;
  if (lane == 0) {
    count[row] = n;
    if (n > K) *overflow = 1;
  }
}

template <typename T, int PAIR, int EVAL, bool ENERGY>
__global__ void __launch_bounds__(32 * kRowsABlock)
nl_sweep_kernel(const T* __restrict__ r, int plane,
                const T* __restrict__ dfe, const int* __restrict__ a_list,
                const unsigned char* __restrict__ a_valid,
                const int* __restrict__ nl, int n_rows, int K, T rcut2,
                const Cheb<T> cp, const Table<T> tp, const Lj<T> lj,
                T* __restrict__ out) {
  constexpr int NS = n_scalars<PAIR, ENERGY>();
  constexpr int NOUT = 3 + NS;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsABlock + (threadIdx.x >> 5);
  if (row >= n_rows) return;   // whole warps
  T acc[NOUT];
#pragma unroll
  for (int q = 0; q < NOUT; ++q) acc[q] = T(0);
  if (a_valid[row]) {
    const int i = a_list[row];
    const T xi = r[i], yi = r[plane + i], zi = r[2 * plane + i];
    const T di = PAIR == kEam3 ? dfe[i] : T(0);
    const int* __restrict__ lst = nl + static_cast<size_t>(row) * K;
    for (int k = lane; k < K; k += 32) {
      const int j = lst[k];
      const T dx = xi - r[j], dy = yi - r[plane + j],
              dz = zi - r[2 * plane + j];
      const T r2 = dist2(dx, dy, dz);
      if (r2 <= rcut2 && r2 > T(0)) {
        T sc[NS > 0 ? NS : 1];
        const T dj = PAIR == kEam3 ? dfe[j] : T(0);
        const T fc = pair_eval<T, PAIR, EVAL, ENERGY>(cp, tp, lj, r2, di, dj,
                                                      sc);
        acc[0] += fc * dx;
        acc[1] += fc * dy;
        acc[2] += fc * dz;
#pragma unroll
        for (int q = 0; q < NS; ++q) acc[3 + q] += sc[q];
      }
    }
#pragma unroll
    for (int q = 0; q < NOUT; ++q) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[q] += __shfl_xor_sync(kFull, acc[q], off);
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int q = 0; q < NOUT; ++q)
      out[static_cast<size_t>(q) * n_rows + row] = acc[q];
  }
}

int n_blocks(int n_rows) { return (n_rows + kRowsABlock - 1) / kRowsABlock; }

template <typename T>
cudaError_t launch_build(const void* r, int plane, const void* a_list,
                         const void* a_valid, const void* nbr_map,
                         const void* n_atoms, int n_rows, int A, int K,
                         double rcut2, void* nl, void* count, void* overflow,
                         cudaStream_t stream) {
  if (n_rows > 0) {
    nl_build_kernel<T><<<n_blocks(n_rows), 32 * kRowsABlock, 0, stream>>>(
        static_cast<const T*>(r), plane, static_cast<const int*>(a_list),
        static_cast<const unsigned char*>(a_valid),
        static_cast<const int*>(nbr_map), static_cast<const int*>(n_atoms),
        n_rows, A, K, static_cast<T>(rcut2), static_cast<int*>(nl),
        static_cast<int*>(count), static_cast<int*>(overflow));
  }
  return cudaGetLastError();
}

struct Sweep {
  const void* r;
  int plane;
  const void* dfe;
  const void* a_list;
  const void* a_valid;
  const void* nl;
  int n_rows, K;
  double rcut2;
  const ChebParams* cheb;
  const TableParams* tab;
  const LjParams* lj;
  void* out;
  cudaStream_t stream;
};

template <typename T, int PAIR, int EVAL, bool ENERGY>
cudaError_t launch_sweep(const Sweep& a) {
  Cheb<T> cp{};
  Table<T> tp{};
  Lj<T> lj{};
  round_params<T, PAIR, EVAL>(a.cheb, a.tab, a.lj, cp, tp, lj);
  if (a.n_rows > 0) {
    nl_sweep_kernel<T, PAIR, EVAL, ENERGY>
        <<<n_blocks(a.n_rows), 32 * kRowsABlock, 0, a.stream>>>(
            static_cast<const T*>(a.r), a.plane, static_cast<const T*>(a.dfe),
            static_cast<const int*>(a.a_list),
            static_cast<const unsigned char*>(a.a_valid),
            static_cast<const int*>(a.nl), a.n_rows, a.K,
            static_cast<T>(a.rcut2), cp, tp, lj, static_cast<T*>(a.out));
  }
  return cudaGetLastError();
}

template <typename T, int EVAL>
cudaError_t dispatch_pair(int pair, int want_energy, const Sweep& a) {
  if (pair == kEam3) return launch_sweep<T, kEam3, EVAL, false>(a);
  if (pair == kEam1) {
    if (want_energy) return launch_sweep<T, kEam1, EVAL, true>(a);
    return launch_sweep<T, kEam1, EVAL, false>(a);
  }
  if (EVAL != 0) return cudaErrorInvalidValue;   // LJ has one evaluator
  if (want_energy) return launch_sweep<T, kLj, 0, true>(a);
  return launch_sweep<T, kLj, 0, false>(a);
}

template <typename T>
cudaError_t dispatch_eval(int eval, int pair, int want_energy,
                          const Sweep& a) {
  if (eval == 0) return dispatch_pair<T, 0>(pair, want_energy, a);
  return dispatch_pair<T, 1>(pair, want_energy, a);
}

}  // namespace

extern "C" {

// NL1.  dtype: 0 float, 1 double.  r [3, plane] positions, a_list [n_rows]
// int32, a_valid [n_rows] bool, nbr_map [n_local, 27] int32, n_atoms [B]
// int32; writes nl [n_rows, K] int32 and count [n_rows] int32, and sets
// *overflow (an int32 the caller zeroed) to 1 when a valid row has more
// than K entries.  rcut2 is (rcut + skin)^2 already rounded to dtype.
int comd_nl_build(int dtype, const void* r, int plane, const void* a_list,
                  const void* a_valid, const void* nbr_map,
                  const void* n_atoms, int n_rows, int A, int K,
                  double rcut2, void* nl, void* count, void* overflow,
                  void* stream) {
  if (A < 1 || K < 1 || n_rows < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_build<float>(r, plane, a_list, a_valid, nbr_map, n_atoms,
                               n_rows, A, K, rcut2, nl, count, overflow, s);
  if (dtype == 1)
    return launch_build<double>(r, plane, a_list, a_valid, nbr_map, n_atoms,
                                n_rows, A, K, rcut2, nl, count, overflow, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// NL2.  pair: 0 EAM pass 1, 1 EAM pass 3, 2 LJ; dtype: 0 float, 1 double;
// eval (EAM): 0 Chebyshev, 1 table.  dfe [plane] is EAM pass 3's
// halo-filled dfEmbed.  Writes out [3 + ns, n_rows]; rcut2 is the pair
// cutoff squared, rounded to dtype.
int comd_nl_sweep(int pair, int dtype, int eval, int want_energy,
                  const void* r, int plane, const void* dfe,
                  const void* a_list, const void* a_valid, const void* nl,
                  int n_rows, int K, double rcut2, const ChebParams* cheb,
                  const TableParams* tab, const LjParams* lj, void* out,
                  void* stream) {
  const bool eam = pair == kEam1 || pair == kEam3;
  if ((pair != kEam1 && pair != kEam3 && pair != kLj) || K < 1 ||
      n_rows < 0 || (eam && eval == 0 && cheb == nullptr) ||
      (eam && eval == 1 && tab == nullptr) ||
      (pair == kLj && (lj == nullptr || eval != 0)) ||
      (pair == kEam3 && dfe == nullptr) ||
      (eam && eval == 0 &&
       (cheb->n_terms < 2 || cheb->n_terms > kMaxCheb)))
    return static_cast<int>(cudaErrorInvalidValue);
  Sweep a{r, plane, dfe, a_list, a_valid, nl, n_rows, K, rcut2,
          cheb, tab, lj, out, static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return dispatch_eval<float>(eval, pair, want_energy, a);
  if (dtype == 1) return dispatch_eval<double>(eval, pair, want_energy, a);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* comd_nl_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
