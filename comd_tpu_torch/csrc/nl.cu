// Verlet neighbor lists for Hopper (sm_90a): the build's rows (NR), the
// list build (NL1) and the list pair sweep (NL2), for EAM passes 1 and 3
// and for LJ.
//
// comd_tpu computes all three in XLA, not Pallas: NR replaces
// comd_tpu/ops/neighborlist.py::build_atom_list and
// ::build_atom_list_split (a cumsum compaction), NL1 ::build, NL2
// ::pair_sweep_nl.  NL1 and NL2 are the reference's own GPU kernels for
// the *_nl methods: the ballot/popc list build (gpu_kernels.cu:1494-2029)
// and the warp-per-atom list sweep (warp_atom_nl,
// gpu_eam_thread_atom.h:144-266).
//
// Layout: positions are the state's [3, B, A] planes (empty slots at the
// 1e10 sentinel); a list row is one compacted local atom, a_list[row] its
// flat slot id, and nl[row, 0..K-1] the flat slot ids of its j, the first
// min(count, K) real and the rest padding (the row's own slot id).  The
// valid rows of a cell are contiguous, in slot order, and row_start[cell]
// is the row of its slot 0 (NR writes both; with the -a 1 row split the
// interior cells' rows first, the boundary cells' from Ri).
//
// NR, two launches (a build a shard; the plain version is
// ops/neighborlist.py::nl_rows_plain):
//  - nl_rows_scan_kernel, one block of 1024 threads: each thread sums
//    min(n_atoms, A) over a contiguous chunk of the local cells (interior
//    and boundary apart), a block scan by shuffles gives each chunk its
//    start, and a second pass over the chunk writes row_start; the last
//    thread writes the two segments' row counts.  68,921 cells at the 63^3
//    headline are ~67 a thread, read from L1 on the second pass;
//  - nl_rows_fill_kernel, a grid over max(local slots, rows): slot (c, s)
//    with s < min(n_atoms[c], A) writes a_list[row] = c A + s and
//    a_valid[row] = 1 at row = row_start[c] + s below R; a row past its
//    segment's count writes 0 and 0.  The two roles touch disjoint rows.
//  Two launches, not one: the fill needs every cell's start and the
//  counts, which exist only when the whole scan is done; a single launch
//  would need a grid-wide wait (a look-back chain or a cooperative grid),
//  while the scan is small enough for one block and the fill's bytes
//  (~20 MB at 63^3) want the whole card.
//
// What bounds them at the 63^3 EAM headline (A = 32 on 41^3 classic
// cells, R = 2.2 M rows of which 1.0 M are atoms, K = 96, ~391 occupied
// candidates, ~54 list entries and ~43 pairs inside the cutoff a row):
// NL1 writes the whole [R, K] list, 0.85 GB (0.46 GB of it the padding of
// invalid rows), so bytes bound it (~0.27 ms); NL2 needs the real entries
// of the lists, ~0.22 GB, the positions and its outputs (~0.09 ms by
// bytes; chip_smoke.py's nl_bound).
//
// NL1, one block per local cell (plus blocks that pad the invalid rows):
//  - the cell's 27 boxes (nbr_map in column order) and the prefix sums of
//    their occupied slots, min(n_atoms, A) a box, are computed once;
//  - the occupied candidates' positions are staged with cp.async in
//    candidate order (boxes in column order, slots ascending), with their
//    slot ids, in chunks of at most kStageMax (27 A can exceed it: 5-sigma
//    LJ has A = 256), so each of the cell's ~14.5 rows reads a candidate
//    with one shared load instead of repeating a search, shuffles and
//    three global gathers a candidate for every row;
//  - a warp walks kBuildRows of the cell's rows at once, 32 staged
//    candidates at a time (one shared load serves both rows), tests
//    0 < r2 <= (rcut + skin)^2 with r2 rounded product by product (dist2),
//    ranks each row's hits with __ballot_sync/__popc and writes its first
//    K in candidate order; the running counts stay in shared memory
//    across chunks.  The rest of a row is padded with its own slot id,
//    the full count is written, and a count above K sets the overflow
//    flag.  The lists equal the plain version's bit for bit;
//  - invalid rows (past the real atoms) get slot id a_list[row] (0) in
//    every entry with 16-byte stores and count 0, kPadRows rows a block.
//
// NL2, a small kernel and the sweep, one call:
//  - nl_pack_kernel writes each slot's x, y, z (and EAM pass 3's dfEmbed)
//    as one 16-byte record (32 in double), so a j costs one gather, not
//    three or four;
//  - the sweep gives a warp kRowsAWarp consecutive rows and walks them
//    together: each step loads the next 32 entries of every open row,
//    then issues all their gathers, then tests them, so a warp has four
//    rows' loads in flight at once;
//  - a row ends at the first step holding padding (padding sits only at
//    a row's tail, and no real entry is the row's own slot id, since the
//    build needs r2 > 0), so a row of ~54 entries reads 2 chunks of
//    K = 96's 3;
//  - the entries with 0 < r2 <= rcut^2 are ranked with ballot/popc and
//    appended, as (dx, dy, dz, dfEmbed_i + dfEmbed_j), to their row's ring
//    of kQueue in shared memory;
//  - the warp drains when every open row has kLanesARow pairs queued (or a
//    ring nears full, and at the end): lanes grp * kLanesARow + sub
//    evaluate row grp's next pairs with K1's own pair function (pair.cuh:
//    pair_eval, on r2 = dist2(dx, dy, dz), the walk's bits), so the pair
//    function runs with nearly every lane busy (testing in place would
//    leave ~55% of them idle) and each lane sums one row only;
//  - each row's sum is its lanes' sums in queue order, then a fixed xor
//    butterfly over its kLanesARow lanes: one bit pattern on every launch;
//  - no block-wide barrier: a warp writes its rows' [3 + ns] outputs
//    itself (zeros for a warp without a valid row).
// Outputs are per row, [3 + ns, R]: force, then the pass's scalars (EAM
// pass 1: [phi,] rho; LJ: [e]).  EAM runs with each of K1's evaluators,
// the -P spline included (pair.cuh; the drain is the same, only the pair
// function differs); LJ with the analytic pair only, as comd_tpu's list
// paths ignore -I.
//
// Plain C interface for ctypes: each entry point returns the cudaError_t
// of its launch (0 = success) and does not synchronize.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "pair.cuh"

constexpr unsigned kFull = 0xffffffffu;
constexpr int kBuildWarps = 4;     // NL1: warps of a cell's block
constexpr int kBuildRows = 2;      // NL1: rows a warp walks at once
constexpr int kStageMax = 1024;    // NL1: candidates staged a chunk
constexpr int kPadRows = 64;       // NL1: rows a padding block
constexpr int kSweepWarps = 4;     // NL2: warps a block
constexpr int kRowsAWarp = 4;      // NL2: consecutive rows a warp
constexpr int kQueue = 64;         // NL2: ring of queued pairs a row
constexpr int kLanesARow = 32 / kRowsAWarp;   // NL2: a row's drain lanes

namespace {

// The padding of invalid rows [row0, row0 + kPadRows): every entry the
// row's slot id, count 0.  A block without an invalid row exits.
__device__ __forceinline__ void pad_rows(int row0, const int* a_list,
                                         const unsigned char* a_valid,
                                         int n_rows, int K, int* nl,
                                         int* count, int* spad) {
  const int t = threadIdx.x;
  const int row = row0 + t;
  bool inv = false;
  if (t < kPadRows) {
    spad[t] = -1;   // a valid row, or past the rows: not written
    if (row < n_rows && !a_valid[row]) {
      inv = true;
      spad[t] = a_list[row];
      count[row] = 0;
    }
  }
  if (!__syncthreads_or(inv)) return;
  const int rows = min(kPadRows, n_rows - row0);
  int* base = nl + static_cast<size_t>(row0) * K;
  if (K % 4 == 0) {
    for (int u = t; u < rows * K / 4; u += blockDim.x) {
      const int v = spad[u * 4 / K];
      if (v >= 0) reinterpret_cast<int4*>(base)[u] = make_int4(v, v, v, v);
    }
  } else {
    for (int e = t; e < rows * K; e += blockDim.x) {
      const int v = spad[e / K];
      if (v >= 0) base[e] = v;
    }
  }
}

constexpr int kScanThreads = 1024;  // NR: the scan's one block

// NR's scan (see the header): row_start [n_local] and counts [2] (the
// interior, or every, cell's rows; the boundary cells' rows).  is_b null:
// no row split.
__global__ void __launch_bounds__(kScanThreads)
nl_rows_scan_kernel(const int* __restrict__ n_atoms,
                    const unsigned char* __restrict__ is_b, int n_local,
                    int A, int ri, int* __restrict__ row_start,
                    int* __restrict__ counts) {
  __shared__ int part_i[kScanThreads / 32], part_b[kScanThreads / 32];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int chunk = (n_local + kScanThreads - 1) / kScanThreads;
  const int c0 = min(t * chunk, n_local);
  const int c1 = min(c0 + chunk, n_local);
  int si = 0, sb = 0;
  for (int c = c0; c < c1; ++c) {
    const int n = min(max(n_atoms[c], 0), A);
    if (is_b != nullptr && is_b[c]) sb += n; else si += n;
  }
  int xi = si, xb = sb;   // inclusive scans over the warp's lanes
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int vi = __shfl_up_sync(kFull, xi, d);
    const int vb = __shfl_up_sync(kFull, xb, d);
    if (lane >= d) {
      xi += vi;
      xb += vb;
    }
  }
  if (lane == 31) {
    part_i[warp] = xi;
    part_b[warp] = xb;
  }
  __syncthreads();
  if (warp == 0) {        // inclusive scans over the warps' totals
    int wi = part_i[lane], wb = part_b[lane];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int vi = __shfl_up_sync(kFull, wi, d);
      const int vb = __shfl_up_sync(kFull, wb, d);
      if (lane >= d) {
        wi += vi;
        wb += vb;
      }
    }
    part_i[lane] = wi;
    part_b[lane] = wb;
  }
  __syncthreads();
  int run_i = xi - si + (warp > 0 ? part_i[warp - 1] : 0);
  int run_b = xb - sb + (warp > 0 ? part_b[warp - 1] : 0) + ri;
  for (int c = c0; c < c1; ++c) {
    const int n = min(max(n_atoms[c], 0), A);
    if (is_b != nullptr && is_b[c]) {
      row_start[c] = run_b;
      run_b += n;
    } else {
      row_start[c] = run_i;
      run_i += n;
    }
  }
  if (t == kScanThreads - 1) {
    counts[0] = part_i[kScanThreads / 32 - 1];
    counts[1] = part_b[kScanThreads / 32 - 1];
  }
}

// NR's fill (see the header): rows [0, ri) hold the interior (or every)
// cell's rows, [ri, n_rows) the boundary cells'; n_local * A < 2^31.
__global__ void __launch_bounds__(256)
nl_rows_fill_kernel(const int* __restrict__ n_atoms,
                    const int* __restrict__ row_start,
                    const int* __restrict__ counts, int n_local, int A,
                    int n_rows, int ri, int* __restrict__ a_list,
                    unsigned char* __restrict__ a_valid) {
  const int n_slots = n_local * A;
  const int n = max(n_slots, n_rows);
  const int stride = gridDim.x * blockDim.x;
  const int count_i = counts[0];
  const int count_b = counts[1];
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    if (i < n_slots) {
      const int c = i / A;
      const int s = i - c * A;
      if (s < min(n_atoms[c], A)) {
        const int row = row_start[c] + s;
        if (row < n_rows) {
          a_list[row] = i;
          a_valid[row] = 1;
        }
      }
    }
    if (i < n_rows && (i < ri ? i >= count_i : i - ri >= count_b)) {
      a_list[i] = 0;
      a_valid[i] = 0;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(32 * kBuildWarps)
nl_build_kernel(const T* __restrict__ r, int plane,
                const int* __restrict__ a_list,
                const unsigned char* __restrict__ a_valid,
                const int* __restrict__ nbr_map,
                const int* __restrict__ n_atoms,
                const int* __restrict__ row_start, int n_local, int n_rows,
                int A, int K, int cap, T rcut2, int* __restrict__ nl,
                int* __restrict__ count, int* __restrict__ overflow) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int sbox[27], spre[28], spad[kPadRows];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  if (blockIdx.x >= n_local) {
    pad_rows((blockIdx.x - n_local) * kPadRows, a_list, a_valid, n_rows, K,
             nl, count, spad);
    return;
  }
  const int c = blockIdx.x;
  const int n_c = min(n_atoms[c], A);
  if (n_c <= 0) return;
  Rec<T>* srec = reinterpret_cast<Rec<T>*>(smem_raw);   // [cap] positions
  int* sj = reinterpret_cast<int*>(srec + cap);         // [cap] slot ids
  int* sn = sj + cap;                                   // [A] hits a row
  if (warp == 0) {
    // lane b < 27: column b's box and the end of its occupied slots
    int nb = 0, end = 0;
    if (lane < 27) {
      nb = nbr_map[c * 27 + lane];
      end = min(n_atoms[nb], A);
    }
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(kFull, end, d);
      if (lane >= d) end += v;
    }
    if (lane < 27) {
      sbox[lane] = nb;
      spre[lane + 1] = end;
    }
    if (lane == 0) spre[0] = 0;
  }
  for (int a = t; a < n_c; a += blockDim.x) sn[a] = 0;
  __syncthreads();
  const int total = spre[27];
  const int rs = row_start[c];

  for (int c0 = 0; c0 < total; c0 += cap) {
    const int nc = min(cap, total - c0);
    // stage candidates [c0, c0 + nc): box b holds [spre[b], spre[b + 1])
    for (int s = t; s < nc; s += blockDim.x) {
      const int idx = c0 + s;
      int b = 0;   // the last column with spre[b] <= idx
#pragma unroll
      for (int step = 16; step > 0; step >>= 1)
        if (b + step < 27 && spre[b + step] <= idx) b += step;
      const int j = sbox[b] * A + (idx - spre[b]);
      Rec<T>* d = srec + s;
      copy_async(&d->x, r + j);
      copy_async(&d->y, r + plane + j);
      copy_async(&d->z, r + 2 * plane + j);
      sj[s] = j;
    }
    copy_async_wait_all();
    __syncthreads();
    // a warp walks kBuildRows rows of the cell at once: one shared load
    // a candidate serves them all
    for (int a0 = warp * kBuildRows; a0 < n_c;
         a0 += kBuildWarps * kBuildRows) {
      bool ok[kBuildRows];
      T xi[kBuildRows], yi[kBuildRows], zi[kBuildRows];
      int n[kBuildRows];
      int* out[kBuildRows];
#pragma unroll
      for (int b = 0; b < kBuildRows; ++b) {
        const int a = a0 + b;
        const int row = rs + a;
        const int i = c * A + a;
        ok[b] = a < n_c && row < n_rows && a_valid[row] && a_list[row] == i;
        xi[b] = yi[b] = zi[b] = T(0);
        n[b] = 0;
        out[b] = nl + static_cast<size_t>(ok[b] ? row : 0) * K;
        if (ok[b]) {
          xi[b] = r[i];
          yi[b] = r[plane + i];
          zi[b] = r[2 * plane + i];
          n[b] = sn[a];
        }
      }
      for (int base = 0; base < nc; base += 32) {
        const int s = base + lane;
        Rec<T> v{};
        if (s < nc) v = srec[s];
#pragma unroll
        for (int b = 0; b < kBuildRows; ++b) {
          const T r2 = dist2(xi[b] - v.x, yi[b] - v.y, zi[b] - v.z);
          const bool hit = ok[b] && s < nc && r2 <= rcut2 && r2 > T(0);
          const unsigned mask = __ballot_sync(kFull, hit);
          const int pos = n[b] + __popc(mask & ((1u << lane) - 1u));
          if (hit && pos < K) out[b][pos] = sj[s];
          n[b] += __popc(mask);
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int b = 0; b < kBuildRows; ++b)
          if (ok[b]) sn[a0 + b] = n[b];
      }
    }
    __syncthreads();   // the chunk is read no more
  }

  for (int a = warp; a < n_c; a += kBuildWarps) {
    const int row = rs + a;
    const int i = c * A + a;
    if (row >= n_rows || !a_valid[row] || a_list[row] != i) continue;
    const int n = sn[a];
    int* __restrict__ out = nl + static_cast<size_t>(row) * K;
    for (int p = min(n, K) + lane; p < K; p += 32) out[p] = i;
    if (lane == 0) {
      count[row] = n;
      if (n > K) *overflow = 1;
    }
  }
}

// NL2's gather records: slot s of [3, plane] positions (and EAM pass 3's
// dfEmbed) as one 16-byte record (32 in double), so that a j costs one
// gather instead of three or four.
template <typename T>
__global__ void __launch_bounds__(256)
nl_pack_kernel(const T* __restrict__ r, int plane, const T* __restrict__ dfe,
               Rec<T>* __restrict__ rec) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s < plane)
    rec[s] = Rec<T>{r[s], r[plane + s], r[2 * plane + s],
                    dfe != nullptr ? dfe[s] : T(0)};
}

template <typename T, int PAIR, int EVAL, bool ENERGY>
__global__ void __launch_bounds__(32 * kSweepWarps)
nl_sweep_kernel(const Rec<T>* __restrict__ rec,
                const int* __restrict__ a_list,
                const unsigned char* __restrict__ a_valid,
                const int* __restrict__ nl, int n_rows, int K, T rcut2,
                const Cheb<T> cp, const Table<T> tp, const Lj<T> lj,
                const Spline<T> sp, T* __restrict__ out) {
  constexpr int NS = n_scalars<PAIR, ENERGY>();
  constexpr int NOUT = 3 + NS;
  static_assert(NOUT <= kLanesARow, "a row's lanes write its outputs");
  __shared__ Rec<T> squeue[kSweepWarps][kRowsAWarp][kQueue];
  __shared__ Rec<T> srow[kSweepWarps][kRowsAWarp];   // r_i, dfEmbed_i
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int grp = lane / kLanesARow;   // the row this lane drains
  const int sub = lane % kLanesARow;
  Rec<T>(*queue)[kQueue] = squeue[warp];
  T acc[NOUT];
#pragma unroll
  for (int q = 0; q < NOUT; ++q) acc[q] = T(0);
  // row u's queued pairs are [head[u], tail[u]), at index & (kQueue - 1)
  int head[kRowsAWarp], tail[kRowsAWarp];
#pragma unroll
  for (int u = 0; u < kRowsAWarp; ++u) head[u] = tail[u] = 0;
  // lanes grp * kLanesARow + sub evaluate row grp's next pairs, up to
  // kLanesARow a row; then the heads move past them
  auto drain = [&]() {
    int h = head[0], n = tail[0] - head[0];
#pragma unroll
    for (int u = 1; u < kRowsAWarp; ++u) {
      if (grp == u) {
        h = head[u];
        n = tail[u] - head[u];
      }
    }
    if (sub < n) {
      const Rec<T> v = queue[grp][(h + sub) & (kQueue - 1)];
      const T r2 = dist2(v.x, v.y, v.z);
      T sc[NS > 0 ? NS : 1];
      const T fc = pair_eval<T, PAIR, EVAL, ENERGY>(cp, tp, lj, sp, r2, v.w,
                                                    T(0), sc);
      acc[0] += fc * v.x;
      acc[1] += fc * v.y;
      acc[2] += fc * v.z;
#pragma unroll
      for (int q = 0; q < NS; ++q) acc[3 + q] += sc[q];
    }
#pragma unroll
    for (int u = 0; u < kRowsAWarp; ++u)
      head[u] += min(kLanesARow, tail[u] - head[u]);
    __syncwarp();   // the drained entries may be overwritten
  };

  // lane u < kRowsAWarp: row u of the warp, its slot id and r_i
  const int rbase = (blockIdx.x * kSweepWarps + warp) * kRowsAWarp;
  int i_l = 0;
  bool v_l = false;
  if (lane < kRowsAWarp && rbase + lane < n_rows && a_valid[rbase + lane]) {
    v_l = true;
    i_l = a_list[rbase + lane];
    srow[warp][lane] = rec[i_l];
  }
  // the rows still walking their lists (warp-uniform)
  unsigned open = __ballot_sync(kFull, v_l) & ((1u << kRowsAWarp) - 1u);
  int ids[kRowsAWarp];
#pragma unroll
  for (int u = 0; u < kRowsAWarp; ++u) ids[u] = __shfl_sync(kFull, i_l, u);
  __syncwarp();
  // one step: the next 32 entries of every open row, all loads issued
  // before any is tested
  for (int base = 0; open != 0 && base < K; base += 32) {
    const int k = base + lane;
    int j[kRowsAWarp];
#pragma unroll
    for (int u = 0; u < kRowsAWarp; ++u)
      j[u] = ((open >> u) & 1u) && k < K
                 ? nl[static_cast<size_t>(rbase + u) * K + k]
                 : ids[u];
    T dx[kRowsAWarp], dy[kRowsAWarp], dz[kRowsAWarp], dj[kRowsAWarp];
#pragma unroll
    for (int u = 0; u < kRowsAWarp; ++u) {
      dx[u] = dy[u] = dz[u] = dj[u] = T(0);
      if (j[u] != ids[u]) {
        const Rec<T> ri = srow[warp][u];
        const Rec<T> rj = rec[j[u]];
        dx[u] = ri.x - rj.x;
        dy[u] = ri.y - rj.y;
        dz[u] = ri.z - rj.z;
        if (PAIR == kEam3) dj[u] = ri.w + rj.w;
      }
    }
    bool full = false;   // a row's ring could not take another step
    bool ready = true;   // every row has a drain's worth, or has ended
#pragma unroll
    for (int u = 0; u < kRowsAWarp; ++u) {
      const bool pad = j[u] == ids[u];
      const T r2 = dist2(dx[u], dy[u], dz[u]);
      const bool hit = !pad && r2 <= rcut2 && r2 > T(0);
      const unsigned mask = __ballot_sync(kFull, hit);
      if (hit) {
        queue[u][(tail[u] + __popc(mask & ((1u << lane) - 1u))) &
                 (kQueue - 1)] = Rec<T>{dx[u], dy[u], dz[u], dj[u]};
      }
      tail[u] += __popc(mask);
      if (__ballot_sync(kFull, pad)) open &= ~(1u << u);   // the row's end
      full = full || tail[u] - head[u] > kQueue - 32 - kLanesARow;
      ready = ready && (tail[u] - head[u] >= kLanesARow ||
                        !((open >> u) & 1u));
    }
    __syncwarp();
    // drain while every row fills its lanes, and while a ring is too
    // full for the next step's appends (fewer than kQueue - 32 stay)
    while (full || (ready && open != 0)) {
      drain();
      full = ready = false;
#pragma unroll
      for (int u = 0; u < kRowsAWarp; ++u) {
        full = full || tail[u] - head[u] > kQueue - 32 - kLanesARow;
      }
      ready = true;
#pragma unroll
      for (int u = 0; u < kRowsAWarp; ++u) {
        ready = ready && (tail[u] - head[u] >= kLanesARow ||
                          !((open >> u) & 1u));
      }
    }
  }
  // the rest, kLanesARow a row at a time
  for (;;) {
    bool left = false;
#pragma unroll
    for (int u = 0; u < kRowsAWarp; ++u) left = left || tail[u] > head[u];
    if (!left) break;
    drain();
  }

  // each row's sums over its lanes (a fixed xor butterfly); lane
  // grp * kLanesARow + q writes output q of row grp
#pragma unroll
  for (int q = 0; q < NOUT; ++q) {
#pragma unroll
    for (int off = kLanesARow / 2; off > 0; off >>= 1)
      acc[q] += __shfl_xor_sync(kFull, acc[q], off);
  }
  T mine = acc[0];
#pragma unroll
  for (int q = 1; q < NOUT; ++q) {
    if (sub == q) mine = acc[q];
  }
  if (sub < NOUT && rbase + grp < n_rows)
    out[static_cast<size_t>(sub) * n_rows + rbase + grp] = mine;
}

template <typename T>
cudaError_t launch_build(const void* r, int plane, const void* a_list,
                         const void* a_valid, const void* nbr_map,
                         const void* n_atoms, const void* row_start,
                         int n_local, int n_rows, int A, int K, double rcut2,
                         void* nl, void* count, void* overflow,
                         cudaStream_t stream) {
  auto kern = nl_build_kernel<T>;
  const int cap = 27 * A < kStageMax ? 27 * A : kStageMax;
  const size_t smem =
      static_cast<size_t>(cap) * (sizeof(Rec<T>) + sizeof(int)) +
      static_cast<size_t>(A) * sizeof(int);
  // raise the dynamic shared-memory limit once per precision and size
  static size_t smem_set = 48 * 1024;
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    smem_set = smem;
  }
  const long long blocks =
      n_local + (static_cast<long long>(n_rows) + kPadRows - 1) / kPadRows;
  if (blocks > 0) {
    kern<<<static_cast<unsigned>(blocks), 32 * kBuildWarps, smem, stream>>>(
        static_cast<const T*>(r), plane, static_cast<const int*>(a_list),
        static_cast<const unsigned char*>(a_valid),
        static_cast<const int*>(nbr_map), static_cast<const int*>(n_atoms),
        static_cast<const int*>(row_start), n_local, n_rows, A, K, cap,
        static_cast<T>(rcut2), static_cast<int*>(nl),
        static_cast<int*>(count), static_cast<int*>(overflow));
  }
  return cudaGetLastError();
}

struct Sweep {
  const void* r;
  int plane;
  const void* dfe;
  void* rec;
  const void* a_list;
  const void* a_valid;
  const void* nl;
  int n_rows, K;
  double rcut2;
  const ChebParams* cheb;
  const TableParams* tab;
  const LjParams* lj;
  const SplineParams* spline;
  void* out;
  cudaStream_t stream;
};

template <typename T, int PAIR, int EVAL, bool ENERGY>
cudaError_t launch_sweep(const Sweep& a) {
  Cheb<T> cp{};
  Table<T> tp{};
  Lj<T> lj{};
  Spline<T> sp{};
  round_params<T, PAIR, EVAL>(a.cheb, a.tab, a.lj, a.spline, cp, tp, lj, sp);
  if (a.n_rows > 0) {
    Rec<T>* rec = static_cast<Rec<T>*>(a.rec);
    nl_pack_kernel<T><<<(a.plane + 255) / 256, 256, 0, a.stream>>>(
        static_cast<const T*>(a.r), a.plane,
        PAIR == kEam3 ? static_cast<const T*>(a.dfe) : nullptr, rec);
    constexpr int rows = kSweepWarps * kRowsAWarp;
    nl_sweep_kernel<T, PAIR, EVAL, ENERGY>
        <<<(a.n_rows + rows - 1) / rows, 32 * kSweepWarps, 0,
           a.stream>>>(
            rec, static_cast<const int*>(a.a_list),
            static_cast<const unsigned char*>(a.a_valid),
            static_cast<const int*>(a.nl), a.n_rows, a.K,
            static_cast<T>(a.rcut2), cp, tp, lj, sp, static_cast<T*>(a.out));
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
  // LJ on the lists is the analytic pair only: comd_tpu's NL paths
  // ignore -I
  if (EVAL != 0) return cudaErrorInvalidValue;
  if (want_energy) return launch_sweep<T, kLj, 0, true>(a);
  return launch_sweep<T, kLj, 0, false>(a);
}

template <typename T>
cudaError_t dispatch_eval(int eval, int pair, int want_energy,
                          const Sweep& a) {
  if (eval == 0) return dispatch_pair<T, 0>(pair, want_energy, a);
  if (eval == 1) return dispatch_pair<T, 1>(pair, want_energy, a);
  return dispatch_pair<T, 2>(pair, want_energy, a);
}

}  // namespace

extern "C" {

// NR.  n_atoms [>= n_local] int32, is_boundary [n_local] bool or null (no
// row split; then ri = n_rows); writes a_list [n_rows] int32, a_valid
// [n_rows] bool, row_start [n_local] int32 and counts [2] int32 (scratch
// the fill reads), two launches on `stream`.
int comd_nl_rows(const void* n_atoms, const void* is_boundary, int n_local,
                 int A, int n_rows, int ri, void* a_list, void* a_valid,
                 void* row_start, void* counts, int grid, void* stream) {
  if (A < 1 || n_local < 0 || n_rows < 0 || ri < 0 || ri > n_rows ||
      grid < 1 || static_cast<long long>(n_local) * A >= (1ll << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  nl_rows_scan_kernel<<<1, kScanThreads, 0, s>>>(
      static_cast<const int*>(n_atoms),
      static_cast<const unsigned char*>(is_boundary), n_local, A, ri,
      static_cast<int*>(row_start), static_cast<int*>(counts));
  nl_rows_fill_kernel<<<grid, 256, 0, s>>>(
      static_cast<const int*>(n_atoms), static_cast<const int*>(row_start),
      static_cast<const int*>(counts), n_local, A, n_rows, ri,
      static_cast<int*>(a_list), static_cast<unsigned char*>(a_valid));
  return static_cast<int>(cudaGetLastError());
}

// NL1.  dtype: 0 float, 1 double.  r [3, plane] positions, a_list [n_rows]
// int32, a_valid [n_rows] bool, nbr_map [n_local, 27] int32, n_atoms [B]
// int32, row_start [n_local] int32 (the row of each cell's slot 0); writes
// nl [n_rows, K] int32 and count [n_rows] int32, and sets *overflow (an
// int32 the caller zeroed) to 1 when a valid row has more than K entries.
// rcut2 is (rcut + skin)^2 already rounded to dtype.
int comd_nl_build(int dtype, const void* r, int plane, const void* a_list,
                  const void* a_valid, const void* nbr_map,
                  const void* n_atoms, const void* row_start, int n_local,
                  int n_rows, int A, int K, double rcut2, void* nl,
                  void* count, void* overflow, void* stream) {
  if (A < 1 || K < 1 || n_rows < 0 || n_local < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_build<float>(r, plane, a_list, a_valid, nbr_map, n_atoms,
                               row_start, n_local, n_rows, A, K, rcut2, nl,
                               count, overflow, s);
  if (dtype == 1)
    return launch_build<double>(r, plane, a_list, a_valid, nbr_map, n_atoms,
                                row_start, n_local, n_rows, A, K, rcut2, nl,
                                count, overflow, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// NL2.  pair: 0 EAM pass 1, 1 EAM pass 3, 2 LJ; dtype: 0 float, 1 double;
// eval (EAM): 0 Chebyshev, 1 table, 2 the -P spline (LJ: 0 only).
// dfe [plane] is EAM pass 3's
// halo-filled dfEmbed; rec is scratch for [plane, 4] records of dtype
// (16-byte aligned), written by the pack kernel launched first.  Writes
// out [3 + ns, n_rows]; rcut2 is the pair cutoff squared, rounded to
// dtype.
int comd_nl_sweep(int pair, int dtype, int eval, int want_energy,
                  const void* r, int plane, const void* dfe, void* rec,
                  const void* a_list, const void* a_valid, const void* nl,
                  int n_rows, int K, double rcut2, const ChebParams* cheb,
                  const TableParams* tab, const LjParams* lj,
                  const SplineParams* spline, void* out, void* stream) {
  const bool eam = pair == kEam1 || pair == kEam3;
  if ((pair != kEam1 && pair != kEam3 && pair != kLj) || K < 1 ||
      n_rows < 0 || eval < 0 || eval > 2 ||
      (eam && eval == 0 && cheb == nullptr) ||
      (eam && eval == 1 && tab == nullptr) ||
      (eam && eval == 2 && (spline == nullptr || spline->n < 1)) ||
      (pair == kLj && (lj == nullptr || eval != 0)) ||
      (pair == kEam3 && dfe == nullptr) || rec == nullptr ||
      (eam && eval == 0 &&
       (cheb->n_terms < 2 || cheb->n_terms > kMaxCheb)))
    return static_cast<int>(cudaErrorInvalidValue);
  Sweep a{r, plane, dfe, rec, a_list, a_valid, nl, n_rows, K, rcut2,
          cheb, tab, lj, spline, out, static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return dispatch_eval<float>(eval, pair, want_energy, a);
  if (dtype == 1) return dispatch_eval<double>(eval, pair, want_energy, a);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* comd_nl_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
