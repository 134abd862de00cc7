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
// ops/neighborlist.py::nl_rows_plain), a tile of kRowsTile = 128 local
// cells a block in both (539 tiles at the 63^3 headline's 68,921 cells,
// 73 on a 2x2x2 shard's 9,261; 256- and 512-cell tiles measured no
// faster at 63^3 on an H100):
//  - nl_rows_tile_kernel: each tile's sums of min(max(n_atoms, 0), A),
//    interior and boundary cells apart, four counts a thread loaded as
//    one 16-byte vector, into a [tiles] scratch that every build
//    overwrites;
//  - nl_rows_fill_kernel: a block adds the sums of the tiles before its
//    own (and of all, the two segments' row counts), scans its tile by
//    shuffles and writes row_start; then a warp segment a cell, a lane a
//    slot (A <= 32; else a thread a slot), writes each valid row's
//    a_list = c A + s at row_start[c] + s below its segment's end; and
//    the blocks together write a_valid (each segment's first
//    min(count, capacity) rows 1, the rest 0) and a_list 0 past the
//    counts, 16 bytes a store.
//  Two launches: the fill needs the sums of the tiles before its own,
//  which exist only when every tile is summed; one launch would need a
//  grid-wide wait (a look-back chain, whose flags must then be cleared).
//  A single block does not suffice: the earlier one-block scan, a thread
//  walking ~67 cells twice, took 90.4 us of a 104 us build at 63^3 on an
//  H100 while 131 SMs sat idle; over tiles every SM scans at once.
//  Bytes bound NR (11.6 MB at 63^3: the counts, row_start, the rows'
//  a_list and a_valid).
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

// NR (see the header): both launches give a block one tile of kRowsTile
// local cells.  The tile sums [n_tiles] (x: the rows of the interior, or
// every, cell of the tile; y: the boundary cells') are the wrapper's
// scratch: the first launch writes every entry, the second reads them, so
// nothing is left to clear between builds or graph replays.  The first
// launch takes 4 cells a thread, the second a cell a thread.

constexpr int kRowsTile = 128;

__device__ __forceinline__ int cell_rows(int n, int A) {
  return min(max(n, 0), A);
}

// NR's tiles: one at least (an empty shard's block still zeros its rows).
inline int rows_tiles(int n_local) {
  return n_local > kRowsTile ? (n_local + kRowsTile - 1) / kRowsTile : 1;
}

// NR's first launch: the tile's two row sums.  `vec`: n_atoms is 16-byte
// and is_b 4-byte aligned, so a thread loads its four counts (and masks)
// in one access.  is_b null: no row split.
__global__ void __launch_bounds__(kRowsTile / 4)
nl_rows_tile_kernel(const int* __restrict__ n_atoms,
                    const unsigned char* __restrict__ is_b, int n_local,
                    int A, int vec, int2* __restrict__ tile_sums) {
  constexpr int kWarps = kRowsTile / 4 / 32;
  __shared__ int part[kWarps][2];
  const int c0 = blockIdx.x * kRowsTile + 4 * threadIdx.x;
  int n[4] = {0, 0, 0, 0};
  unsigned int m = 0;   // byte k: cell c0 + k is a boundary cell
  if (vec && c0 + 4 <= n_local) {
    const int4 x = *reinterpret_cast<const int4*>(n_atoms + c0);
    n[0] = x.x;
    n[1] = x.y;
    n[2] = x.z;
    n[3] = x.w;
    if (is_b != nullptr)
      m = *reinterpret_cast<const unsigned int*>(is_b + c0);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (c0 + k < n_local) {
        n[k] = n_atoms[c0 + k];
        if (is_b != nullptr)
          m |= static_cast<unsigned int>(is_b[c0 + k]) << (8 * k);
      }
    }
  }
  int si = 0, sb = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int r = cell_rows(n[k], A);
    if ((m >> (8 * k)) & 0xffu) sb += r; else si += r;
  }
  si = __reduce_add_sync(kFull, si);
  sb = __reduce_add_sync(kFull, sb);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    part[warp][0] = si;
    part[warp][1] = sb;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int ti = 0, tb = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      ti += part[w][0];
      tb += part[w][1];
    }
    tile_sums[blockIdx.x] = make_int2(ti, tb);
  }
}

// Set p's rows [lo, hi) to x (0 or 1) over the grid (thread g of
// `stride`): with `vec` (p 16-byte aligned) the 16-byte groups wholly
// inside the range as one store each, the rows at its two ends one at a
// time.
template <typename T>
__device__ __forceinline__ void fill_rows(T* p, int lo, int hi, int x,
                                          int vec, int g, int stride) {
  constexpr int K = 16 / sizeof(T);
  int q0 = hi, q1 = hi;   // [q0, q1): the rows of whole groups
  if (vec && lo < hi) {
    q0 = min(hi, (lo + K - 1) / K * K);
    q1 = max(q0, hi / K * K);
  }
  // x in every byte of a word (x is 0 or 1)
  const unsigned int w = static_cast<unsigned int>(x) *
                         (sizeof(T) == 1 ? 0x01010101u : 1u);
  for (int r = lo + g; r < q0; r += stride) p[r] = static_cast<T>(x);
  for (int q = q0 / K + g; q < q1 / K; q += stride)
    reinterpret_cast<uint4*>(p)[q] = make_uint4(w, w, w, w);
  for (int r = q1 + g; r < hi; r += stride) p[r] = static_cast<T>(x);
}

// NR's second launch, block b on tile b:
//  - the sums of the tiles before b and of every tile (each block adds
//    them itself: 539 tiles at the 63^3 headline, ~4 loads a thread);
//  - a block scan of the tile's counts by shuffles writes row_start, and
//    keeps each cell's start and its rows (those below its segment's end:
//    Ri for an interior cell, n_rows for a boundary one) in shared memory;
//  - the tile's valid rows' a_list: at A <= 32 (seg >= 0) a warp segment
//    of 2^seg lanes a cell and a lane a slot, so a cell's count and start
//    are read once and consecutive lanes store consecutive rows; else a
//    thread a slot;
//  - the block's share of a_valid over every row and of a_list over the
//    rows past each segment's count, 16 bytes a store (vec: a_list and
//    a_valid 16-byte aligned): a segment's valid rows are the first
//    min(count, capacity) of it, so a_valid is two runs of ones, known
//    from the totals that every block forms, and no byte is stored a cell
//    at a time.
__global__ void __launch_bounds__(kRowsTile)
nl_rows_fill_kernel(const int* __restrict__ n_atoms,
                    const unsigned char* __restrict__ is_b,
                    const int2* __restrict__ tile_sums, int n_tiles,
                    int n_local, int A, int n_rows, int ri, int seg,
                    int vec, int* __restrict__ a_list,
                    unsigned char* __restrict__ a_valid,
                    int* __restrict__ row_start) {
  constexpr int kFillWarps = kRowsTile / 32;
  __shared__ int s_start[kRowsTile], s_rows[kRowsTile];
  __shared__ int s_warp[kFillWarps][6];
  __shared__ int s_sum[4];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int b = blockIdx.x;
  // the cell's count and mask first, so that their loads and the tile
  // sums' overlap (the block's phases are otherwise one chain of loads)
  const int c = b * kRowsTile + t;
  int n = 0;
  bool bnd = false;
  if (c < n_local) {
    n = cell_rows(n_atoms[c], A);
    bnd = is_b != nullptr && is_b[c];
  }
  int before_i = 0, before_b = 0, all_i = 0, all_b = 0;
#pragma unroll 4
  for (int k = t; k < n_tiles; k += kRowsTile) {
    const int2 s = tile_sums[k];
    all_i += s.x;
    all_b += s.y;
    if (k < b) {
      before_i += s.x;
      before_b += s.y;
    }
  }
  const int own_i = bnd ? 0 : n, own_b = bnd ? n : 0;
  int xi = own_i, xb = own_b;   // inclusive scans over the warp's lanes
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int vi = __shfl_up_sync(kFull, xi, d);
    const int vb = __shfl_up_sync(kFull, xb, d);
    if (lane >= d) {
      xi += vi;
      xb += vb;
    }
  }
  before_i = __reduce_add_sync(kFull, before_i);
  before_b = __reduce_add_sync(kFull, before_b);
  all_i = __reduce_add_sync(kFull, all_i);
  all_b = __reduce_add_sync(kFull, all_b);
  if (lane == 31) {
    s_warp[warp][0] = xi;
    s_warp[warp][1] = xb;
  }
  if (lane == 0) {
    s_warp[warp][2] = before_i;
    s_warp[warp][3] = before_b;
    s_warp[warp][4] = all_i;
    s_warp[warp][5] = all_b;
  }
  __syncthreads();
  if (warp == 0) {   // the warps' totals: exclusive scans and the sums
    const bool w = lane < kFillWarps;
    const int oi = w ? s_warp[lane][0] : 0, ob = w ? s_warp[lane][1] : 0;
    int wi = oi, wb = ob;
#pragma unroll
    for (int d = 1; d < kFillWarps; d <<= 1) {
      const int vi = __shfl_up_sync(kFull, wi, d);
      const int vb = __shfl_up_sync(kFull, wb, d);
      if (lane >= d) {
        wi += vi;
        wb += vb;
      }
    }
    int sums[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      sums[q] = __reduce_add_sync(kFull, w ? s_warp[lane][2 + q] : 0);
    __syncwarp();
    if (w) {
      s_warp[lane][0] = wi - oi;
      s_warp[lane][1] = wb - ob;
    }
    if (lane == 0) {
#pragma unroll
      for (int q = 0; q < 4; ++q) s_sum[q] = sums[q];
    }
  }
  __syncthreads();
  const int start =
      bnd ? ri + s_sum[1] + s_warp[warp][1] + xb - own_b
          : s_sum[0] + s_warp[warp][0] + xi - own_i;
  const int end = bnd ? n_rows : ri;
  if (c < n_local) row_start[c] = start;
  s_start[t] = start;
  s_rows[t] = max(0, min(n, end - start));
  const int count_i = s_sum[2], count_b = s_sum[3];
  __syncthreads();
  const int first = b * kRowsTile;
  const int cells = min(kRowsTile, n_local - first);
  if (seg >= 0) {
    const int per_warp = 32 >> seg;
    const int s = lane & ((1 << seg) - 1);
    for (int k = warp * per_warp + (lane >> seg); k < cells;
         k += kFillWarps * per_warp) {
      if (s < s_rows[k]) a_list[s_start[k] + s] = (first + k) * A + s;
    }
  } else {
    for (int i = t; i < cells * A; i += kRowsTile) {
      const int k = i / A;
      const int s = i - k * A;
      if (s < s_rows[k]) a_list[s_start[k] + s] = (first + k) * A + s;
    }
  }
  const int g = b * kRowsTile + t;
  const int stride = gridDim.x * kRowsTile;
  const int lo_i = min(count_i, ri);
  const int lo_b = ri + min(count_b, n_rows - ri);
  fill_rows(a_valid, 0, lo_i, 1, vec, g, stride);
  fill_rows(a_valid, lo_i, ri, 0, vec, g, stride);
  fill_rows(a_valid, ri, lo_b, 1, vec, g, stride);
  fill_rows(a_valid, lo_b, n_rows, 0, vec, g, stride);
  fill_rows(a_list, lo_i, ri, 0, vec, g, stride);
  fill_rows(a_list, lo_b, n_rows, 0, vec, g, stride);
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

// NR's tile count for n_local local cells: the int2 entries that
// comd_nl_rows' tile_sums needs.
int comd_nl_rows_tiles(int n_local) { return rows_tiles(n_local); }

// NR.  n_atoms [>= n_local] int32, is_boundary [n_local] bool or null (no
// row split; then ri = n_rows); writes a_list [n_rows] int32, a_valid
// [n_rows] bool, row_start [n_local] int32 and tile_sums (`sums_len` int2
// entries, at least comd_nl_rows_tiles(n_local); scratch: the first launch
// writes it, the second reads it), two launches on `stream`.  At A <= 32
// the fill gives a cell a warp segment of 2^seg lanes, A rounded up to a
// power of two (a lane a slot), else a thread a slot (seg -1).
int comd_nl_rows(const void* n_atoms, const void* is_boundary, int n_local,
                 int A, int n_rows, int ri, void* a_list, void* a_valid,
                 void* row_start, void* tile_sums, int sums_len,
                 void* stream) {
  if (A < 1 || n_local < 0 || n_rows < 0 || ri < 0 || ri > n_rows ||
      static_cast<long long>(n_local) * A >= (1ll << 31) ||
      sums_len < rows_tiles(n_local))
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = rows_tiles(n_local);
  int seg = A <= 32 ? 0 : -1;
  while (seg >= 0 && (1 << seg) < A) ++seg;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* na = static_cast<const int*>(n_atoms);
  const unsigned char* is_b = static_cast<const unsigned char*>(is_boundary);
  int* al = static_cast<int*>(a_list);
  unsigned char* av = static_cast<unsigned char*>(a_valid);
  int2* sums = static_cast<int2*>(tile_sums);
  const auto aligned = [](const void* p, int k) {
    return reinterpret_cast<uintptr_t>(p) % k == 0;
  };
  nl_rows_tile_kernel<<<tiles, kRowsTile / 4, 0, s>>>(
      na, is_b, n_local, A,
      aligned(na, 16) && (is_b == nullptr || aligned(is_b, 4)), sums);
  nl_rows_fill_kernel<<<tiles, kRowsTile, 0, s>>>(
      na, is_b, sums, tiles, n_local, A, n_rows, ri, seg,
      aligned(al, 16) && aligned(av, 16), al, av,
      static_cast<int*>(row_start));
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
