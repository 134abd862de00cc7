// The atom exchange's unload for Hopper (sm_90a): the arrivals of one
// stage, both directions and every shard of the launch, re-binned into the
// shards' cells in two launches, and the canonical in-cell gid sort of
// every shard in one.
//
// What they replace.  No Pallas kernel: comd_tpu's binning.append_arrivals
// (comd_tpu/ops/binning.py:175-214) and sort_cells (:217-232) run inside
// its per-shard XLA program; the port ran them as PyTorch ops, once a
// shard, direction and stage (ops/cuda/arrivals.py's append_arrivals_plain:
// the f64 binning, a stable torch.sort, a run rank, seven scatters and
// the count add, ~143 operations a call; sort_cells_plain: a row sort and two
// gathers).  The function of one shard's append: every valid arrival
// (r shifted along the stage's axis into the receiver's frame, in r's
// dtype) is binned in f64 by getBoxFromCoord's rules (csrc/bin.cuh) into
// a local or a halo cell; a cell's arrivals take slots n_atoms[cell] +
// rank, ranked by gid (ties by their place in the buffer), and are stored
// where the slot is below A; n_atoms counts every arrival binned into a
// cell, stored or not, and the overflow flag is set if any slot reached
// A.  Two directions in one launch are two appends in a row: direction
// 1's ranks start after every direction-0 arrival of the cell, so the
// rank is by (direction, gid, place).
//
//   arrivals_bin    one thread an arrival slot of every (shard, direction)
//                   source: its r, p and gid loaded beside its validity
//                   (the sender's cell count, or a flag an entry), so one
//                   round trip to memory comes before the bin; the
//                   shift, the bin; a place in its cell's staging area
//                   from one atomicAdd a warp and a cell
//                   (__match_any_sync), where it writes the arrival as
//                   one record (gid and its rank tag, r, p: 32 bytes in
//                   f32, 64 in f64).  The leader that finds the cell's
//                   counter at 0 is its first: the block's first leaders
//                   (a ballot a warp, a scan of the warps' counts) append
//                   their cells to the one list behind one atomic a
//                   block on its length.  Each cell that got arrivals is
//                   listed once, in no fixed order.
//   arrivals_place  a fixed grid sized to the card (the SMs times the
//                   blocks an SM holds): each block reads the list's
//                   length, and the last block to read it (a ticket)
//                   clears it and the ticket for the next bin launch and
//                   keeps it for checks; the warps stride over the list,
//                   a warp a listed cell: it loads the cell's records
//                   (k <= 32: one a lane, ranked by shuffles in
//                   registers; more: their keys through shared memory),
//                   ranks each by the number of smaller (direction, gid,
//                   place) keys, writes it to slot n_atoms + rank < A,
//                   adds the count, sets the flag where a slot reached A
//                   and clears the counter.  Only the listed cells are
//                   touched, whatever the list's order.
//   sort_cells      every cell of every shard sorted by gid, stable (the
//                   empty slots all hold EMPTY_GID: ties by slot); in
//                   place or into other tensors (in place a slot that
//                   keeps its place is not written).  Two forms, the
//                   wrapper's choice by A:
//                     warp  (A <= 32) a cell a warp segment of A rounded
//                           up to a power of two lanes (two cells a warp
//                           at A = 16), one slot a lane: the lane loads
//                           its slot's seven words at once, ranks its gid
//                           against the cell's by shuffles, and after a
//                           __syncwarp stores the seven words to slot
//                           rank; no shared memory, no block barrier;
//                     block (A > 32) several cells a block, one slot a
//                           thread up to A = 256: the gids into shared
//                           memory, the rank, the inverse permutation in
//                           shared memory, then each field staged through
//                           shared memory and written in the sorted order.
//
// No memset: the counters, the list's length and the ticket are zero
// before the first launch and every place launch leaves them zero, so a
// launch in a CUDA graph finds them right at each replay.
//
// Overflow.  A cell stages at most C records (the wrapper's capacity, C >=
// 2A).  Up to C arrivals a cell the slots are exact; past C the staged
// records are the first C to reserve a place, in no fixed order, and the
// stored ones may differ from the plain version's; the counts and the flag
// are exact either way (a run with overflow aborts: cli.check_overflow).
//
// Numbers.  The shift is one addition in r's dtype of the Python scalar
// rounded to it, as torch's ``arr_r[axis] += shift`` (__fadd_rn /
// __dadd_rn); the bin's difference and product in f64 from the shifted
// value cast up; nothing else is computed.  Built with -fmad=false.
//
// Bound: bytes.  The bin launch reads the valid arrivals and the masks
// and writes a record each; the place launch reads the records and the
// counts of the cells that got arrivals, and writes their stored slots
// and counts; the sort reads every slot's r, p and gid and writes them
// (in place: the slots that move).  A few operations a word.  What held
// the first designs back was latency, not bytes: the place launch visited
// every cell (a warp a cell, ~90% of them without arrivals, ~11 waves of
// one dependent load each), the sort kept one 4-byte load a thread in
// flight between 14 block barriers, the bin waited for the mask before it
// loaded the slot.  The list makes the place launch one wave over the
// cells with work (one list read at a stride: per-warp segments, read in
// groups and scanned, cost the place launch more than one atomic a block
// costs the bin); the warp sort keeps 28 (f32) or 52 (f64) bytes a lane
// in flight.
//
// Plain C interface for ctypes: comd_arrivals launches bin and place on
// `stream`, comd_sort_cells the sort; both return the cudaError_t of the
// launches (0 = success) and do not synchronize.
// comd_arrivals_place_blocks gives the place launch's grid for a device.
#include <cuda_runtime.h>

#include "bin.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxShards = 32;       // shards an arrivals launch
constexpr int kSortShards = 64;      // shards a sort launch
constexpr int kSmemLimit = 48 * 1024;

}  // namespace

// One (shard, direction) source of arrivals, flat: r and p [3, M], gid
// [M], and the mask: the sender's counts [M / A] (slot i is valid if i %
// A < counts[i / A]) or a bool a slot [M].
struct ArrivalSource {
  const void* r;
  const void* p;
  const int* gid;
  const void* mask;
};

// What ops/cuda/arrivals.py's _Args holds (the same order and types).
struct ArrivalsArgs {
  ArrivalSource src[kMaxShards][2];  // [shard][direction]
  void* r[kMaxShards];               // shard s's [3, B, A] T, in place
  void* p[kMaxShards];
  int* gid[kMaxShards];              // [B, A]
  int* n_atoms[kMaxShards];          // [B]
  bool* overflow;                    // 0-dim bool, set (never cleared)
  void* stage;                       // [n_shards * B, C] records
  int* counts;                       // [n_shards * B], zero between calls
  int* list;                         // [n_shards * B] the cells that got
                                     // arrivals, in no fixed order
  int* list_n;                       // [2] the list's length and the
                                     // place launch's ticket, zero between
                                     // calls
  int* listed;                       // the length the place launch read
                                     // (for checks)
  const long long* box_of_tuple;     // [gx, gy, gz]: Hilbert; null: dense
  double local_min[3];
  double local_max[3];
  double inv_box[3];
  double shift[2];                   // direction d's shift along `axis`
  int grid[3];
  int n_local;
  int B;
  int A;
  int C;                             // staging records a cell
  int M;                             // arrival slots a source
  int n_shards;
  int n_dirs;                        // 1 or 2
  int axis;                          // the shifted axis, or -1: no shift
  int mask_counts;                   // 1: counts a cell; 0: a bool a slot
  int place_warps;                   // warps a place block
  int place_blocks;                  // the place launch's grid
};

// What ops/cuda/arrivals.py's _SortArgs holds.
struct SortArgs {
  const void* r[kSortShards];        // [3, B, A] T
  const void* p[kSortShards];
  const int* gid[kSortShards];       // [B, A]
  void* out_r[kSortShards];          // may be r (in place)
  void* out_p[kSortShards];
  int* out_gid[kSortShards];
  int n_shards;
  int B;
  int A;
  int form;                          // 1: the warp form (A <= 32); 0: block
};

namespace {

using Args = ArrivalsArgs;

__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}

// A staged arrival: its key (gid, tag = direction * M + place) first, then
// r and p, in 16-byte pieces (f32: gid tag r0 r1 | r2 p0 p1 p2; f64:
// gid,tag r0 | r1 r2 | p0 p1 | p2 -).
template <typename T>
struct Record;

template <>
struct Record<float> {
  static constexpr int kPieces = 2;
  using Piece = float4;
  __device__ __forceinline__ static void put(Piece* at, int g, int tag,
                                             const float* x, const float* v) {
    at[0] = make_float4(__int_as_float(g), __int_as_float(tag), x[0], x[1]);
    at[1] = make_float4(x[2], v[0], v[1], v[2]);
  }
  __device__ __forceinline__ static int2 key(const Piece* at) {
    const float4 a = at[0];
    return make_int2(__float_as_int(a.x), __float_as_int(a.y));
  }
  // the whole record, both pieces loaded before either is used
  __device__ __forceinline__ static int2 load(const Piece* at, float* x,
                                              float* v) {
    const float4 a = at[0], b = at[1];
    x[0] = a.z; x[1] = a.w; x[2] = b.x;
    v[0] = b.y; v[1] = b.z; v[2] = b.w;
    return make_int2(__float_as_int(a.x), __float_as_int(a.y));
  }
};

template <>
struct Record<double> {
  static constexpr int kPieces = 4;
  using Piece = double2;
  __device__ __forceinline__ static void put(Piece* at, int g, int tag,
                                             const double* x, const double* v) {
    const long long k = (static_cast<long long>(tag) << 32) |
                        static_cast<unsigned int>(g);
    at[0] = make_double2(__longlong_as_double(k), x[0]);
    at[1] = make_double2(x[1], x[2]);
    at[2] = make_double2(v[0], v[1]);
    at[3] = make_double2(v[2], 0.0);
  }
  __device__ __forceinline__ static int2 key(const Piece* at) {
    const long long k = __double_as_longlong(at[0].x);
    return make_int2(static_cast<int>(k & 0xffffffffll),
                     static_cast<int>(k >> 32));
  }
  __device__ __forceinline__ static int2 load(const Piece* at, double* x,
                                              double* v) {
    const double2 a = at[0], b = at[1], c = at[2], d = at[3];
    x[0] = a.y; x[1] = b.x; x[2] = b.y;
    v[0] = c.x; v[1] = c.y; v[2] = d.x;
    const long long k = __double_as_longlong(a.x);
    return make_int2(static_cast<int>(k & 0xffffffffll),
                     static_cast<int>(k >> 32));
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    arrivals_bin_kernel(const __grid_constant__ Args a) {
  using R = Record<T>;
  // 32-bit slot indices (the wrapper keeps the slots below 2^31): the
  // divisions before the loads stay short
  const unsigned int e = blockIdx.x * kThreads + threadIdx.x;
  const unsigned int total = a.n_shards * a.n_dirs * a.M;
  const int lane = threadIdx.x & 31;
  int cell = -1;             // the staging cell s * B + box, or -1
  int g = 0, tag = 0;
  T x[3], v[3];
  if (e < total) {
    const int src = static_cast<int>(e / a.M);
    const int i = static_cast<int>(e) - src * a.M;
    const int s = src / a.n_dirs, d = src - s * a.n_dirs;
    const ArrivalSource& in = a.src[s][d];
    // the slot's r, p and gid loaded beside the mask, before it says
    // whether the slot holds an arrival (every plane is M slots long): one
    // round trip to memory before the bin instead of two
    const T* r = static_cast<const T*>(in.r);
    const T* p = static_cast<const T*>(in.p);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      x[k] = r[static_cast<long long>(k) * a.M + i];
      v[k] = p[static_cast<long long>(k) * a.M + i];
    }
    const int gi = in.gid[i];
    bool valid;
    if (a.mask_counts) {
      const int c = i / a.A;
      valid = i - c * a.A < static_cast<const int*>(in.mask)[c];
    } else {
      valid = static_cast<const bool*>(in.mask)[i];
    }
    if (valid) {
      // the sender's frame -> the receiver's
#pragma unroll
      for (int k = 0; k < 3; ++k)
        if (k == a.axis) x[k] = add_rn(x[k], static_cast<T>(a.shift[d]));
      const int b = bin_box(x, a.local_min, a.local_max, a.inv_box, a.grid,
                            a.n_local, a.box_of_tuple);
      cell = s * a.B + b;
      g = gi;
      tag = d * a.M + i;
    }
  }
  // one atomic a cell a warp: the lanes staging into one cell take
  // consecutive places from their leader's reservation
  const unsigned int peers = __match_any_sync(0xffffffffu, cell);
  bool first = false;        // this lane's reservation opened the cell
  if (cell >= 0) {
    const int leader = __ffs(peers) - 1;
    int base = 0;
    if (lane == leader) base = atomicAdd(a.counts + cell, __popc(peers));
    base = __shfl_sync(peers, base, leader);
    first = lane == leader && base == 0;
    const int q = base + __popc(peers & ((1u << lane) - 1u));
    if (q < a.C)
      R::put(static_cast<typename R::Piece*>(a.stage) +
                 (static_cast<size_t>(cell) * a.C + q) * R::kPieces,
             g, tag, x, v);
  }
  // the cells this block opened, appended to the list behind one atomic
  // a block on its length: each warp's count, their scan, the reservation
  __shared__ int opened[kThreads / 32];
  __shared__ int base;
  const int warp = threadIdx.x >> 5;
  const unsigned int firsts = __ballot_sync(0xffffffffu, first);
  if (lane == 0) opened[warp] = __popc(firsts);
  __syncthreads();
  if (threadIdx.x == 0) {
    int sum = 0;
    for (int w = 0; w < kThreads / 32; ++w) {
      const int k = opened[w];
      opened[w] = sum;
      sum += k;
    }
    base = sum > 0 ? atomicAdd(a.list_n, sum) : 0;
  }
  __syncthreads();
  if (first)
    a.list[base + opened[warp] + __popc(firsts & ((1u << lane) - 1u))] =
        cell;
}

// (direction, gid, place) of key o before key m's; tag = direction * M +
// place, so the tags order the places within a direction.
__device__ __forceinline__ bool before(int2 o, int2 m, int M) {
  const int od = o.y >= M, md = m.y >= M;
  return od < md || (od == md && (o.x < m.x || (o.x == m.x && o.y < m.y)));
}

// One record of the cell written to its slot n0 + rank where that is
// below A.
template <typename T>
__device__ __forceinline__ void put_slot(const Args& a, int s, int c, int slot,
                                         int g, const T* x, const T* v) {
  if (slot >= a.A) return;               // n0 may exceed A already
  const size_t plane = static_cast<size_t>(a.B) * a.A;
  const size_t at = static_cast<size_t>(c) * a.A + slot;
  T* out_r = static_cast<T*>(a.r[s]);
  T* out_p = static_cast<T*>(a.p[s]);
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    out_r[d * plane + at] = x[d];
    out_p[d * plane + at] = v[d];
  }
  a.gid[s][at] = g;
}

// A warp places one listed cell.  kSmemKeys (C > 32): ``key`` holds the
// warp's C keys in shared memory; else a cell's records, at most 32, are
// ranked in registers.
template <typename T, bool kSmemKeys>
__device__ __forceinline__ void place_cell(const Args& a, int cell, int lane,
                                           int2* key) {
  using R = Record<T>;
  using Piece = typename R::Piece;
  const int s = cell / a.B;
  const int c = cell - s * a.B;
  // every lane reads the count and n0 before the shuffles or __syncwarp
  // below, so lane 0's writes at the end find them read
  const int k = a.counts[cell];
  const int n0 = a.n_atoms[s][c];
  const int nk = k < a.C ? k : a.C;
  const Piece* st = static_cast<const Piece*>(a.stage) +
                    static_cast<size_t>(cell) * a.C * R::kPieces;
  if (!kSmemKeys || nk <= 32) {
    // a record a lane, ranked against the others' keys in registers
    int2 m = make_int2(0, 0);
    T x[3], v[3];
    if (lane < nk) m = R::load(st + lane * R::kPieces, x, v);
    int rank = 0;
    for (int o = 0; o < nk; ++o) {
      const int2 ko = make_int2(__shfl_sync(0xffffffffu, m.x, o),
                                __shfl_sync(0xffffffffu, m.y, o));
      rank += before(ko, m, a.M);
    }
    if (lane < nk) put_slot(a, s, c, n0 + rank, m.x, x, v);
  } else {
    for (int j = lane; j < nk; j += 32) key[j] = R::key(st + j * R::kPieces);
    __syncwarp();
    for (int j = lane; j < nk; j += 32) {
      const int2 m = key[j];
      int rank = 0;
      for (int o = 0; o < nk; ++o) rank += before(key[o], m, a.M);
      T x[3], v[3];
      R::load(st + j * R::kPieces, x, v);
      put_slot(a, s, c, n0 + rank, m.x, x, v);
    }
    __syncwarp();                          // the keys free for the next cell
  }
  if (lane == 0) {
    a.n_atoms[s][c] = n0 + k;
    a.counts[cell] = 0;
    if (n0 + k > a.A) *a.overflow = true;
  }
}

// The register form is held to 32 registers a thread (8 blocks of 256 an
// SM: ~8.4k warps, at ~8k listed cells about one a warp).
template <typename T, bool kSmemKeys>
__global__ void __launch_bounds__(kThreads, kSmemKeys ? 1 : 8)
    arrivals_place_kernel(const __grid_constant__ Args a) {
  extern __shared__ int2 keys[];           // [place_warps][C] if kSmemKeys
  __shared__ int length;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    const int n = __ldcg(a.list_n);
    length = n;
    // the read before the ticket: the last block to take one knows every
    // block has read the length, clears it and the ticket for the next
    // bin launch and keeps it for checks
    __threadfence();
    if (atomicAdd(reinterpret_cast<unsigned int*>(a.list_n) + 1, 1u) ==
        gridDim.x - 1) {
      a.list_n[0] = 0;
      a.list_n[1] = 0;
      *a.listed = n;
    }
  }
  __syncthreads();
  const int n = length;
  const int stride = static_cast<int>(gridDim.x) * a.place_warps;
  for (int k = static_cast<int>(blockIdx.x) * a.place_warps + warp; k < n;
       k += stride)
    place_cell<T, kSmemKeys>(a, __ldcg(a.list + k), lane, keys + warp * a.C);
}

// Cells a block of the block form sorts: as many as fit 256 threads with
// one a slot, at least one (then a thread takes every 256th slot).
__host__ __device__ __forceinline__ int sort_cells_per_block(int A) {
  return A < kThreads ? kThreads / A : 1;
}

// The warp form's lanes a cell: A rounded up to a power of two (A <= 32).
__host__ __device__ __forceinline__ int sort_lanes(int A) {
  int w = 1;
  while (w < A) w <<= 1;
  return w;
}

// The block sort's shared memory: a cell's gids, the inverse permutation
// and one field's values (8 bytes a slot).
__host__ __forceinline__ size_t sort_smem(int A) {
  return static_cast<size_t>(sort_cells_per_block(A)) * A * 16;
}

// One field of a cell in the sorted order: every slot read into shared
// memory before any is written (``out`` may be ``in``).
template <typename V>
__device__ __forceinline__ void permute(const V* in, V* out, const int* src,
                                        V* buf, int k0, int W, int A) {
  for (int k = k0; k < A; k += W) buf[k] = in[k];
  __syncthreads();
  for (int k = k0; k < A; k += W)
    if (out != in || src[k] != k) out[k] = buf[src[k]];
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    sort_cells_kernel(const __grid_constant__ SortArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int P = sort_cells_per_block(a.A);
  const int W = kThreads / P;              // threads a cell
  const int cl = threadIdx.x / W < P ? threadIdx.x / W : P;
  const int t = threadIdx.x - cl * W;
  const int s = blockIdx.y;
  const long long c = static_cast<long long>(blockIdx.x) * P + cl;
  const bool live = cl < P && c < a.B;
  const int A = a.A;
  // per cell: [A] gids, [A] sources, [A] 8-byte values
  int* gids = reinterpret_cast<int*>(smem_raw) + cl * 2 * A;
  int* src = gids + A;
  T* buf = reinterpret_cast<T*>(smem_raw + static_cast<size_t>(P) * A * 8) +
           static_cast<size_t>(cl) * A * (8 / sizeof(T));
  const size_t row = live ? static_cast<size_t>(c) * A : 0;
  const int k0 = live ? t : A;             // idle threads take no slot
  const int* g_in = a.gid[s] + row;
  for (int k = k0; k < A; k += W) gids[k] = g_in[k];
  __syncthreads();
  // the stable rank: smaller gids, and equal gids in earlier slots
  for (int k = k0; k < A; k += W) {
    const int mine = gids[k];
    int rank = 0;
    for (int j = 0; j < A; ++j) {
      const int o = gids[j];
      rank += (o < mine) | ((o == mine) & (j < k));
    }
    src[rank] = k;
  }
  __syncthreads();
  const size_t plane = static_cast<size_t>(a.B) * A;
  // the gids: sorted, read from shared memory
  int* g_out = a.out_gid[s] + row;
  for (int k = k0; k < A; k += W)
    if (g_out != g_in || src[k] != k) g_out[k] = gids[src[k]];
  for (int d = 0; d < 3; ++d) {
    permute(static_cast<const T*>(a.r[s]) + d * plane + row,
            static_cast<T*>(a.out_r[s]) + d * plane + row, src, buf, k0, W,
            A);
    permute(static_cast<const T*>(a.p[s]) + d * plane + row,
            static_cast<T*>(a.out_p[s]) + d * plane + row, src, buf, k0, W,
            A);
  }
}

// The warp form (A <= 32): a segment of L lanes a cell, one slot a lane.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    sort_cells_warp_kernel(const __grid_constant__ SortArgs a) {
  const int A = a.A;
  const int L = sort_lanes(A);
  const int cl = threadIdx.x / L;
  const int t = threadIdx.x & (L - 1);
  const int s = blockIdx.y;
  const long long c = static_cast<long long>(blockIdx.x) * (kThreads / L) +
                      cl;
  const bool live = c < a.B && t < A;
  const size_t plane = static_cast<size_t>(a.B) * A;
  const size_t row = c < a.B ? static_cast<size_t>(c) * A : 0;
  const T* r_in = static_cast<const T*>(a.r[s]) + row;
  const T* p_in = static_cast<const T*>(a.p[s]) + row;
  const int* g_in = a.gid[s] + row;
  // the slot's seven words, all in flight before any is used
  int g = 0;
  T x[3], v[3];
  if (live) {
    g = g_in[t];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      x[d] = r_in[d * plane + t];
      v[d] = p_in[d * plane + t];
    }
  }
  // the stable rank: smaller gids, and equal gids in earlier slots
  int rank = 0;
  for (int j = 0; j < A; ++j) {
    const int o = __shfl_sync(0xffffffffu, g, j, L);
    rank += (o < g) | ((o == g) & (j < t));
  }
  __syncwarp();                            // in place: every load first
  T* r_out = static_cast<T*>(a.out_r[s]) + row;
  T* p_out = static_cast<T*>(a.out_p[s]) + row;
  int* g_out = a.out_gid[s] + row;
  const bool kept = rank == t && g_out == g_in && r_out == r_in &&
                    p_out == p_in;           // in place, already there
  if (live && !kept) {
    g_out[rank] = g;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      r_out[d * plane + rank] = x[d];
      p_out[d * plane + rank] = v[d];
    }
  }
}

__host__ __forceinline__ size_t place_smem(int place_warps, int C) {
  return C > 32 ? sizeof(int2) * static_cast<size_t>(place_warps) * C : 0;
}

template <typename T>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const long long n = static_cast<long long>(a.n_shards) * a.n_dirs * a.M;
  if (n > 0)
    arrivals_bin_kernel<T><<<static_cast<unsigned>((n + kThreads - 1) /
                                                   kThreads),
                             kThreads, 0, stream>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem = place_smem(a.place_warps, a.C);
  if (smem > 0)
    arrivals_place_kernel<T, true><<<static_cast<unsigned>(a.place_blocks),
                                     32 * a.place_warps, smem, stream>>>(a);
  else
    arrivals_place_kernel<T, false><<<static_cast<unsigned>(a.place_blocks),
                                      32 * a.place_warps, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_sort(const SortArgs& a, cudaStream_t stream) {
  if (a.form == 1) {
    const int P = kThreads / sort_lanes(a.A);
    const dim3 grid(static_cast<unsigned>((a.B + P - 1) / P),
                    static_cast<unsigned>(a.n_shards));
    sort_cells_warp_kernel<T><<<grid, kThreads, 0, stream>>>(a);
    return cudaGetLastError();
  }
  const int P = sort_cells_per_block(a.A);
  const dim3 grid(static_cast<unsigned>((a.B + P - 1) / P),
                  static_cast<unsigned>(a.n_shards));
  sort_cells_kernel<T><<<grid, kThreads, sort_smem(a.A), stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t place_blocks(int place_warps, int C, int device, int* blocks) {
  int sms = 0, per_sm = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const size_t smem = place_smem(place_warps, C);
  err = smem > 0 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                       &per_sm, arrivals_place_kernel<T, true>,
                       32 * place_warps, smem)
                 : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                       &per_sm, arrivals_place_kernel<T, false>,
                       32 * place_warps, 0);
  if (err != cudaSuccess) return err;
  *blocks = sms * per_sm;
  return *blocks > 0 ? cudaSuccess : cudaErrorInvalidConfiguration;
}

}  // namespace

// `elem`: 4 (f32) or 8 (f64).  The staging holds n_shards * B * C records
// of 32 (f32) or 64 (f64) bytes, 16-byte aligned; the list n_shards * B
// ints; where C > 32 a place block takes place_warps * C * 8 bytes of
// shared memory.
extern "C" int comd_arrivals(int elem, const ArrivalsArgs* args,
                             cudaStream_t stream) {
  const Args& a = *args;
  if ((elem != 4 && elem != 8) || a.A <= 0 || a.C < a.A || a.M < 0 ||
      a.n_shards < 1 || a.n_shards > kMaxShards || a.n_dirs < 1 ||
      a.n_dirs > 2 || a.axis < -1 || a.axis > 2 || a.place_warps < 1 ||
      a.place_warps > kThreads / 32 || a.place_blocks < 1 ||
      static_cast<long long>(a.n_shards) * a.n_dirs * a.M >= (1ll << 31) ||
      static_cast<long long>(a.n_shards) * a.B >= (1ll << 31) ||
      static_cast<long long>(a.B) * a.A >= (1ll << 31) ||
      (a.mask_counts && a.M % a.A != 0) ||
      place_smem(a.place_warps, a.C) > kSmemLimit)
    return cudaErrorInvalidValue;
  return elem == 4 ? launch<float>(a, stream) : launch<double>(a, stream);
}

extern "C" int comd_sort_cells(int elem, const SortArgs* args,
                               cudaStream_t stream) {
  const SortArgs& a = *args;
  if ((elem != 4 && elem != 8) || a.A <= 0 || a.B < 0 || a.n_shards < 1 ||
      a.n_shards > kSortShards ||
      static_cast<long long>(a.B) * a.A >= (1ll << 31) ||
      (a.form != 0 && a.form != 1) || (a.form == 1 && a.A > 32) ||
      (a.form == 0 && sort_smem(a.A) > kSmemLimit))
    return cudaErrorInvalidValue;
  if (a.B == 0) return cudaSuccess;
  return elem == 4 ? launch_sort<float>(a, stream)
                   : launch_sort<double>(a, stream);
}

// The place launch's grid on `device`: its SMs times the blocks of
// `place_warps` warps (and their shared memory at capacity C) an SM holds.
extern "C" int comd_arrivals_place_blocks(int elem, int place_warps, int C,
                                          int device, int* blocks) {
  if ((elem != 4 && elem != 8) || place_warps < 1 ||
      place_warps > kThreads / 32 || C < 1 ||
      place_smem(place_warps, C) > kSmemLimit)
    return cudaErrorInvalidValue;
  return elem == 4 ? place_blocks<float>(place_warps, C, device, blocks)
                   : place_blocks<double>(place_warps, C, device, blocks);
}

extern "C" const char* comd_arrivals_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
