// The atom exchange's unload for Hopper (sm_90a): the arrivals of one
// stage, both directions and every shard of the launch, re-binned into the
// shards' cells in two launches, and the canonical in-cell gid sort of
// every shard in one.
//
// What they replace.  No Pallas kernel: comd_tpu's binning.append_arrivals
// (comd_tpu/ops/binning.py:175-214) and sort_cells (:217-232) run inside
// its per-shard XLA program; the port ran them as PyTorch ops, once a
// shard, direction and stage (ops/cuda/arrivals.py's append_arrivals_plain:
// the f64 binning, a stable torch.sort, a run rank, seven scatters and the
// count add, ~143 operations a call; sort_cells_plain: a row sort and two
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
//                   source: its validity (the sender's cell count, or a
//                   flag an entry), the shift, the bin; a place in its
//                   cell's staging area from one atomicAdd a warp and a
//                   cell (__match_any_sync), where it writes the arrival
//                   as one record (gid and its rank tag, r, p: 32 bytes
//                   in f32, 64 in f64).
//   arrivals_place  a warp a cell of every shard of the launch: a cell
//                   without arrivals returns at once; else the records'
//                   keys into shared memory, each record's rank the
//                   number of smaller (direction, gid, place) keys, the
//                   record written to slot n_atoms + rank < A, the count
//                   added, the flag set where a slot reached A, the
//                   counter cleared.  Only the cells that got arrivals are
//                   written; the other slots stay as they were.
//   sort_cells      a block several cells of every shard (one slot a
//                   thread up to A = 256): the gids into shared memory,
//                   each slot's rank the number of smaller gids and of
//                   equal gids in earlier slots (the stable sort: empty
//                   slots all hold EMPTY_GID), the inverse permutation in
//                   shared memory, then each field staged through shared
//                   memory and written in the sorted order, in place or
//                   into other tensors (in place a slot that keeps its
//                   place is not written).
//
// No memset: the counters are zero before the first launch and every place
// launch leaves them zero, so a launch in a CUDA graph finds them clear at
// each replay.
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
// and writes a record each; the place launch reads every counter, the
// records and the counts of the cells that got arrivals, and writes their
// stored slots and counts; the sort reads every slot's r, p and gid and
// writes them (in place: the slots that move).  A few operations a word.
//
// Plain C interface for ctypes: comd_arrivals launches bin and place on
// `stream`, comd_sort_cells the sort; both return the cudaError_t of the
// launches (0 = success) and do not synchronize.
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
  __device__ __forceinline__ static void get(const Piece* at, float* x,
                                             float* v) {
    const float4 a = at[0], b = at[1];
    x[0] = a.z; x[1] = a.w; x[2] = b.x;
    v[0] = b.y; v[1] = b.z; v[2] = b.w;
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
  __device__ __forceinline__ static void get(const Piece* at, double* x,
                                             double* v) {
    const double2 a = at[0], b = at[1], c = at[2], d = at[3];
    x[0] = a.y; x[1] = b.x; x[2] = b.y;
    v[0] = c.x; v[1] = c.y; v[2] = d.x;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    arrivals_bin_kernel(const __grid_constant__ Args a) {
  using R = Record<T>;
  const long long e = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  const long long total = static_cast<long long>(a.n_shards) * a.n_dirs *
                          a.M;
  const int lane = threadIdx.x & 31;
  int cell = -1;             // the staging cell s * B + box, or -1
  int g = 0, tag = 0;
  T x[3], v[3];
  if (e < total) {
    const int src = static_cast<int>(e / a.M);
    const int i = static_cast<int>(e - static_cast<long long>(src) * a.M);
    const int s = src / a.n_dirs, d = src - s * a.n_dirs;
    const ArrivalSource& in = a.src[s][d];
    bool valid;
    if (a.mask_counts) {
      const int c = i / a.A;
      valid = i - c * a.A < static_cast<const int*>(in.mask)[c];
    } else {
      valid = static_cast<const bool*>(in.mask)[i];
    }
    if (valid) {
      const T* r = static_cast<const T*>(in.r);
      const T* p = static_cast<const T*>(in.p);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        x[k] = r[static_cast<long long>(k) * a.M + i];
        v[k] = p[static_cast<long long>(k) * a.M + i];
      }
      // the sender's frame -> the receiver's
#pragma unroll
      for (int k = 0; k < 3; ++k)
        if (k == a.axis) x[k] = add_rn(x[k], static_cast<T>(a.shift[d]));
      const int b = bin_box(x, a.local_min, a.local_max, a.inv_box, a.grid,
                            a.n_local, a.box_of_tuple);
      cell = s * a.B + b;
      g = in.gid[i];
      tag = d * a.M + i;
    }
  }
  // one atomic a cell a warp: the lanes staging into one cell take
  // consecutive places from their leader's reservation
  const unsigned int peers = __match_any_sync(0xffffffffu, cell);
  if (cell >= 0) {
    const int leader = __ffs(peers) - 1;
    int base = 0;
    if (lane == leader) base = atomicAdd(a.counts + cell, __popc(peers));
    base = __shfl_sync(peers, base, leader);
    const int q = base + __popc(peers & ((1u << lane) - 1u));
    if (q < a.C)
      R::put(static_cast<typename R::Piece*>(a.stage) +
                 (static_cast<size_t>(cell) * a.C + q) * R::kPieces,
             g, tag, x, v);
  }
}

// (direction, gid, place) of key o before key m's; tag = direction * M +
// place, so the tags order the places within a direction.
__device__ __forceinline__ bool before(int2 o, int2 m, int M) {
  const int od = o.y >= M, md = m.y >= M;
  return od < md || (od == md && (o.x < m.x || (o.x == m.x && o.y < m.y)));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    arrivals_place_kernel(const __grid_constant__ Args a) {
  using R = Record<T>;
  using Piece = typename R::Piece;
  extern __shared__ int2 keys[];           // [place_warps][C]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long cell = static_cast<long long>(blockIdx.x) * a.place_warps +
                         warp;
  if (cell >= static_cast<long long>(a.n_shards) * a.B) return;
  const int k = a.counts[cell];
  if (k == 0) return;                      // no arrival: untouched
  const int s = static_cast<int>(cell / a.B);
  const int c = static_cast<int>(cell - static_cast<long long>(s) * a.B);
  const int n0 = a.n_atoms[s][c];
  const int nk = k < a.C ? k : a.C;
  int2* key = keys + warp * a.C;
  const Piece* st = static_cast<const Piece*>(a.stage) +
                    static_cast<size_t>(cell) * a.C * R::kPieces;
  for (int j = lane; j < nk; j += 32) key[j] = R::key(st + j * R::kPieces);
  __syncwarp();
  const size_t plane = static_cast<size_t>(a.B) * a.A;
  T* out_r = static_cast<T*>(a.r[s]);
  T* out_p = static_cast<T*>(a.p[s]);
  int* out_g = a.gid[s];
  for (int j = lane; j < nk; j += 32) {
    const int2 m = key[j];
    int rank = 0;
    for (int o = 0; o < nk; ++o) rank += before(key[o], m, a.M);
    const int slot = n0 + rank;            // n0 may exceed A already
    if (slot < a.A) {
      T x[3], v[3];
      R::get(st + j * R::kPieces, x, v);
      const size_t at = static_cast<size_t>(c) * a.A + slot;
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        out_r[d * plane + at] = x[d];
        out_p[d * plane + at] = v[d];
      }
      out_g[at] = m.x;
    }
  }
  if (lane == 0) {
    a.n_atoms[s][c] = n0 + k;
    a.counts[cell] = 0;
    if (n0 + k > a.A) *a.overflow = true;
  }
}

// Cells a sort block takes: as many as fit 256 threads with one a slot,
// at least one (then a thread takes every 256th slot).
__host__ __device__ __forceinline__ int sort_cells_per_block(int A) {
  return A < kThreads ? kThreads / A : 1;
}

// The sort block's shared memory: a cell's gids, the inverse permutation
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

__host__ __forceinline__ size_t place_smem(const Args& a) {
  return sizeof(int2) * static_cast<size_t>(a.place_warps) * a.C;
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
  const long long cells = static_cast<long long>(a.n_shards) * a.B;
  arrivals_place_kernel<T><<<static_cast<unsigned>(
                                 (cells + a.place_warps - 1) / a.place_warps),
                             32 * a.place_warps, place_smem(a), stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_sort(const SortArgs& a, cudaStream_t stream) {
  const int P = sort_cells_per_block(a.A);
  const dim3 grid(static_cast<unsigned>((a.B + P - 1) / P),
                  static_cast<unsigned>(a.n_shards));
  sort_cells_kernel<T><<<grid, kThreads, sort_smem(a.A), stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// `elem`: 4 (f32) or 8 (f64).  The staging holds n_shards * B * C records
// of 32 (f32) or 64 (f64) bytes, 16-byte aligned; a place block takes
// place_warps * C * 8 bytes of shared memory.
extern "C" int comd_arrivals(int elem, const ArrivalsArgs* args,
                             cudaStream_t stream) {
  const Args& a = *args;
  if ((elem != 4 && elem != 8) || a.A <= 0 || a.C < a.A || a.M < 0 ||
      a.n_shards < 1 || a.n_shards > kMaxShards || a.n_dirs < 1 ||
      a.n_dirs > 2 || a.axis < -1 || a.axis > 2 || a.place_warps < 1 ||
      a.place_warps > kThreads / 32 ||
      static_cast<long long>(a.n_shards) * a.n_dirs * a.M >= (1ll << 31) ||
      static_cast<long long>(a.n_shards) * a.B >= (1ll << 31) ||
      static_cast<long long>(a.B) * a.A >= (1ll << 31) ||
      (a.mask_counts && a.M % a.A != 0) || place_smem(a) > kSmemLimit)
    return cudaErrorInvalidValue;
  return elem == 4 ? launch<float>(a, stream) : launch<double>(a, stream);
}

extern "C" int comd_sort_cells(int elem, const SortArgs* args,
                               cudaStream_t stream) {
  const SortArgs& a = *args;
  if ((elem != 4 && elem != 8) || a.A <= 0 || a.B < 0 || a.n_shards < 1 ||
      a.n_shards > kSortShards ||
      static_cast<long long>(a.B) * a.A >= (1ll << 31) ||
      sort_smem(a.A) > kSmemLimit)
    return cudaErrorInvalidValue;
  if (a.B == 0) return cudaSuccess;
  return elem == 4 ? launch_sort<float>(a, stream)
                   : launch_sort<double>(a, stream);
}

extern "C" const char* comd_arrivals_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
