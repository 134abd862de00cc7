// The redistribution ("rebucket") for Hopper (sm_90a): two kernels in
// place of ~186 PyTorch launches a serial rebucket.
//
// What they replace.  No Pallas kernel: comd_tpu's binning.rebucket
// (comd_tpu/ops/binning.py:91-172) is one XLA fusion around a two-key
// lax.sort; the port ran it as PyTorch ops (ops/cuda/rebucket.py's
// rebucket_plain: the wrap, the f64 binning, the halo fold, one stable
// torch.sort on box << 31 | gid, a run rank, seven scatters).  The
// function: every valid local slot (slot < n_atoms[cell]) is wrapped into
// [0, L) in r's dtype (with a wrap extent), binned in f64 by
// getBoxFromCoord's rules (csrc/bin.cuh, shared with arrivals.cu: the
// halo numbering of getBoxFromTuple, the Hilbert table where the geometry
// has one), folded back through the
// serial halo map if it binned into a halo cell (with a wrap), and every
// kept cell (the local ones; every cell under keep_halo) holds its atoms
// in ascending gid order from slot 0, the rest of its slots empty; the
// counts are every atom binned into a kept cell, stored or not.
//
//   rebucket_bin    one thread a local slot: the wrap, the bin and the
//                   fold; a place in its cell's staging area from one
//                   atomicAdd a warp and a cell (__match_any_sync groups
//                   the warp's lanes by cell), where it writes the atom as
//                   one record (r, gid, p: 32 bytes in f32, 64 in f64);
//                   the migrating atoms (binned outside the local cells)
//                   and whether a kept cell got more than A counted into
//                   two scratch words.
//   rebucket_place  every slot of a cell written from its staged records
//                   ranked by gid (unique, so the layout does not depend
//                   on the order the atomics gave), records to slots rank
//                   < A, the other slots empty, the count written and its
//                   counter cleared; block 0 writes n_migrating and the
//                   overflow flag (or-ed into it on request) and clears the
//                   scratch words.  With a baseline (the serial lazy step's
//                   last_r) the local cells' positions also go there.  Two
//                   forms, the wrapper's choice by A:
//                     warp  (A <= 32) a segment of L lanes a cell, L = A
//                           rounded up to a power of two (two cells a warp
//                           at A = 16): lane t loads the cell's record t
//                           beside the count (one round trip to memory),
//                           lane 0 clears the counter, the rank by
//                           shuffles, and each lane stores one slot a
//                           field: its record's, or an empty one; no
//                           shared memory, no block barrier.  A cell of
//                           more than L records (overflow) is ranked in
//                           rounds of L;
//                     block (A > 32) a thread a slot of a cell, the first
//                           record loaded beside the count, the gids and
//                           the rank through shared memory, two barriers.
//
// In place.  The bin launch copies every live value into the staging
// before the place launch writes, so the outputs may be the inputs: the
// serial step rebuckets into its own buffers.  No memset: the counters
// and the scratch words are zero before the first launch and every place
// launch leaves them zero, so a launch in a CUDA graph finds them clear
// at each replay.
//
// Overflow.  A cell stages at most C >= A records (the wrapper's
// capacity).  Up to C atoms a cell, the layout is exact even past A (the
// A smallest gids are kept); past C the staged records are the first C
// to reserve a place, in no fixed order, and the kept A may differ from
// the A smallest.  The counts, n_migrating and the overflow flag are exact
// either way (a run with overflow aborts: cli.check_overflow).
//
// Numbers.  The same bits as the plain version: the wrap's division,
// product and differences rounded one by one in r's dtype (IEEE, no FMA:
// explicit _rn intrinsics, and -fmad=false for the rest), the bin's
// difference and product in f64 from the wrapped value cast up, the
// fold's difference in r's dtype, the empties torch.full's bits.
//
// Bound: bytes.  The bin launch reads the valid slots' r, p, gid and the
// counts and writes a record an atom; the place launch reads the records
// and writes every kept slot's r, p, gid (and the baseline's local
// positions) and the counts.  Neither does more than a few operations a
// word.  What held the block form of the place launch back was its
// schedule, not bytes: a record waited through two block barriers and a
// loop over shared memory between its load and its store (~27% of the
// byte bound at A = 16 on an H100); the warp form keeps it in registers
// from load to store and ranks with shuffles.  32-bit slot indices: B * A
// and B * C below 2^31 (the wrapper checks).
//
// Plain C interface for ctypes: comd_rebucket launches both kernels on
// `stream`, returns the cudaError_t of the launches (0 = success) and
// does not synchronize.
#include <cuda_runtime.h>

#include "bin.cuh"

// What ops/cuda/rebucket.py's _Args holds (the same order and types).
struct RebucketArgs {
  const void* r;               // [3, B, A] T, read on the local slots
  const void* p;               // [3, B, A] T
  const int* gid;              // [B, A]
  const int* n_atoms;          // [B]
  void* out_r;                 // [3, B, A] T (may be r)
  void* out_p;
  int* out_gid;
  int* out_n;                  // [B]
  void* last_r;                // [3, B, A] T, local rows, or null
  int* n_migrating;            // 0-dim int32, or null
  bool* overflow;              // 0-dim bool
  const void* extent;          // [3] T: wrap and fold; null: neither
  const long long* box_of_tuple;  // [gx, gy, gz]: Hilbert; null: dense
  const long long* halo_src;   // [n_halo]
  const void* halo_shift;      // [n_halo, 3] T
  void* stage;                 // [max_box, C] records
  int* counts;                 // [B], zero between calls
  unsigned int* scalars;       // [2]: migrating, overflow; zero between
  double local_min[3];
  double local_max[3];
  double inv_box[3];
  int grid[3];
  int n_local;
  int n_halo;
  int B;
  int A;
  int C;                       // staging records a cell
  int max_box;                 // kept cells: n_local, or n_total
  int or_overflow;             // or the flag into *overflow
  int form;                    // place launch: 1 the warp form (A <= 32);
                               // 0 the block form
};

namespace {

using Args = RebucketArgs;

constexpr int kThreads = 256;
constexpr int kSmemLimit = 48 * 1024;   // a block-form place block's
constexpr unsigned int kAll = 0xffffffffu;
constexpr double kEmptyPos = 1.0e10;
constexpr int kEmptyGid = 2147483647;


__device__ __forceinline__ float div_rn(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ double div_rn(double a, double b) {
  return __ddiv_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float floor_t(float a) { return floorf(a); }
__device__ __forceinline__ double floor_t(double a) { return floor(a); }

// A staged atom: r, gid, p in 16-byte pieces (f32: r0 r1 r2 gid | p0 p1
// p2 -; f64: r0 r1 | r2 gid | p0 p1 | p2 -).
template <typename T>
struct Record;

template <>
struct Record<float> {
  static constexpr int kPieces = 2;
  using Piece = float4;
  __device__ static void put(Piece* at, const float* x, int g,
                             const float* v) {
    at[0] = make_float4(x[0], x[1], x[2], __int_as_float(g));
    at[1] = make_float4(v[0], v[1], v[2], 0.0f);
  }
  __device__ static int gid(const Piece* at) {
    return __float_as_int(at[0].w);
  }
  __device__ static void get(const Piece* at, float* x, int* g, float* v) {
    const float4 a = at[0], b = at[1];
    x[0] = a.x; x[1] = a.y; x[2] = a.z; *g = __float_as_int(a.w);
    v[0] = b.x; v[1] = b.y; v[2] = b.z;
  }
};

template <>
struct Record<double> {
  static constexpr int kPieces = 4;
  using Piece = double2;
  __device__ static double as_d(int g) {
    return __longlong_as_double(static_cast<long long>(g));
  }
  __device__ static int as_i(double d) {
    return static_cast<int>(__double_as_longlong(d));
  }
  __device__ static void put(Piece* at, const double* x, int g,
                             const double* v) {
    at[0] = make_double2(x[0], x[1]);
    at[1] = make_double2(x[2], as_d(g));
    at[2] = make_double2(v[0], v[1]);
    at[3] = make_double2(v[2], 0.0);
  }
  __device__ static int gid(const Piece* at) { return as_i(at[1].y); }
  __device__ static void get(const Piece* at, double* x, int* g,
                             double* v) {
    const double2 a = at[0], b = at[1], c = at[2], d = at[3];
    x[0] = a.x; x[1] = a.y; x[2] = b.x; *g = as_i(b.y);
    v[0] = c.x; v[1] = c.y; v[2] = d.x;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads) rebucket_bin_kernel(
    const __grid_constant__ Args a) {
  using R = Record<T>;
  const int n = a.n_local * a.A;
  const int s = blockIdx.x * kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const size_t plane = static_cast<size_t>(a.B) * a.A;
  int box = -1;              // the kept cell to stage into, or -1
  bool migrating = false;
  T x[3], v[3];
  int g = 0;
  if (s < n) {
    const int c = s / a.A;
    if (s - c * a.A < a.n_atoms[c]) {
      const T* r = static_cast<const T*>(a.r);
      const T* ext = static_cast<const T*>(a.extent);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        T y = r[k * plane + s];
        if (ext != nullptr) {
          // wrap_pbc: r - L floor(r / L), then r >= L -> r - L
          const T L = ext[k];
          y = sub_rn(y, mul_rn(L, floor_t(div_rn(y, L))));
          if (y >= L) y = sub_rn(y, L);
        }
        x[k] = y;
      }
      int b = bin_box(x, a.local_min, a.local_max, a.inv_box, a.grid,
                      a.n_local, a.box_of_tuple);
      if (ext != nullptr && b >= a.n_local) {
        // a coordinate rounded onto L: the periodic image's local cell
        int h = b - a.n_local;
        h = h < 0 ? 0 : (h > a.n_halo - 1 ? a.n_halo - 1 : h);
        const T* shf = static_cast<const T*>(a.halo_shift) + 3 * h;
#pragma unroll
        for (int k = 0; k < 3; ++k) x[k] = sub_rn(x[k], shf[k]);
        b = static_cast<int>(a.halo_src[h]);
      }
      migrating = b >= a.n_local;
      if (b < a.max_box) {
        box = b;
        const T* p = static_cast<const T*>(a.p);
#pragma unroll
        for (int k = 0; k < 3; ++k) v[k] = p[k * plane + s];
        g = a.gid[s];
      }
    }
  }
  // one atomic a cell a warp: the lanes staging into one cell take
  // consecutive places from their leader's reservation
  const unsigned int peers = __match_any_sync(0xffffffffu, box);
  bool over = false;
  if (box >= 0) {
    const int leader = __ffs(peers) - 1;
    int base = 0;
    if (lane == leader) base = atomicAdd(a.counts + box, __popc(peers));
    base = __shfl_sync(peers, base, leader);
    const int q = base + __popc(peers & ((1u << lane) - 1u));
    over = q >= a.A;
    if (q < a.C)
      R::put(static_cast<typename R::Piece*>(a.stage) +
                 (static_cast<size_t>(box) * a.C + q) * R::kPieces,
             x, g, v);
  }
  const int n_mig = __syncthreads_count(migrating);
  const int n_over = __syncthreads_or(over);
  if (threadIdx.x == 0) {
    if (n_mig) atomicAdd(a.scalars, static_cast<unsigned int>(n_mig));
    if (n_over) atomicOr(a.scalars + 1, 1u);
  }
}

// The cells a place block takes: as many as fit 256 threads with one a
// slot (16 at A = 16), at least one.
__host__ __device__ __forceinline__ int place_cells(int A) {
  return A < kThreads ? kThreads / A : 1;
}

// A place launch's block 0, one thread: the bin launch is done, so its
// two sums are final; written out and cleared.
__device__ __forceinline__ void settle_scalars(const Args& a) {
  const unsigned int mig = a.scalars[0], over = a.scalars[1];
  if (a.n_migrating != nullptr)
    *a.n_migrating = static_cast<int>(mig);
  if (!a.or_overflow)
    *a.overflow = over != 0;
  else if (over)
    *a.overflow = true;
  a.scalars[0] = 0;
  a.scalars[1] = 0;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) rebucket_place_kernel(
    const __grid_constant__ Args a) {
  using R = Record<T>;
  using Piece = typename R::Piece;
  extern __shared__ int smem[];    // [P] counts, then [P][C] gids
  const int P = place_cells(a.A);
  const int W = kThreads / P;      // threads a cell (>= A below 256)
  const int cl = threadIdx.x / W, t = threadIdx.x - cl * W;
  if (blockIdx.x == 0 && threadIdx.x == 0) settle_scalars(a);
  const int c = blockIdx.x * P + cl;
  const bool live = cl < P && c < a.B;   // 256 % W threads idle
  const bool kept = live && c < a.max_box;
  const Piece* st = static_cast<const Piece*>(a.stage) +
                    static_cast<size_t>(kept ? c : 0) * a.C * R::kPieces;
  // a thread's first record is loaded beside the count, before the count
  // says whether it is one: one round trip to memory for most cells
  T x[3], v[3];
  int gid = 0;
  if (kept && t < a.C) R::get(st + t * R::kPieces, x, &gid, v);
  if (live && t == 0) {
    smem[cl] = kept ? a.counts[c] : 0;
    if (kept) a.counts[c] = 0;
  }
  __syncthreads();
  const int count = live ? smem[cl] : 0;
  const int n = count < a.C ? count : a.C;
  int* g = smem + P + cl * a.C;
  for (int k = t; k < n; k += W)
    g[k] = k == t ? gid : R::gid(st + k * R::kPieces);
  __syncthreads();
  if (!live) return;
  const size_t plane = static_cast<size_t>(a.B) * a.A;
  const int row = c * a.A;
  T* out_r = static_cast<T*>(a.out_r);
  T* out_p = static_cast<T*>(a.out_p);
  T* last = c < a.n_local ? static_cast<T*>(a.last_r) : nullptr;
  for (int k = t; k < n; k += W) {
    // the rank: the records of smaller gid (unique; ties by place)
    const int mine = g[k];
    int rank = 0;
    for (int j = 0; j < n; ++j) {
      const int o = g[j];
      rank += (o < mine) | ((o == mine) & (j < k));
    }
    if (rank < a.A) {
      if (k != t) R::get(st + k * R::kPieces, x, &gid, v);
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        out_r[d * plane + row + rank] = x[d];
        out_p[d * plane + row + rank] = v[d];
        if (last != nullptr) last[d * plane + row + rank] = x[d];
      }
      a.out_gid[row + rank] = gid;
    }
  }
  const T empty = static_cast<T>(kEmptyPos);
  const int used = n < a.A ? n : a.A;
  for (int k = t; k < a.A; k += W) {
    if (k < used) continue;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      out_r[d * plane + row + k] = empty;
      out_p[d * plane + row + k] = T(0);
      if (last != nullptr) last[d * plane + row + k] = empty;
    }
    a.out_gid[row + k] = kEmptyGid;
  }
  if (t == 0) a.out_n[c] = count;
}

// The warp form's lanes a cell: A rounded up to a power of two (A <= 32).
__host__ __device__ __forceinline__ int place_lanes(int A) {
  int w = 1;
  while (w < A) w <<= 1;
  return w;
}

// The warp form (A <= 32): a segment of L lanes a cell, the cell's record
// k in lane k % L (round k / L), ranked by (gid, place) with shuffles
// across the segment; no shared memory, no block barrier.  Every loop
// bound is the same for the warp's segments, so every shuffle has the
// whole warp.
template <typename T>
__global__ void __launch_bounds__(kThreads) rebucket_place_warp_kernel(
    const __grid_constant__ Args a) {
  using R = Record<T>;
  using Piece = typename R::Piece;
  if (blockIdx.x == 0 && threadIdx.x == 0) settle_scalars(a);
  const int L = place_lanes(a.A);
  const int t = threadIdx.x & (L - 1);
  const int c = blockIdx.x * (kThreads / L) + threadIdx.x / L;
  const bool live = c < a.B;
  const bool kept = live && c < a.max_box;
  const Piece* st = static_cast<const Piece*>(a.stage) +
                    static_cast<size_t>(kept ? c : 0) * a.C * R::kPieces;
  // the lane's first record loaded beside the cell's count, before the
  // count says whether it is one (t < L <= C: staged memory either way):
  // one round trip to memory for a cell of at most L records
  T x[3], v[3];
  int g = 0, count = 0;
  if (kept) {
    R::get(st + t * R::kPieces, x, &g, v);
    if (t == 0) count = a.counts[c];
  }
  count = __shfl_sync(kAll, count, 0, L);
  if (kept && t == 0) a.counts[c] = 0;     // read by the whole segment
  const int n = count < a.C ? count : a.C;
  // rounds of L records (more than one only past L >= A: overflow), and
  // the segments' most records a round
  const int most = __reduce_max_sync(kAll, n);
  const int rounds = most > L ? (most + L - 1) / L : 1;
  const int reach = most < L ? most : L;
  const size_t plane = static_cast<size_t>(a.B) * a.A;
  const size_t row = static_cast<size_t>(live ? c : 0) * a.A;
  T* out_r = static_cast<T*>(a.out_r);
  T* out_p = static_cast<T*>(a.out_p);
  T* last = live && c < a.n_local ? static_cast<T*>(a.last_r) : nullptr;
  for (int i = 0; i < rounds; ++i) {
    const int k = i * L + t;               // the lane's record this round
    if (i > 0 && k < n) R::get(st + k * R::kPieces, x, &g, v);
    // the rank: the records of smaller gid (unique; ties by place)
    int rank = 0;
    for (int i2 = 0; i2 < rounds; ++i2) {
      const int k2 = i2 * L + t;
      const int o2 = i2 == i ? g
                             : (k2 < n ? R::gid(st + k2 * R::kPieces) : 0);
      const int m = n - i2 * L;            // round i2's records
      for (int j = 0; j < reach; ++j) {
        const int o = __shfl_sync(kAll, o2, j, L);
        rank += (j < m) & ((o < g) | ((o == g) & (i2 * L + j < k)));
      }
    }
    // one store a field: the record to slot rank < A, or in the first
    // round the empty slot t (n <= t < A; none once n >= A)
    const bool empty = k >= n;
    const int slot = !live ? -1 : !empty ? (rank < a.A ? rank : -1)
                                         : (i == 0 && t < a.A ? t : -1);
    if (slot >= 0) {
      const size_t at = row + slot;
      const T e = static_cast<T>(kEmptyPos);
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        out_r[d * plane + at] = empty ? e : x[d];
        out_p[d * plane + at] = empty ? T(0) : v[d];
        if (last != nullptr) last[d * plane + at] = empty ? e : x[d];
      }
      a.out_gid[at] = empty ? kEmptyGid : g;
    }
  }
  if (live && t == 0) a.out_n[c] = count;
}

// The block form's shared memory: P counts and P * C gids.
__host__ __forceinline__ size_t place_smem(int A, int C) {
  return sizeof(int) * static_cast<size_t>(place_cells(A)) * (1 + C);
}

template <typename T>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const long long n = static_cast<long long>(a.n_local) * a.A;
  if (n > 0)
    rebucket_bin_kernel<T><<<static_cast<int>((n + kThreads - 1) / kThreads),
                             kThreads, 0, stream>>>(a);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (a.form == 1) {
    const int P = kThreads / place_lanes(a.A);
    rebucket_place_warp_kernel<T><<<(a.B + P - 1) / P, kThreads, 0,
                                    stream>>>(a);
  } else {
    const int P = place_cells(a.A);
    rebucket_place_kernel<T><<<(a.B + P - 1) / P, kThreads,
                               place_smem(a.A, a.C), stream>>>(a);
  }
  return cudaGetLastError();
}

}  // namespace

// `elem`: 4 (f32) or 8 (f64).  The staging holds max_box * C records of
// 32 (f32) or 64 (f64) bytes, 16-byte aligned; a block-form place block
// takes place_smem(A, C) bytes of shared memory (at most 48 KB: the
// wrapper refuses larger A), the warp form none.
extern "C" int comd_rebucket(int elem, const RebucketArgs* args,
                             cudaStream_t stream) {
  const Args& a = *args;
  if ((elem != 4 && elem != 8) || a.A <= 0 || a.C < a.A ||
      a.max_box > a.B || a.n_local > a.max_box ||
      static_cast<long long>(a.B) * a.A >= (1ll << 31) ||
      static_cast<long long>(a.max_box) * a.C >= (1ll << 31) ||
      (a.form != 0 && a.form != 1) || (a.form == 1 && a.A > 32) ||
      place_smem(a.A, a.C) > kSmemLimit)
    return cudaErrorInvalidValue;
  return elem == 4 ? launch<float>(a, stream) : launch<double>(a, stream);
}

extern "C" const char* comd_rebucket_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
