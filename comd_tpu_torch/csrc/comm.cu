// Kernel-initiated halo transports for Hopper (sm_90a): the dfEmbed halo
// fill (K3's plane pushes and K4's fused F'(rhobar) push: one launch a fill
// in one process, one a stage across processes), the atom exchange's
// stage push (K3, one launch a stage), the mesh's ghost-position refresh
// (one launch a refresh in one process, one a stage across processes), the
// collective transport's count-packed atom messages (one launch a stage)
// and the half-shell fold (one launch serially, one a stage on a mesh);
// across processes, the receive-plane arena shared by CUDA IPC and the
// stream-ordered ready counters.
//
// What they replace.  comd_tpu/parallel/pallas_comm.py::_ring_push_kernel
// (K3, driven by _ring_push) remote-copies one plane to the +-1 ring
// neighbor of one mesh axis after a neighbor barrier, with DMA semaphores;
// exchange_scalar_ki runs it once per (stage, direction) of the dfEmbed
// fill and exchange_atoms_ki once per (stage, direction) for the packed
// atom buffer.  _pass2_push_kernel (K4, driven by _pass2_push) evaluates
// F'(rhobar) of an x-face plane -- the quadratic interpolation of the
// embedding table F, eam.c:557-579, as comd_tpu_torch/potentials/
// tables.interpolate computes it (csrc/embed.cuh) -- and pushes it;
// exchange_scalar_ki_fused runs it for the x stage and K3 for y and z.
// The Pallas kernel's 0/1 selection-matmul table read was a Mosaic
// workaround; this is a direct table read.
//
// Destinations.  A launch moves rows of this process's shards (0..S-1).
// to[d][s] names where shard s's rows of direction d go: a value t < S is
// shard t of the same launch (its field, or its slab of the arrivals); a
// value t >= S is receive plane t - S, a pointer of its own: in one
// process there are none, across processes they are the planes of the
// receivers in other processes, in those processes' arenas.
//
// halo_fill_kernel: the staged dfEmbed fill of every shard's [B, A] field.
// Stage by stage (x, y, z: haloExchange.c:345-475's growing cross
// section), for both directions d and every shard s, rows send[d][k] of
// s's field go into rows recv[d][k] of the field of shard t = to[d][s], or
// into row k of plane t - S; with `fused` the x stage writes F'(rhobar[s]
// at rows send[d][k]) instead (K4).
// The y stage forwards what the x stage wrote and z what y wrote, so the
// stages are separated by a grid-wide barrier: a cooperative launch
// (cudaLaunchCooperativeKernel, cooperative_groups::this_grid().sync(); no
// -rdc since CUDA 11), its grid no larger than the blocks the card holds at
// once (occupancy x SMs, queried once a device), so every block is resident
// and the barrier cannot deadlock.  A card without cooperative launch is
// refused (cudaErrorNotSupported), never worked around.  No host round trip
// between the stages.  The barrier orders the stages' global writes; the
// copies read with ld.global.cg (L2, not L1) so no stale L1 line of an
// earlier stage is read.  A one-stage launch has no barrier and is an
// ordinary launch: K4 alone (pass2_push, with a local copy of each plane)
// and each stage of a fill across processes.
//
// ring_push_kernel: one stage of the atom exchange.  For every field f (r,
// p, gid, counts), both directions d and every shard s, rows send[d][k] of
// s's field go into row k of the arrival buffer of shard t = to[d][s] for
// direction d ([n_dirs, S, planes, n, row]), or, for t >= S, into row k of
// field f of plane set t - S (the fields at set_off[f] of one block, laid
// out as in the arrival buffer).  Each field moves at its own
// vector width: r, p and gid at 16 bytes where the row allows, the counts
// ([B]: one word a row) at 4.  append_arrivals runs between the stages on
// the host's stream (torch ops), so one launch never reads another stage's
// arrivals.
//
// position_fill_kernel: the mesh's ghost-position refresh between
// rebuckets.  It replaces no Pallas kernel: comd_tpu runs
// parallel/exchange.py::exchange_positions (:242) as three ppermutes in its
// compiled step (parallel/sharded.py:403, :467); the port's staged torch
// version (parallel/exchange.py::exchange_positions) is the plain
// reference.  A launch follows a row map: for every entry, coordinate
// rows c = 0, 1, 2 of row `row` of shard `dst`'s [3, B, A] positions (or
// of receive plane dst - S, [3, n, A]) get the same rows of row `src_row`
// of shard `src`, plus sign_c * ext[c].  In one process the
// map is the staged exchange composed (parallel/exchange.py::position_map:
// every halo row of every shard once, its source the local row the three
// stages finally copy into it), so a refresh is one ordinary launch with no
// barrier: no row it writes is a row it reads.  Across processes it is one
// stage's rows, one launch a stage, rows for another process's shards into
// that process's receive planes (ki_comm.py).  Coordinate c is shifted only
// in stage c, and ext[c] is already rounded to the field's dtype, so each
// coordinate takes at most one add, rounded alone (__fadd_rn, __dadd_rn):
// the staged version's bits.  A zero sign adds nothing (x + 0 would turn
// -0 into +0).
//
// atom_pack_kernel: the atom messages of one stage of the collective
// transport, for every shard and both faces.  It replaces no Pallas
// kernel: comd_tpu packs them in XLA (parallel/exchange.py:186-210, the
// reference's on-device size scan and packed AtomMsg, gpu_kernels.cu:
// 684-690); the port's parallel/exchange.py::_atom_message is the plain
// reference.  Message (d, s) is the cells ids[d] of shard s's two send
// planes of face d.  Count-packed (cap > 0): the real slots (slot <
// n_atoms[cell]), in cell order and then slot order, go to entries 0, 1,
// ... of [cap] (r and p as one [6, cap] buffer, gid, valid = k < count),
// entries past cap are dropped and `count > cap` is or-ed into the
// overflow flag; the entries past the count are zero, EMPTY_GID and
// invalid.  Full planes (cap = 0): every slot of every cell, entry c * A +
// slot, valid where the slot is real.  Work split: a grid of (cell chunks,
// messages); a block takes kPackCells cells of one message.  No block
// waits on another, so every block of a packed message sums all its counts
// (a few thousand words from L2) in one pass in message order: every id
// loaded, then every count, then the sums before its chunk and in all;
// beside them a thread a cell of its chunk scans the chunk, one barrier
// for both.  Then the block's share of the message's valid flags and
// empty tail (issued before the copy, so the copy's loads overlap those
// stores), then the copy: a group of 2^lg lanes a cell, each lane one
// vector of `slots` slots (16 bytes where A allows) of each of r's and
// p's six coordinate rows and of gid, all seven loaded before its stores,
// cell and slot from shifts, no divide; a warp's real slots of a pass are
// consecutive entries, staged in shared memory and stored by consecutive
// lanes (a packed entry is not aligned to a vector); full planes the same
// path.
//
// fold_halo_kernel: the half-shell fold, halo rows added into their owner
// rows.  It replaces no Pallas kernel: comd_tpu folds with XLA scatter-adds
// (ops/sweep.py:615 fold_halo_serial; parallel/exchange.py:270 fold_halo,
// three stages z, y, x of ppermutes and adds).  A launch follows a fold
// plan: a destination row and its sources in add order; the row of every
// plane gets ((x + s0) + s1) + ..., each add rounded alone, the order of
// the CPU index_add_ (serially the images in ascending halo row; on a mesh
// the plus neighbor's rows before the minus neighbor's).  One launch
// serially; one a stage on a mesh (a stage adds rows an earlier stage
// summed, so the stages are not composed: flattening would change the
// rounding).  No row a launch reads is a row it writes (halo rows in the
// stage's axis against local ones), so a launch needs no barrier, and a
// destination is one record, so no atomics: the same bits every launch.
// A record is R 16-byte words (the plan's record_vecs, 1 to
// kFoldRecordVecs): the destination (shard | row << kShardBits), the
// source count with the start of its spill, and its first K = 4R - 2
// sources inline (serially R = 3: a corner cell's 7 images; on a mesh R =
// 1: two sources); sources past K, the order kept, in the spill list.
// The record's words bound a plan (FoldPlan refuses more): rows below
// 2^25, at most 255 sources a destination (the count's 8 bits), fewer than
// 2^23 spilled sources in all (the spill start's 23 bits); the plans that
// exist have at most 7 sources a destination serially and 2 on a mesh.
// Work split: a group of 2^lg lanes a (record, plane), the plane the
// grid's y, each lane one 16-byte vector of the row where A allows; the
// group loads its record, then the destination vector and every source
// vector, and only then adds them in order and stores once: two dependent
// loads, record -> data.
//
// Ordering in one process.  Every shard lives on one device and every
// launch goes on PyTorch's current stream, after the kernels that wrote the
// source rows and before those that read the destination, so stream order
// is the Pallas kernels' barrier and semaphores.  Inside one stage every
// destination row is written by one (shard, direction) only (a direction's
// destinations are distinct, and the two directions write different halo
// planes or different arrival buffers), and the rows a stage reads (send)
// are never rows it writes (recv: the halo planes on the other side of the
// axis), also when a shard pushes to itself (an axis of size 1).
//
// Ordering across processes (the Pallas kernels' neighbor barrier and DMA
// semaphores; the reference's comm_send_ready_on_stream /
// comm_wait_ready_on_stream, comm.cc:326-397).  Each process allocates one
// arena with cudaMalloc (comd_arena_alloc): the receive planes of its
// shards whose sender is in another process, and a block of 32-bit
// counters.  Every process opens its peers' arenas once by their IPC
// handles (comd_ipc_open; never its own).  A stage is then one launch with
// no grid barrier, ordered by counters that only grow, on the stream, with
// no host wait: the sender waits until each receiver has drained its
// previous plane (comd_stream_wait on its own "free" counter), pushes, and
// bumps a "data" counter in each receiver's arena (comd_stream_write:
// cuStreamWriteValue32 without NO_MEMORY_BARRIER, so the push's writes are
// visible before the counter); the receiver waits on its data counters,
// unpacks its planes (torch ops) and bumps the sender's free counter.  The
// waits are the stream front end's (cuStreamWaitValue32), not a spinning
// kernel, so a card time-sliced between processes runs the peer while one
// waits.
//
// Bound: bytes.  The kernels move each word once (the fused stage also
// reads its ~4 KB table from cache; atom_pack also the counts) with a few
// integer operations a word;
// a fill moves ~3 MB over the 8 shards of the 63^3 headline, ~1 us at
// 3.35 TB/s, so latency, the two barriers and the launch set its time; a
// position refresh moves ~9.3 MB there (23,248 halo rows of 3 x 64 bytes,
// read and written, and the map), ~2.8 us.
// Work split: the lanes of a warp are cut into groups of 2^lg lanes, one
// row a group (2^lg the power of two at or above the row's vectors, at
// most 32), so a 64-byte row of A = 16 floats is four 16-byte moves on
// four lanes and a warp moves eight rows at once; row and lane come from the
// block and thread indices with shifts and masks, never a divide.  The grid
// strides over rows (x) and over (direction, shard) entries (y; ring_push:
// shards y, fields z; position_fill: map entries x only, a group moving the
// three coordinate rows of its entry's slot row).  No shared memory.
//
// Built with -fmad=false: the fused stage must round F' operation by
// operation, as PyTorch's eager kernels do for the interior values of pass
// 2, so the planes it pushes equal the interior values bit for bit.
//
// Plain C interface for ctypes: each launch entry point returns the
// cudaError_t of its launch (0 = success) and does not synchronize; the
// arena entry points return a cudaError_t, the counter entry points a
// CUresult (cuda.h).  Linked with -lcuda for the stream memory operations.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_runtime.h>

#include "embed.cuh"

namespace cg = cooperative_groups;

constexpr int kMaxShards = 64;   // shards a launch
constexpr int kShardBits = 6;    // bits of a shard in a fold record's word
static_assert(kMaxShards == 1 << kShardBits, "a record word's shard bits");
constexpr int kMaxPlanes = 2 * kMaxShards;  // receive planes a launch
constexpr int kMaxStages = 3;    // stages a fill
constexpr int kMaxFields = 4;    // fields a ring_push launch
constexpr int kPackCells = 64;   // cells a block of atom_pack
constexpr int kScanCells = 8;    // cells a thread a round of atom_pack's sums
constexpr int kFoldRecordVecs = 3;  // 16-byte words a fold record at most
constexpr int kEmptyGid = 0x7fffffff;   // ops/binning.py EMPTY_GID
constexpr int kMaxDevices = 64;  // devices the co-residency cache holds
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// One stage of a fill: its directions' row lists and rings (device int32).
struct FillStage {
  const int* send[2];   // [d]: rows each shard sends in direction d
  const int* recv[2];   // [d]: the rows they land in at the receiver
  const int* to[2];     // [d]: to[d][s], where shard s pushes to
  int n_rows;           // rows a (shard, direction)
};

struct FillArgs {
  int n_shards, n_dirs, n_stages;
  int fused;            // the first stage evaluates F'(rhobar) (K4)
  int elem_bytes;       // 4 (float) or 8 (double)
  int vec_bytes;        // 16, 8 or 4: the copy stages' vector
  int row_elems;        // A: elements a row
  int row_vecs;         // vectors a row in the copy stages
  int vec_lg;           // log2 of the lanes a row, copy stages
  int elem_lg;          // log2 of the lanes a row, the F' stage
  int grid_x, grid_y;   // blocks wanted (x clamped to co-residency)
  int device;           // the CUDA device of the launch
  int n_planes;         // receive planes (destinations >= n_shards)
  FillStage stage[kMaxStages];
  int embed_n;          // F's table: InterpTable.device_table, [n + 4]
  double embed_x0, embed_inv_dx;
  const void* embed_table;
  void* x[kMaxShards];           // shard s's [B, A] field
  const void* rho[kMaxShards];   // shard s's rhobar [n_local, A] (fused)
  void* local[kMaxShards];       // shard s's copy of its F' plane, or null
  void* plane[kMaxPlanes];       // receive plane p, [n_rows, A]
};

// One field of a ring_push launch, the same for every shard.
struct PushField {
  int n_planes;          // planes stacked in the field (r, p: 3)
  int row_vecs;          // vectors a row
  int vec_bytes;         // 16, 8 or 4
  int lg;                // log2 of the lanes a row
  long long src_plane;   // vectors from one source plane to the next
};

struct PushArgs {
  int n_fields, n_shards, n_dirs, n_rows;
  int grid_x;
  int device;
  int n_sets;            // receive plane sets (destinations >= n_shards)
  const int* send[2];    // [d]: rows each shard sends in direction d
  const int* to[2];      // [d]: to[d][s], where shard s pushes to
  PushField field[kMaxFields];
  const void* src[kMaxFields][kMaxShards];   // shard s's field f
  void* dst[kMaxFields];  // field f's arrivals [n_dirs, S, planes, n, row]
  void* set[kMaxPlanes];  // receive plane set p: every field of one sender
  long long set_off[kMaxFields];   // bytes from a set to its field f
};

// A position refresh (or one stage of it across processes).  Entry k of
// the map is four ints: the destination (a shard < n_shards, else receive
// plane dst - n_shards), its row, the source shard with the shift's signs
// above bit 8 (bit 8 + 2c: +ext[c], bit 9 + 2c: -ext[c]), the source row.
struct PositionArgs {
  int n_shards;          // S: the launch's fields x[0..S-1]
  int n_planes;          // receive planes (destinations >= S)
  int n_rows;            // map entries
  int elem_bytes;        // 4 (float) or 8 (double)
  int vec_bytes;         // 16, 8 or 4: the moves
  int row_vecs;          // moves a coordinate row (A slots)
  int lg;                // log2 of the lanes a row
  int grid_x;            // blocks
  int device;            // the CUDA device of the launch
  long long field_plane;   // moves from coordinate row c of a field to c + 1
  long long recv_plane;    // the same in a receive plane
  double ext[3];         // the shifts, rounded to the field's dtype
  const int* map;        // [n_rows, 4], 16-byte aligned
  void* x[kMaxShards];   // shard s's [3, B, A] positions
  void* plane[kMaxPlanes];   // receive plane p, [3, n, A]
};

// One stage's atom messages of the collective transport: message (d, s),
// d = 0 the minus face and 1 the plus face, s a shard, at entry (d * S + s)
// of the outputs.
struct AtomPackArgs {
  int n_shards;          // S
  int n_cells;           // cells of a face's two send planes
  int row_elems;         // A: slots a cell
  int n_rows;            // B: cells of a shard's fields
  int cap;               // entries a packed message; 0: full planes
  int n_out;             // entries a message: cap, or n_cells * A
  int elem_bytes;        // 4 (float) or 8 (double)
  int slots;             // slots a lane moves as one vector (divides A)
  int row_vecs;          // vectors a cell row: A / slots
  int lg;                // log2 of the lanes a cell
  int grid_x;            // blocks a message
  int device;            // the CUDA device of the launch
  const int* ids[2];     // [d]: the face's send cells (box ids)
  const void* r[kMaxShards];       // shard s's [3, B, A] positions
  const void* p[kMaxShards];       // shard s's [3, B, A] momenta
  const int* gid[kMaxShards];      // shard s's [B, A] gids
  const int* n_atoms[kMaxShards];  // shard s's [B] counts
  void* rp;              // [2, S, 6, n_out]: r's three rows, then p's
  int* gid_out;          // [2, S, n_out]
  bool* valid;           // [2, S, n_out]
  bool* overflow;        // 0-dim, or-ed (packed)
};

// One fold launch.  Record k is 4R ints: the destination (shard | row <<
// kShardBits), its sources' count n with the start of its spill above bit
// 8 (n | spill << 8), then its first K = 4R - 2 sources (shard | row <<
// kShardBits) in add order; sources K..n-1 are spill[spill..].
struct FoldArgs {
  int n_shards;          // S: the launch's fields x[0..S-1]
  int n_entries;         // destination rows: records
  int n_planes;          // P: planes of a field ([P, B, A]; [B, A]: 1)
  int elem_bytes;        // 4 (float) or 8 (double)
  int vec_bytes;         // 16, 8 or 4: the moves
  int row_vecs;          // moves a row (A slots)
  int lg;                // log2 of the lanes a row
  int record_vecs;       // R: 16-byte words a record, 1..kFoldRecordVecs
  int grid_x;            // blocks a plane (the grid's y: the planes)
  int device;            // the CUDA device of the launch
  long long plane_vecs;  // moves from a plane of a field to the next
  const int* record;     // [n_entries, 4R], 16-byte aligned
  const int* spill;      // the sources past the records' K, in order
  void* x[kMaxShards];   // shard s's [P, B, A] field
};

namespace {

template <typename V>
__device__ __forceinline__ V load_cg(const V* p) { return __ldcg(p); }

// Rows first, first + stride, ... of n_rows: rows send[k] of src go into
// rows recv[k] (row k when recv is null) of dst, plane by plane, each row
// by the 2^lg lanes of its group.
template <typename V>
__device__ __forceinline__ void copy_rows(const V* src, V* dst,
                                          const int* send, const int* recv,
                                          int n_rows, int n_planes,
                                          int row_vecs, int lg,
                                          long long src_plane,
                                          long long dst_plane, int first,
                                          int stride) {
  const int sub = threadIdx.x & ((1 << lg) - 1);
  for (int k = first; k < n_rows; k += stride) {
    const long long from = static_cast<long long>(send[k]) * row_vecs;
    const long long into =
        static_cast<long long>(recv != nullptr ? recv[k] : k) * row_vecs;
    for (int q = 0; q < n_planes; ++q)
      for (int w = sub; w < row_vecs; w += 1 << lg)
        dst[q * dst_plane + into + w] = load_cg(src + q * src_plane + from + w);
  }
}

// The fused stage's rows for (direction d, shard s): F'(rhobar) of s's
// rows send[d][k] into rows recv[k] of dst (row k where recv is null: a
// receive plane), and row k of s's local copy, when there is one.
template <typename T>
__device__ __forceinline__ void embed_rows(const FillArgs& a,
                                           const FillStage& g, int d, int s,
                                           T* dst, const int* recv,
                                           int first, int stride) {
  const Embed<T> p{a.embed_n, static_cast<T>(a.embed_x0),
                   static_cast<T>(a.embed_inv_dx),
                   static_cast<const T*>(a.embed_table)};
  const int A = a.row_elems;
  const int sub = threadIdx.x & ((1 << a.elem_lg) - 1);
  const T* rho = static_cast<const T*>(a.rho[s]);
  T* local = static_cast<T*>(a.local[s]);
  for (int k = first; k < g.n_rows; k += stride) {
    const long long from = static_cast<long long>(g.send[d][k]) * A;
    const long long into =
        static_cast<long long>(recv != nullptr ? recv[k] : k) * A;
    for (int w = sub; w < A; w += 1 << a.elem_lg) {
      const T df = embed_derivative(rho[from + w], p);
      dst[into + w] = df;
      if (local != nullptr) local[static_cast<long long>(k) * A + w] = df;
    }
  }
}

template <typename T, typename V>
__global__ void __launch_bounds__(kThreads)
    halo_fill_kernel(const __grid_constant__ FillArgs a) {
  const int warp = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  const int n_entries = a.n_dirs * a.n_shards;
  for (int st = 0; st < a.n_stages; ++st) {
    if (st > 0) cg::this_grid().sync();
    const FillStage& g = a.stage[st];
    const bool eval = a.fused && st == 0;
    const int lg = eval ? a.elem_lg : a.vec_lg;
    const int rows_per_warp = 32 >> lg;
    const int first = warp * rows_per_warp + (lane >> lg);
    const int stride = gridDim.x * kWarps * rows_per_warp;
    for (int e = blockIdx.y; e < n_entries; e += gridDim.y) {
      const int d = e < a.n_shards ? 0 : 1;
      const int s = e - d * a.n_shards;
      const int t = g.to[d][s];
      const bool into_plane = t >= a.n_shards;
      void* dst = into_plane ? a.plane[t - a.n_shards] : a.x[t];
      const int* recv = into_plane ? nullptr : g.recv[d];
      if (eval)
        embed_rows<T>(a, g, d, s, static_cast<T*>(dst), recv, first, stride);
      else
        copy_rows<V>(static_cast<const V*>(a.x[s]), static_cast<V*>(dst),
                     g.send[d], recv, g.n_rows, 1, a.row_vecs, lg, 0, 0,
                     first, stride);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    ring_push_kernel(const __grid_constant__ PushArgs a) {
  const int s = blockIdx.y;
  const int f = blockIdx.z;
  const PushField& fd = a.field[f];
  const int lane = threadIdx.x & 31;
  const int rows_per_warp = 32 >> fd.lg;
  const int first = (blockIdx.x * kWarps + (threadIdx.x >> 5)) *
                        rows_per_warp + (lane >> fd.lg);
  const int stride = gridDim.x * kWarps * rows_per_warp;
  const long long dst_plane = static_cast<long long>(a.n_rows) * fd.row_vecs;
  for (int d = 0; d < a.n_dirs; ++d) {
    // the receiver's slab of direction d's arrivals, or its plane set
    const int t = a.to[d][s];
    char* out =
        t < a.n_shards
            ? static_cast<char*>(a.dst[f]) +
                  (static_cast<long long>(d) * a.n_shards + t) *
                      fd.n_planes * dst_plane * fd.vec_bytes
            : static_cast<char*>(a.set[t - a.n_shards]) + a.set_off[f];
    if (fd.vec_bytes == 16)
      copy_rows(static_cast<const uint4*>(a.src[f][s]),
                reinterpret_cast<uint4*>(out), a.send[d], nullptr, a.n_rows,
                fd.n_planes, fd.row_vecs, fd.lg, fd.src_plane, dst_plane,
                first, stride);
    else if (fd.vec_bytes == 8)
      copy_rows(static_cast<const uint2*>(a.src[f][s]),
                reinterpret_cast<uint2*>(out), a.send[d], nullptr, a.n_rows,
                fd.n_planes, fd.row_vecs, fd.lg, fd.src_plane, dst_plane,
                first, stride);
    else
      copy_rows(static_cast<const unsigned int*>(a.src[f][s]),
                reinterpret_cast<unsigned int*>(out), a.send[d], nullptr,
                a.n_rows, fd.n_planes, fd.row_vecs, fd.lg, fd.src_plane,
                dst_plane, first, stride);
  }
}

// N elements of T moved as one aligned vector.
template <typename T, int N>
struct alignas(sizeof(T) * N) Pack {
  T v[N];
};

__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
    position_fill_kernel(const __grid_constant__ PositionArgs a) {
  using V = Pack<T, N>;
  const int lane = threadIdx.x & 31;
  const int sub = lane & ((1 << a.lg) - 1);
  const int rows_per_warp = 32 >> a.lg;
  const int stride = gridDim.x * kWarps * rows_per_warp;
  const int4* map = reinterpret_cast<const int4*>(a.map);
  for (int k = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * rows_per_warp +
               (lane >> a.lg);
       k < a.n_rows; k += stride) {
    const int4 e = map[k];
    const int src = e.z & 0xff;
    const int signs = e.z >> 8;
    const V* from = static_cast<const V*>(a.x[src]) +
                    static_cast<long long>(e.w) * a.row_vecs;
    const bool into_plane = e.x >= a.n_shards;
    V* into = into_plane ? static_cast<V*>(a.plane[e.x - a.n_shards])
                         : static_cast<V*>(a.x[e.x]);
    into += static_cast<long long>(e.y) * a.row_vecs;
    const long long into_plane_vecs =
        into_plane ? a.recv_plane : a.field_plane;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const int sign = (signs >> (2 * c)) & 3;   // 1: +ext, 2: -ext, 0: none
      const T shift = static_cast<T>(sign == 2 ? -a.ext[c] : a.ext[c]);
      for (int w = sub; w < a.row_vecs; w += 1 << a.lg) {
        V v = from[c * a.field_plane + w];
        if (sign != 0) {
#pragma unroll
          for (int i = 0; i < N; ++i) v.v[i] = add_rn(v.v[i], shift);
        }
        into[c * into_plane_vecs + w] = v;
      }
    }
  }
}

template <typename T, int N>
cudaError_t launch_positions(const PositionArgs& a, cudaStream_t stream) {
  position_fill_kernel<T, N>
      <<<static_cast<unsigned>(a.grid_x), kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

__device__ __forceinline__ int clamp_count(int n, int A) {
  return n < 0 ? 0 : (n > A ? A : n);
}

static_assert(kPackCells <= kThreads, "atom_pack's chunk: a thread a cell");

template <typename T, int S>
__global__ void __launch_bounds__(kThreads)
    atom_pack_kernel(const __grid_constant__ AtomPackArgs a) {
  using VT = Pack<T, S>;
  using VG = Pack<int, S>;
  __shared__ int box_s[kPackCells], cnt_s[kPackCells];
  __shared__ int off_s[kPackCells];
  __shared__ int part_s[kWarps][3];   // a warp's sums: before, all, chunk
  // each warp's staged entries: r's and p's six rows, gid, validity
  __shared__ T stage_s[kWarps][6][32 * S];
  __shared__ int gid_s[kWarps][32 * S];
  __shared__ bool ok_s[kWarps][32 * S];
  const int m = blockIdx.y;                 // message d * S + s
  const int d = m >= a.n_shards ? 1 : 0;
  const int s = m - d * a.n_shards;
  const int* ids = a.ids[d];
  const int* n_atoms = a.n_atoms[s];
  const int A = a.row_elems;
  const int first = blockIdx.x * kPackCells;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool packed = a.cap > 0;
  // this chunk's cells, a thread a cell
  int mine = 0;
  if (static_cast<int>(threadIdx.x) < kPackCells) {
    const int c = first + threadIdx.x;
    const int box = c < a.n_cells ? ids[c] : 0;
    mine = c < a.n_cells ? clamp_count(n_atoms[box], A) : 0;
    box_s[threadIdx.x] = box;
    cnt_s[threadIdx.x] = mine;
  }
  int count = 0;   // the message's real slots (packed)
  if (packed) {
    // the message's counts in one pass: every id loaded, then every
    // count, then the sums before this chunk and in all; beside them the
    // chunk's own scan
    int before = 0;
    for (int r0 = 0; r0 < a.n_cells; r0 += kThreads * kScanCells) {
      int box[kScanCells];
      int cnt[kScanCells];
#pragma unroll
      for (int i = 0; i < kScanCells; ++i) {
        const int c = r0 + i * kThreads + threadIdx.x;
        box[i] = c < a.n_cells ? ids[c] : 0;
      }
#pragma unroll
      for (int i = 0; i < kScanCells; ++i) cnt[i] = n_atoms[box[i]];
#pragma unroll
      for (int i = 0; i < kScanCells; ++i) {
        const int c = r0 + i * kThreads + threadIdx.x;
        const int v = c < a.n_cells ? clamp_count(cnt[i], A) : 0;
        count += v;
        if (c < first) before += v;
      }
    }
    int inc = mine;
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, inc, o);
      if (lane >= o) inc += v;
    }
    for (int o = 16; o > 0; o >>= 1) {
      before += __shfl_xor_sync(0xffffffffu, before, o);
      count += __shfl_xor_sync(0xffffffffu, count, o);
    }
    if (lane == 31) {
      part_s[warp][0] = before;
      part_s[warp][1] = count;
      part_s[warp][2] = inc;
    }
    __syncthreads();
    int off = inc - mine;
    before = count = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      before += part_s[w][0];
      count += part_s[w][1];
      if (w < warp) off += part_s[w][2];
    }
    if (static_cast<int>(threadIdx.x) < kPackCells)
      off_s[threadIdx.x] = before + off;
  }
  __syncthreads();
  const long long n_out = a.n_out;
  const long long plane = static_cast<long long>(a.n_rows) * A;
  T* rp = static_cast<T*>(a.rp) + static_cast<long long>(m) * 6 * n_out;
  int* gid_out = a.gid_out + m * n_out;
  bool* valid = a.valid + m * n_out;
  const T* r = static_cast<const T*>(a.r[s]);
  const T* p = static_cast<const T*>(a.p[s]);
  const int* gid = a.gid[s];
  const int here = min(kPackCells, a.n_cells - first);
  const int sub = threadIdx.x & ((1 << a.lg) - 1);
  const int lim_cap = packed ? a.cap : 0x7fffffff;
  if (packed) {   // this block's share of the valid flags and the tail
    const int per = (a.cap + gridDim.x - 1) / gridDim.x;
    const int lo = blockIdx.x * per;
    const int hi = min(a.cap, lo + per);
    for (int k = lo + threadIdx.x; k < hi; k += kThreads) {
      valid[k] = k < count;
      if (k >= count) {
#pragma unroll
        for (int q = 0; q < 6; ++q) rp[q * n_out + k] = T(0);
        gid_out[k] = kEmptyGid;
      }
    }
    if (blockIdx.x == 0 && threadIdx.x == 0 && count > a.cap)
      *a.overflow = true;
  }
  // a pass: every group one cell (and, past 32 vectors a row, one warp's
  // width of its vectors at a time); a warp's real slots of a pass are
  // consecutive entries, staged in shared memory and stored by
  // consecutive lanes
  for (int c0 = 0; c0 < here; c0 += kThreads >> a.lg) {
    const int c = c0 + (threadIdx.x >> a.lg);
    const bool live = c < here;
    const int n = live ? cnt_s[c] : 0;
    const int lim = packed ? n : A;   // the slots this cell sends
    const long long row = live ? static_cast<long long>(box_s[c]) * A : 0;
    const int at = !live ? 0 : packed ? off_s[c] : (first + c) * A;
    for (int w0 = 0; w0 < a.row_vecs; w0 += 1 << a.lg) {
      const int slot0 = (w0 + sub) * S;
      const bool any = live && w0 + sub < a.row_vecs && slot0 < lim;
      VT x[6];
      VG g;
      if (any) {
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          x[q] = *reinterpret_cast<const VT*>(r + q * plane + row + slot0);
          x[3 + q] =
              *reinterpret_cast<const VT*>(p + q * plane + row + slot0);
        }
        g = *reinterpret_cast<const VG*>(gid + row + slot0);
      }
      const int lo = __reduce_min_sync(
          0xffffffffu, any ? at + slot0 : 0x7fffffff);
      const int hi = min(lim_cap, __reduce_max_sync(
          0xffffffffu, any ? at + min(slot0 + S, lim) : 0));
      if (any) {
#pragma unroll
        for (int i = 0; i < S; ++i) {
          const int e = at + slot0 + i - lo;
          if (slot0 + i < lim && lo + e < hi) {
#pragma unroll
            for (int q = 0; q < 6; ++q) stage_s[warp][q][e] = x[q].v[i];
            gid_s[warp][e] = g.v[i];
            ok_s[warp][e] = slot0 + i < n;
          }
        }
      }
      __syncwarp();
      for (int e = lane; e < hi - lo; e += 32) {
        const long long k = lo + e;
#pragma unroll
        for (int q = 0; q < 6; ++q) rp[q * n_out + k] = stage_s[warp][q][e];
        gid_out[k] = gid_s[warp][e];
        if (!packed) valid[k] = ok_s[warp][e];
      }
      __syncwarp();
    }
  }
}

template <typename T, int S>
cudaError_t launch_pack(const AtomPackArgs& a, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(a.grid_x),
                  static_cast<unsigned>(2 * a.n_shards));
  atom_pack_kernel<T, S><<<grid, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

// Row `word >> kShardBits` of shard `word & (kMaxShards - 1)`'s field.
template <typename V>
__device__ __forceinline__ V* fold_row(const FoldArgs& a, int word) {
  return static_cast<V*>(a.x[word & (kMaxShards - 1)]) +
         static_cast<long long>(word >> kShardBits) * a.row_vecs;
}

template <typename T, int N, int R>
__global__ void __launch_bounds__(kThreads)
    fold_halo_kernel(const __grid_constant__ FoldArgs a) {
  using V = Pack<T, N>;
  constexpr int K = 4 * R - 2;   // sources inline in a record
  const int lane = threadIdx.x & 31;
  const int sub = lane & ((1 << a.lg) - 1);
  const int k = (blockIdx.x * kWarps + (threadIdx.x >> 5)) *
                    (32 >> a.lg) + (lane >> a.lg);
  if (k >= a.n_entries) return;
  int w[4 * R];
  const int4* rec =
      reinterpret_cast<const int4*>(a.record) + static_cast<long long>(k) * R;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int4 q = rec[i];
    w[4 * i] = q.x;
    w[4 * i + 1] = q.y;
    w[4 * i + 2] = q.z;
    w[4 * i + 3] = q.w;
  }
  const int n = w[1] & 0xff;
  const long long at = static_cast<long long>(blockIdx.y) * a.plane_vecs;
  V* __restrict__ into = fold_row<V>(a, w[0]) + at;
  for (int v = sub; v < a.row_vecs; v += 1 << a.lg) {
    V acc = into[v];
    V src[K];
#pragma unroll
    for (int j = 0; j < K; ++j)
      if (j < n) src[j] = (fold_row<const V>(a, w[2 + j]) + at)[v];
#pragma unroll
    for (int j = 0; j < K; ++j)
      if (j < n) {
#pragma unroll
        for (int i = 0; i < N; ++i) acc.v[i] = add_rn(acc.v[i], src[j].v[i]);
      }
    for (int j = K; j < n; ++j) {   // the spill, in order
      const V x = (fold_row<const V>(a, a.spill[(w[1] >> 8) + j - K]) + at)[v];
#pragma unroll
      for (int i = 0; i < N; ++i) acc.v[i] = add_rn(acc.v[i], x.v[i]);
    }
    into[v] = acc;
  }
}

template <typename T, int N>
cudaError_t launch_fold(const FoldArgs& a, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(a.grid_x),
                  static_cast<unsigned>(a.n_planes));
  if (a.record_vecs == 1)
    fold_halo_kernel<T, N, 1><<<grid, kThreads, 0, stream>>>(a);
  else if (a.record_vecs == 2)
    fold_halo_kernel<T, N, 2><<<grid, kThreads, 0, stream>>>(a);
  else
    fold_halo_kernel<T, N, 3><<<grid, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

// Makes `device` current for the launch and puts the caller's back.
struct DeviceGuard {
  int prev = -1;
  cudaError_t err = cudaSuccess;
  explicit DeviceGuard(int device) {
    err = cudaGetDevice(&prev);
    if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  }
  ~DeviceGuard() {
    int cur = -1;
    if (prev >= 0 && cudaGetDevice(&cur) == cudaSuccess && cur != prev)
      cudaSetDevice(prev);
  }
};

// Blocks of halo_fill_kernel<T, V> the device holds at once (0: not yet
// asked; -1: no cooperative launch).
template <typename T, typename V>
cudaError_t co_resident(int device, int* blocks) {
  static int cache[kMaxDevices] = {0};
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cache[device] == 0) {
    int coop = 0, sms = 0, per_sm = 0;
    cudaError_t err =
        cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
    if (err != cudaSuccess) return err;
    if (!coop) {
      cache[device] = -1;
    } else {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   device);
      if (err != cudaSuccess) return err;
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, halo_fill_kernel<T, V>, kThreads, 0);
      if (err != cudaSuccess) return err;
      cache[device] = sms * per_sm > 0 ? sms * per_sm : -1;
    }
  }
  if (cache[device] < 0) return cudaErrorNotSupported;
  *blocks = cache[device];
  return cudaSuccess;
}

template <typename T, typename V>
cudaError_t launch_fill(const FillArgs& a, cudaStream_t stream) {
  if (a.n_stages == 1) {   // no grid barrier: an ordinary launch
    halo_fill_kernel<T, V>
        <<<dim3(static_cast<unsigned>(a.grid_x),
                static_cast<unsigned>(a.grid_y)),
           kThreads, 0, stream>>>(a);
    return cudaGetLastError();
  }
  int cap = 0;
  cudaError_t err = co_resident<T, V>(a.device, &cap);
  if (err != cudaSuccess) return err;
  const int gy = a.grid_y < cap ? a.grid_y : cap;
  int gx = cap / gy;
  if (gx > a.grid_x) gx = a.grid_x;
  if (gx < 1) gx = 1;
  void* params[] = {const_cast<FillArgs*>(&a)};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(halo_fill_kernel<T, V>),
      dim3(static_cast<unsigned>(gx), static_cast<unsigned>(gy)),
      dim3(kThreads), params, 0, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_fill_vec(const FillArgs& a, cudaStream_t stream) {
  if (a.vec_bytes == 16) return launch_fill<T, uint4>(a, stream);
  if (a.vec_bytes == 8) return launch_fill<T, uint2>(a, stream);
  return launch_fill<T, unsigned int>(a, stream);
}

bool lg_ok(int lg) { return lg >= 0 && lg <= 5; }

}  // namespace

extern "C" {

// The dfEmbed fill (or K4 alone).  Returns the launch's cudaError_t;
// cudaErrorNotSupported when the device has no cooperative launch.
int comd_halo_fill(const FillArgs* a, void* stream) {
  if (a == nullptr || a->n_shards < 1 || a->n_shards > kMaxShards ||
      a->n_dirs < 1 || a->n_dirs > 2 || a->n_stages < 1 ||
      a->n_stages > kMaxStages || a->row_elems < 1 || a->row_vecs < 1 ||
      !lg_ok(a->vec_lg) || !lg_ok(a->elem_lg) || a->grid_x < 1 ||
      a->grid_y != a->n_dirs * a->n_shards ||
      (a->elem_bytes != 4 && a->elem_bytes != 8) ||
      (a->vec_bytes != 4 && a->vec_bytes != 8 && a->vec_bytes != 16) ||
      (a->fused && (a->embed_table == nullptr || a->embed_n < 1)) ||
      a->n_planes < 0 || a->n_planes > kMaxPlanes ||
      (a->n_planes > 0 && a->n_stages != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int p = 0; p < a->n_planes; ++p)
    if (a->plane[p] == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  for (int st = 0; st < a->n_stages; ++st) {
    const FillStage& g = a->stage[st];
    if (g.n_rows < 1) return static_cast<int>(cudaErrorInvalidValue);
    for (int d = 0; d < a->n_dirs; ++d)
      if (g.send[d] == nullptr || g.recv[d] == nullptr || g.to[d] == nullptr)
        return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int s = 0; s < a->n_shards; ++s)
    if (a->x[s] == nullptr || (a->fused && a->rho[s] == nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
  DeviceGuard guard(a->device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a->elem_bytes == 4) return static_cast<int>(launch_fill_vec<float>(*a, st));
  return static_cast<int>(launch_fill_vec<double>(*a, st));
}

// One atom-exchange stage.  Returns the launch's cudaError_t.
int comd_ring_push(const PushArgs* a, void* stream) {
  if (a == nullptr || a->n_fields < 1 || a->n_fields > kMaxFields ||
      a->n_shards < 1 || a->n_shards > kMaxShards || a->n_dirs < 1 ||
      a->n_dirs > 2 || a->n_rows < 1 || a->grid_x < 1 || a->n_sets < 0 ||
      a->n_sets > kMaxPlanes)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int p = 0; p < a->n_sets; ++p)
    if (a->set[p] == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  for (int d = 0; d < a->n_dirs; ++d)
    if (a->send[d] == nullptr || a->to[d] == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
  for (int f = 0; f < a->n_fields; ++f) {
    const PushField& fd = a->field[f];
    if (fd.n_planes < 1 || fd.row_vecs < 1 || !lg_ok(fd.lg) ||
        (fd.vec_bytes != 4 && fd.vec_bytes != 8 && fd.vec_bytes != 16) ||
        a->dst[f] == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    for (int s = 0; s < a->n_shards; ++s)
      if (a->src[f][s] == nullptr)
        return static_cast<int>(cudaErrorInvalidValue);
  }
  DeviceGuard guard(a->device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  const dim3 grid(static_cast<unsigned>(a->grid_x),
                  static_cast<unsigned>(a->n_shards),
                  static_cast<unsigned>(a->n_fields));
  ring_push_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      *a);
  return static_cast<int>(cudaGetLastError());
}

// A position refresh, or one stage of it.  Returns the launch's
// cudaError_t.
int comd_position_fill(const PositionArgs* a, void* stream) {
  if (a == nullptr || a->n_shards < 1 || a->n_shards > kMaxShards ||
      a->n_planes < 0 || a->n_planes > kMaxPlanes || a->n_rows < 1 ||
      a->row_vecs < 1 || !lg_ok(a->lg) || a->grid_x < 1 ||
      a->map == nullptr || a->field_plane < a->row_vecs ||
      (a->n_planes > 0 && a->recv_plane < a->row_vecs) ||
      (a->elem_bytes != 4 && a->elem_bytes != 8) ||
      (a->vec_bytes != 4 && a->vec_bytes != 8 && a->vec_bytes != 16) ||
      a->vec_bytes < a->elem_bytes)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int s = 0; s < a->n_shards; ++s)
    if (a->x[s] == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  for (int p = 0; p < a->n_planes; ++p)
    if (a->plane[p] == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  DeviceGuard guard(a->device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (a->elem_bytes == 4)
    err = a->vec_bytes == 16  ? launch_positions<float, 4>(*a, st)
          : a->vec_bytes == 8 ? launch_positions<float, 2>(*a, st)
                              : launch_positions<float, 1>(*a, st);
  else
    err = a->vec_bytes == 16 ? launch_positions<double, 2>(*a, st)
                             : launch_positions<double, 1>(*a, st);
  return static_cast<int>(err);
}

// One stage's atom messages (collective).  Returns the launch's
// cudaError_t.
int comd_atom_pack(const AtomPackArgs* a, void* stream) {
  if (a == nullptr || a->n_shards < 1 || a->n_shards > kMaxShards ||
      a->n_cells < 1 || a->row_elems < 1 || a->n_rows < 1 || a->cap < 0 ||
      a->n_out != (a->cap > 0 ? a->cap : a->n_cells * a->row_elems) ||
      a->grid_x != (a->n_cells + kPackCells - 1) / kPackCells ||
      (a->elem_bytes != 4 && a->elem_bytes != 8) ||
      a->slots < 1 || (a->slots & (a->slots - 1)) != 0 ||
      a->slots * a->elem_bytes > 16 ||
      a->row_elems % a->slots != 0 ||
      a->row_vecs != a->row_elems / a->slots || !lg_ok(a->lg) ||
      a->ids[0] == nullptr || a->ids[1] == nullptr || a->rp == nullptr ||
      a->gid_out == nullptr || a->valid == nullptr ||
      (a->cap > 0 && a->overflow == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int s = 0; s < a->n_shards; ++s)
    if (a->r[s] == nullptr || a->p[s] == nullptr || a->gid[s] == nullptr ||
        a->n_atoms[s] == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
  DeviceGuard guard(a->device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (a->elem_bytes == 4)
    err = a->slots == 4   ? launch_pack<float, 4>(*a, st)
          : a->slots == 2 ? launch_pack<float, 2>(*a, st)
                          : launch_pack<float, 1>(*a, st);
  else
    err = a->slots == 2 ? launch_pack<double, 2>(*a, st)
                        : launch_pack<double, 1>(*a, st);
  return static_cast<int>(err);
}

// One fold launch (the serial fold, or one stage of the mesh's).  Returns
// the launch's cudaError_t.
int comd_fold_halo(const FoldArgs* a, void* stream) {
  if (a == nullptr || a->n_shards < 1 || a->n_shards > kMaxShards ||
      a->n_entries < 1 || a->n_planes < 1 || a->row_vecs < 1 ||
      !lg_ok(a->lg) || a->grid_x < 1 || a->record == nullptr ||
      a->record_vecs < 1 || a->record_vecs > kFoldRecordVecs ||
      a->spill == nullptr || a->plane_vecs < a->row_vecs ||
      (a->elem_bytes != 4 && a->elem_bytes != 8) ||
      (a->vec_bytes != 4 && a->vec_bytes != 8 && a->vec_bytes != 16) ||
      a->vec_bytes < a->elem_bytes)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int s = 0; s < a->n_shards; ++s)
    if (a->x[s] == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  DeviceGuard guard(a->device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (a->elem_bytes == 4)
    err = a->vec_bytes == 16  ? launch_fold<float, 4>(*a, st)
          : a->vec_bytes == 8 ? launch_fold<float, 2>(*a, st)
                              : launch_fold<float, 1>(*a, st);
  else
    err = a->vec_bytes == 16 ? launch_fold<double, 2>(*a, st)
                             : launch_fold<double, 1>(*a, st);
  return static_cast<int>(err);
}

const char* comd_comm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// ---- the receive-plane arena (across processes) ----

// `bytes` of device memory on `device` from cudaMalloc (its own
// allocation, so that its IPC handle names it and nothing else), zeroed,
// the zeros written before this returns.
int comd_arena_alloc(void** ptr, long long bytes, int device) {
  if (ptr == nullptr || bytes < 1) return static_cast<int>(cudaErrorInvalidValue);
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  *ptr = nullptr;
  cudaError_t err = cudaMalloc(ptr, static_cast<size_t>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemset(*ptr, 0, static_cast<size_t>(bytes));
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  if (err != cudaSuccess) {
    cudaFree(*ptr);
    *ptr = nullptr;
  }
  return static_cast<int>(err);
}

int comd_arena_free(void* ptr, int device) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  return static_cast<int>(cudaFree(ptr));
}

// The 64-byte IPC handle of an arena into `handle`.
int comd_ipc_handle(void* ptr, int device, unsigned char* handle) {
  if (ptr == nullptr || handle == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  cudaIpcMemHandle_t h;
  const cudaError_t err = cudaIpcGetMemHandle(&h, ptr);
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int i = 0; i < static_cast<int>(sizeof(h.reserved)); ++i)
    handle[i] = static_cast<unsigned char>(h.reserved[i]);
  return 0;
}

// A peer process's arena, opened on `device` from its handle.  Never the
// calling process's own handle: CUDA refuses that.
int comd_ipc_open(const unsigned char* handle, int device, void** ptr) {
  if (handle == nullptr || ptr == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  cudaIpcMemHandle_t h;
  for (int i = 0; i < static_cast<int>(sizeof(h.reserved)); ++i)
    h.reserved[i] = static_cast<char>(handle[i]);
  *ptr = nullptr;
  return static_cast<int>(
      cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess));
}

int comd_ipc_close(void* ptr, int device) {
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  return static_cast<int>(cudaIpcCloseMemHandle(ptr));
}

// Peer access from `device` to `peer` (a card a process): refused with
// cudaErrorPeerAccessUnsupported where the two cards cannot reach each
// other; enabling it twice is not an error.
int comd_peer_access(int device, int peer) {
  if (device == peer) return 0;
  int can = 0;
  cudaError_t err = cudaDeviceCanAccessPeer(&can, device, peer);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!can) return static_cast<int>(cudaErrorPeerAccessUnsupported);
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  err = cudaDeviceEnablePeerAccess(peer, 0);
  if (err == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();
    err = cudaSuccess;
  }
  return static_cast<int>(err);
}

// ---- the ready counters: stream memory operations (cuda.h, libcuda) ----

// On `stream`: wait until the 32-bit counter at `addr` has reached `value`
// (cyclic greater-or-equal).  The stream's front end waits; no kernel
// spins.  Returns the CUresult.
int comd_stream_wait(void* stream, void* addr, unsigned int value) {
  return static_cast<int>(cuStreamWaitValue32(
      static_cast<CUstream>(stream), reinterpret_cast<CUdeviceptr>(addr),
      value, CU_STREAM_WAIT_VALUE_GEQ));
}

// On `stream`: write `value` to the 32-bit counter at `addr` (this
// process's arena or a peer's), after a memory barrier that makes every
// earlier write of the stream visible first.  Returns the CUresult.
int comd_stream_write(void* stream, void* addr, unsigned int value) {
  return static_cast<int>(cuStreamWriteValue32(
      static_cast<CUstream>(stream), reinterpret_cast<CUdeviceptr>(addr),
      value, CU_STREAM_WRITE_VALUE_DEFAULT));
}

const char* comd_cu_error_string(int err) {
  const char* msg = nullptr;
  if (cuGetErrorString(static_cast<CUresult>(err), &msg) != CUDA_SUCCESS ||
      msg == nullptr)
    return "unknown CUresult";
  return msg;
}

}  // extern "C"
