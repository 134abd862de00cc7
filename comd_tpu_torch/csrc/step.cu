// The small ops of the velocity-Verlet step around the EAM force, for
// Hopper (sm_90a): four kernels in place of ~66 PyTorch launches a step.
//
// What they replace.  No Pallas kernel: comd_tpu's jitted step
// (comd_tpu/sim.py:337-390) leaves these ops to XLA, which fuses them
// into a few fusions around the force.  The port ran each as PyTorch
// ops, one launch an op:
//
//   kick_drift_trigger  the half kick p += (dt/2) f and the drift
//                       r += p (dt/m) over every slot (comd_tpu/sim.py:
//                       367-370), then the skin trigger: the max over the
//                       local slots of |r - last_r|^2 against (skin/2)^2
//                       (comd_tpu/ops/neighborlist.py:161-168), every
//                       shard of a mesh in one launch, written as a 0-dim
//                       bool (the or of the shards' triggers) and,
//                       inside the step's CUDA graph, set as
//                       the value of its IF nodes' conditional handles
//                       (the rebucket's node the trigger, the ghost
//                       refresh's its negation, where a mesh has one: no
//                       kernel of its own sets them); on the serial lazy
//                       and list steps also the ghost refresh (comd_tpu/
//                       sim.py:353-358): the thread that drifts a local
//                       slot writes its periodic images into the halo
//                       rows, so no other launch, and no IF node, is
//                       needed for them; without a baseline (-S 0) the
//                       kick and drift only;
//   refresh_halo        the serial halo fill r[:, halo] = r[:, halo_src] +
//                       shift, and with gid and n_atoms their copies from
//                       the sources (comd_tpu/ops/binning.py:235-248): the
//                       rebucket's halo and the initial one, one launch;
//   embed_fill          EAM pass 2: F(rhobar) and F'(rhobar) (csrc/
//                       embed.cuh), dfEmbed [B, A] with its local rows,
//                       and its halo rows either F' of their serial
//                       periodic source (the serial fill, the same bits as
//                       the copy) or 0 (a mesh transport fills them), and
//                       on energy steps U = 0.5 phi + F in the energy
//                       dtype with empty slots 0 (comd_tpu/ops/
//                       force_eam.py:371-380, :603);
//   land                the force landing f[:, :nl] = f1 (+ f3), f[:, nl:]
//                       = 0, the second half kick and the local atom
//                       count (comd_tpu/sim.py:380-383), every shard of a
//                       mesh in one launch, the count summed over them;
//   embed_rows          (ER) EAM pass 2 of the list paths, on the rows of a
//                       Verlet list (comd_tpu/ops/force_eam.py:420-439:
//                       F(rho) and F'(rho) a row, the rows-to-cells
//                       scatter of F' and the serial dfEmbed fill):
//                       embed_fill's form on the rows, a thread a vector
//                       of a cell's slots of dfEmbed [B, A] (16 bytes
//                       where A allows, else one slot), each slot F' of
//                       its row, row_start[c] + s, or of its serial
//                       source cell's (a halo slot), or 0; on energy
//                       steps the thread that owns a valid row writes
//                       its U = 0.5 phi + F from the same evaluation and
//                       further blocks zero U on the invalid rows;
//   land_rows           (LR) land's form for rows (comd_tpu/ops/
//                       force_eam.py:420-439's scatter of f1 + f3,
//                       comd_tpu/ops/force_lj.py:172-203): a thread a
//                       slot of f [3, B, A] reads its row's force (EAM's
//                       two passes added) or writes 0, then the kick and
//                       the count as land; without the kick f only (the
//                       initial force).
// The row operands of ER and LR may come as two segments (the -a 1 row
// split's interior and boundary sweeps, each its own output), read in row
// order, so no concatenation is needed.
//
// A mesh's shards.  kick_drift_trigger, embed_fill and land take the
// shards of a mesh as one stack (the step's buffers hold every field as
// one [S, ...] tensor, comd_tpu's leading shard index) and run them all
// in one launch: a grid of (blocks, shard), each shard's operands at the
// stack's stride from the previous one's.  Serially the stack is of one.
//
// Numbers.  Each kernel equals its plain PyTorch version
// (ops/cuda/step.py) bit for bit: every operation is the one PyTorch does,
// in its order, rounded once (built with -fmad=false, so nvcc contracts
// no a*b + c into an FMA), the step constants rounded to the tensor dtype
// on the host as PyTorch rounds a Python scalar.  The trigger's max is an
// integer max of the bit patterns of non-negative values (a NaN wins, and
// NaN > (skin/2)^2 is false, as PyTorch's max propagates it); the atom
// count is an integer sum.
//
// Reductions without a host read.  A block reduces in registers and
// shared memory, then thread 0 folds its value into a device scratch
// word with an atomic and takes a ticket; the block that draws the last
// ticket reads the total, writes the result (the trigger's flag, the atom
// count) and clears the scratch for the next launch.  So a launch inside
// a CUDA graph finds its scratch clear at every replay, with no memset
// node and no write by the host.
//
// Bound: bytes.  Each slot is read and written once (kick_drift_trigger
// at 63^3: p, f, r, the local baseline in, p and r out, the images' r
// out and their map in, ~97 MB; land ~78 MB; embed_fill 10.3 MB; at the
// list headline, A = 32 on 41^3 cells, embed_rows ~15 MB, land_rows
// ~116 MB), with a
// few operations a word; grid-stride loops over slots, neighbouring
// threads on neighbouring words.  embed_fill and refresh_halo, the
// smallest passes, are built for their fixed cost: a vector of slots a
// thread whose values (and U's, on energy steps; gids) fit 16-byte
// accesses (4 f32 slots, 2 f64 or with U in f64), 32-bit indices, no
// division by a runtime A in refresh_halo (a 2-D block, x along a row);
// embed_rows likewise, a cell's count and row start loaded once a
// vector, the cell found by a shift where A / W is a power of two.
//
// Plain C interface for ctypes: each entry point launches on `stream`,
// returns the cudaError_t of its launch (0 = success) and does not
// synchronize.  `elem` is the element size of the floating tensors (4 or
// 8), `e_elem` the energy dtype's.
#include <cuda_runtime.h>

#include <cstdint>

#include "embed.cuh"

namespace {

constexpr int kThreads = 256;
// The grid-stride grid's blocks an SM (ops/cuda/step.py's BLOCKS_PER_SM).
// The trigger kernel is held to it: the calls that set the IF handles
// would otherwise take registers enough to leave fewer blocks resident
// and the grid a second, partial wave.
constexpr int kBlocksPerSm = 8;

// The shards one launch of the stacked kernels takes at most
// (ops/cuda/step.py's MAX_SHARDS): the trigger keeps a word a shard.
constexpr int kMaxShards = 1024;

// The scratch words the reductions fold into (a device buffer of
// 16 + 8 kMaxShards bytes, zero before the first launch, left zero by
// every launch).
struct Scratch {
  unsigned int trigger_ticket;
  unsigned int land_sum;           // local atoms counted so far
  unsigned int land_ticket;
  unsigned int pad;
  // bit pattern of each shard's largest |dr|^2
  unsigned long long trigger_max[kMaxShards];
};

__device__ __forceinline__ unsigned long long to_bits(float x) {
  return __float_as_uint(x);
}
__device__ __forceinline__ unsigned long long to_bits(double x) {
  return static_cast<unsigned long long>(__double_as_longlong(x));
}
template <typename T>
__device__ __forceinline__ T from_bits(unsigned long long u);
template <>
__device__ __forceinline__ float from_bits<float>(unsigned long long u) {
  return __uint_as_float(static_cast<unsigned int>(u));
}
template <>
__device__ __forceinline__ double from_bits<double>(unsigned long long u) {
  return __longlong_as_double(static_cast<long long>(u));
}

// The block's max (OP 0) or sum (OP 1) of v; thread 0 holds it.
template <int OP, typename U>
__device__ __forceinline__ U block_reduce(U v) {
  __shared__ U warp_part[kThreads / 32];
  for (int o = 16; o > 0; o >>= 1) {
    const U w = __shfl_down_sync(0xffffffffu, v, o);
    v = OP == 0 ? (w > v ? w : v) : v + w;
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) warp_part[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kThreads / 32; ++w)
      v = OP == 0 ? (warp_part[w] > v ? warp_part[w] : v) : v + warp_part[w];
  }
  return v;
}

// Thread 0 of every block: after its atomic, draw a ticket; true in the
// block that draws the last one of the (x, y) grid (every block's atomic
// is then visible).
__device__ __forceinline__ bool last_block(unsigned int* ticket) {
  __threadfence();
  return atomicAdd(ticket, 1u) == gridDim.x * gridDim.y - 1;
}

// W slots of T at one aligned address: 16 bytes for the vector forms.
template <typename T, int W>
struct alignas(sizeof(T) * W) Vec {
  T v[W];
};

// The conditional handles of the step graph's IF nodes that a trigger
// launch inside the graph sets: h[0] gets the trigger (the rebucket's
// node), h[1] its negation (the ghost refresh's).  n = 0 outside a graph
// (the eager loop, a warm-up), where setting a handle is undefined.
struct IfHandles {
  cudaGraphConditionalHandle h[2];
  int n;
};

// The serial ghost images a trigger launch writes (null `start`: none, a
// mesh's shard or -S 0): the images of local cell c are entries
// [start[c], start[c + 1]), each a halo row and its periodic shift
// [3]; `local` = n_local * A < 2^31 (the wrapper checks), so the cell of a
// local slot is a 32-bit division.
template <typename T>
struct Images {
  const int* start;
  const int* row;
  const T* shift;
  int A;
  int local;
};

// Every shard of a stack: blocks (x, shard), shard s's fields 3 n slots
// after shard s - 1's; each shard's trigger is its own max against the
// threshold (a NaN there clears it, as PyTorch's max of that shard), and
// the flag their or, written by the grid's last block.
template <typename T>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    kick_drift_trigger_kernel(T* __restrict__ p_all, T* __restrict__ r_all,
                              const T* __restrict__ f_all,
                              const T* __restrict__ last_all, long long n,
                              long long n_check, T c_kick, T c_drift,
                              T thresh, Scratch* sc, bool* flag,
                              IfHandles ifs, Images<T> img) {
  const long long off = static_cast<long long>(blockIdx.y) * 3 * n;
  T* __restrict__ p = p_all + off;
  T* __restrict__ r = r_all + off;
  const T* __restrict__ f = f_all + off;
  const T* __restrict__ last = last_all == nullptr ? nullptr : last_all + off;
  unsigned long long m = 0;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < n; i += stride) {
    // with images, a halo slot is written by its source's thread only:
    // its own thread kicks p and leaves r alone (no slot drifted twice)
    const bool local = img.start == nullptr || i < img.local;
    T x[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const long long k = a * n + i;
      const T pk = p[k] + c_kick * f[k];
      p[k] = pk;
      if (local) {
        x[a] = r[k] + pk * c_drift;
        r[k] = x[a];
      }
    }
    if (img.start != nullptr && local) {
      // the slot's images: x plus each image's shift, rounded once, the
      // bits the refresh reads back from r and adds
      const unsigned int c = static_cast<unsigned int>(i) /
                             static_cast<unsigned int>(img.A);
      const int s = static_cast<int>(i) - static_cast<int>(c) * img.A;
      const int end = img.start[c + 1];
      for (int j = img.start[c]; j < end; ++j) {
        const long long to =
            static_cast<long long>(img.row[j]) * img.A + s;
#pragma unroll
        for (int a = 0; a < 3; ++a)
          r[a * n + to] = x[a] + img.shift[3 * j + a];
      }
    }
    if (i < n_check) {
      const T d0 = x[0] - last[i];
      const T d1 = x[1] - last[n + i];
      const T d2 = x[2] - last[2 * n + i];
      const unsigned long long b = to_bits(d0 * d0 + d1 * d1 + d2 * d2);
      m = b > m ? b : m;
    }
  }
  if (flag == nullptr) return;  // -S 0: the kick and drift only
  m = block_reduce<0>(m);
  if (threadIdx.x == 0) {
    atomicMax(&sc->trigger_max[blockIdx.y], m);
    if (last_block(&sc->trigger_ticket)) {
      bool fire = false;
      for (unsigned int s = 0; s < gridDim.y; ++s) {
        const unsigned long long v = atomicExch(&sc->trigger_max[s], 0ull);
        fire = fire || from_bits<T>(v) > thresh;
      }
      *flag = fire;
      sc->trigger_ticket = 0;
      if (ifs.n > 0) cudaGraphSetConditional(ifs.h[0], fire ? 1u : 0u);
      if (ifs.n > 1) cudaGraphSetConditional(ifs.h[1], fire ? 0u : 1u);
    }
  }
}

// The serial halo fill: each halo row's positions from its periodic
// source row plus the row's shift, and with `gid` its gids and atom count
// (`n_atoms`), W slots a thread in accesses of at most 16 bytes.  A block
// is a 2-D array of threads, x along a row's vectors, y over rows, so no
// thread divides; rows in a grid-stride loop.  32-bit indices within a
// plane (the wrapper checks n_total * A < 2^31).
template <typename T, int W>
__global__ void __launch_bounds__(kThreads)
    refresh_halo_kernel(T* __restrict__ r, int* __restrict__ gid,
                        int* __restrict__ n_atoms,
                        const long long* __restrict__ src,
                        const T* __restrict__ shift, int n_halo,
                        int n_local, int per_row, int plane_vecs) {
  using V = Vec<T, W>;
  using G = Vec<int, W>;
  V* __restrict__ rv = reinterpret_cast<V*>(r);
  G* __restrict__ gv = reinterpret_cast<G*>(gid);
  const int rows = gridDim.x * blockDim.y;
  for (int h = blockIdx.x * blockDim.y + threadIdx.y; h < n_halo;
       h += rows) {
    const int from_row = static_cast<int>(src[h]);
    const int to_row = n_local + h;
    T sh[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) sh[a] = shift[3 * h + a];
    if (gid != nullptr && threadIdx.x == 0)
      n_atoms[to_row] = n_atoms[from_row];
    for (int v = threadIdx.x; v < per_row; v += blockDim.x) {
      const int from = from_row * per_row + v;
      const int to = to_row * per_row + v;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        V* pa = rv + static_cast<size_t>(a) * plane_vecs;
        V x = pa[from];
#pragma unroll
        for (int w = 0; w < W; ++w) x.v[w] = x.v[w] + sh[a];
        pa[to] = x;
      }
      if (gid != nullptr) gv[to] = gv[from];
    }
  }
}

// Store W values at `to` (aligned to W values) in accesses of at most 16
// bytes: U in f64 from f32 slots is two.
template <typename E, int W>
__device__ __forceinline__ void store_vec(E* to, const E (&x)[W]) {
  constexpr int C = W * sizeof(E) > 16 ? 16 / sizeof(E) : W;
#pragma unroll
  for (int c = 0; c < W; c += C) {
    Vec<E, C> y;
#pragma unroll
    for (int j = 0; j < C; ++j) y.v[j] = x[c + j];
    *reinterpret_cast<Vec<E, C>*>(to + c) = y;
  }
}

// Where the shards of a stack lie: shard s of each operand `*_shard`
// elements after shard s - 1's.
struct EmbedStrides {
  long long rho, phi, n_atoms, dfe, u;
};

// One vector of W slots a thread (W divides A, every pointer aligned to
// W slots); blocks (x, shard): x in [0, local_blocks) walks the
// n_local_vecs vectors of the shard's local rows, the others its halo
// rows' (a grid-stride loop over each range, once round when the wrapper
// gives a block to every 256 vectors).  All indices within a shard fit
// in 32 bits (the wrapper checks n_rows * A < 2^31).
template <typename T, typename E, int W>
__global__ void __launch_bounds__(kThreads)
    embed_fill_kernel(const T* __restrict__ rho_all,
                      const T* __restrict__ phi_all,
                      const int* __restrict__ n_atoms_all,
                      const long long* __restrict__ halo_src,
                      T* __restrict__ dfe_all, E* __restrict__ u_all,
                      EmbedStrides st, int A, int n_local_vecs,
                      int n_halo_vecs, int local_blocks, Embed<T> emb) {
  const long long shard = blockIdx.y;
  const T* __restrict__ rho = rho_all + shard * st.rho;
  const T* __restrict__ phi =
      phi_all == nullptr ? nullptr : phi_all + shard * st.phi;
  const int* __restrict__ n_atoms = n_atoms_all + shard * st.n_atoms;
  T* __restrict__ dfe = dfe_all + shard * st.dfe;
  E* __restrict__ u = u_all == nullptr ? nullptr : u_all + shard * st.u;
  using V = Vec<T, W>;
  const V* __restrict__ rv = reinterpret_cast<const V*>(rho);
  V* __restrict__ dv = reinterpret_cast<V*>(dfe);
  const int per_row = A / W;
  if (static_cast<int>(blockIdx.x) < local_blocks) {
    const int stride = local_blocks * kThreads;
    for (int v = blockIdx.x * kThreads + threadIdx.x; v < n_local_vecs;
         v += stride) {
      const V x = rv[v];
      V d;
      if (u != nullptr) {
        const V ph = reinterpret_cast<const V*>(phi)[v];
        const int row = v / per_row;
        const int s = (v - row * per_row) * W;
        const int na = n_atoms[row];
        E uv[W];
#pragma unroll
        for (int w = 0; w < W; ++w) {
          T fv;
          embed_value_and_derivative(x.v[w], emb, &fv, &d.v[w]);
          uv[w] = s + w < na ? E(0.5) * static_cast<E>(ph.v[w]) +
                                   static_cast<E>(fv)
                             : E(0);
        }
        store_vec<E, W>(u + v * W, uv);
      } else {
#pragma unroll
        for (int w = 0; w < W; ++w) d.v[w] = embed_derivative(x.v[w], emb);
      }
      dv[v] = d;
    }
  } else {
    const int stride = (gridDim.x - local_blocks) * kThreads;
    for (int v = (blockIdx.x - local_blocks) * kThreads + threadIdx.x;
         v < n_halo_vecs; v += stride) {
      V d;
      if (halo_src != nullptr) {
        const int h = v / per_row;
        const V x = rv[static_cast<int>(halo_src[h]) * per_row +
                       (v - h * per_row)];
#pragma unroll
        for (int w = 0; w < W; ++w) d.v[w] = embed_derivative(x.v[w], emb);
      } else {
#pragma unroll
        for (int w = 0; w < W; ++w) d.v[w] = T(0);
      }
      dv[n_local_vecs + v] = d;
    }
  }
}

// Every shard of a stack: blocks (x, shard), shard s's f and p 3 n slots
// after shard s - 1's, its f1, f3 and counts `f1_shard`, `f3_shard` and
// `count_shard` elements after; n_local_out the atoms of every shard.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    land_kernel(T* __restrict__ f_all, T* __restrict__ p_all,
                const T* __restrict__ f1_all, long long f1_shard,
                long long f1_plane, const T* __restrict__ f3_all,
                long long f3_shard, long long f3_plane, long long n,
                long long n_force, T c_kick,
                const int* __restrict__ n_atoms_all, long long count_shard,
                int n_local, int* n_local_out, Scratch* sc) {
  const long long shard = blockIdx.y;
  T* __restrict__ f = f_all + shard * 3 * n;
  T* __restrict__ p = p_all + shard * 3 * n;
  const T* __restrict__ f1 = f1_all + shard * f1_shard;
  const T* __restrict__ f3 =
      f3_all == nullptr ? nullptr : f3_all + shard * f3_shard;
  const int* __restrict__ n_atoms = n_atoms_all + shard * count_shard;
  const long long first =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = first; i < n; i += stride) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      T fv = T(0);
      if (i < n_force) {
        fv = f1[a * f1_plane + i];
        if (f3 != nullptr) fv = fv + f3[a * f3_plane + i];
      }
      f[a * n + i] = fv;
      p[a * n + i] = p[a * n + i] + c_kick * fv;
    }
  }
  unsigned int c = 0;
  for (long long b = first; b < n_local; b += stride)
    c += static_cast<unsigned int>(n_atoms[b]);
  c = block_reduce<1>(c);
  if (threadIdx.x == 0) {
    atomicAdd(&sc->land_sum, c);
    if (last_block(&sc->land_ticket)) {
      *n_local_out = static_cast<int>(atomicExch(&sc->land_sum, 0u));
      sc->land_ticket = 0;
    }
  }
}

// A per-row operand of ER and LR as one or two row segments: rows [0,
// split) at p0, rows [split, ...) at p1 (at row - split), plane q of a
// segment `plane0` or `plane1` elements after its plane 0.  One segment:
// split at or past the rows, p1 never read.
template <typename T>
struct RowSegs {
  const T* p0;
  const T* p1;
  long long plane0, plane1;
  int split;
  __device__ __forceinline__ T at(int q, int row) const {
    return row < split ? p0[q * plane0 + row]
                       : p1[q * plane1 + (row - split)];
  }
  // Plane 0's rows [row, row + n) through one pointer, or null where the
  // split falls inside them.
  __device__ __forceinline__ const T* run(int row, int n) const {
    if (row < split && row + n > split) return nullptr;
    return row < split ? p0 + row : p1 + (row - split);
  }
};

// ER's row blocks: rows a thread (ops/cuda/step.py's ROWS_A_THREAD).
constexpr int kRowsAThread = 4;

// ER: blocks [0, slot_blocks) walk dfEmbed's n_vecs vectors, W slots of
// one cell a thread (W divides A: 16 bytes of slots, or W = 1, the
// scalar form), the others (energy steps) U's invalid rows.  A vector of local
// cell c, or of the serial source cell of a halo cell, holds F'(rho) of
// row row_start[c] + s for each of its slots s < min(n_atoms[c], A) whose
// row is below n_rows, else 0; a halo vector without halo_src 0.  The
// cell is v >> cell_shift where A / W is a power of two (else a divide),
// its count and start are loaded once a vector, its W rows (consecutive,
// not aligned) as scalars, all before the first evaluation, and the
// vector is stored as one access.  On energy steps the thread of a local
// slot with a row writes U[row] = 0.5 phi + F from the same evaluation
// as F' (rho and F's table read once a row); the row blocks zero U on
// the rows whose a_valid is false, kRowsAThread consecutive rows a
// thread (neighbouring threads on neighbouring rows), their flags read as
// one word (valid_vec: a_valid 4-byte aligned) and their zeros stored as
// one vector where all are invalid.  The slots own exactly the valid rows
// when NR built the list from these counts.  n_slots < 2^31 (the wrapper
// checks).
template <typename T, typename E, int W>
__global__ void __launch_bounds__(kThreads)
    embed_rows_kernel(RowSegs<T> rho, RowSegs<T> phi,
                      const unsigned char* __restrict__ a_valid,
                      const int* __restrict__ row_start,
                      const int* __restrict__ n_atoms,
                      const long long* __restrict__ halo_src,
                      T* __restrict__ dfe, E* __restrict__ u, int A,
                      int n_local, int n_vecs, int n_rows, int cell_shift,
                      int valid_vec, int slot_blocks, Embed<T> emb) {
  if (static_cast<int>(blockIdx.x) < slot_blocks) {
    const int per_cell = A / W;
    const int stride = slot_blocks * kThreads;
    for (int v = blockIdx.x * kThreads + threadIdx.x; v < n_vecs;
         v += stride) {
      const int c = cell_shift >= 0 ? v >> cell_shift : v / per_cell;
      const int s0 = (v - c * per_cell) * W;
      int src = c;
      bool read = true;
      if (c >= n_local) {
        read = halo_src != nullptr;
        if (read) src = static_cast<int>(halo_src[c - n_local]);
      }
      int n = 0, row0 = 0;
      if (read) {
        n = min(n_atoms[src], A);
        row0 = row_start[src] + s0;
      }
      const bool own = u != nullptr && c < n_local;
      // slots w < lim have a row; their rows through one pointer each
      // unless a segment boundary falls among them
      const int lim = min(n - s0, n_rows - row0);
      const T* rp = rho.run(row0, W);
      const T* pp = own ? phi.run(row0, W) : nullptr;
      bool has[W];
      T x[W], ph[W];
#pragma unroll
      for (int w = 0; w < W; ++w) {
        has[w] = w < lim;
        x[w] = !has[w] ? T(0) : rp != nullptr ? rp[w] : rho.at(0, row0 + w);
        ph[w] = !has[w] || !own ? T(0)
                : pp != nullptr ? pp[w] : phi.at(0, row0 + w);
      }
      T d[W];
#pragma unroll
      for (int w = 0; w < W; ++w) {
        d[w] = T(0);
        if (!has[w]) continue;
        if (own) {
          T fv;
          embed_value_and_derivative(x[w], emb, &fv, &d[w]);
          u[row0 + w] = E(0.5) * static_cast<E>(ph[w]) + static_cast<E>(fv);
        } else {
          d[w] = embed_derivative(x[w], emb);
        }
      }
      store_vec<T, W>(dfe + static_cast<size_t>(v) * W, d);
    }
  } else {
    const int stride = (gridDim.x - slot_blocks) * kThreads;
    const int groups = (n_rows + kRowsAThread - 1) / kRowsAThread;
    for (int g = (blockIdx.x - slot_blocks) * kThreads + threadIdx.x;
         g < groups; g += stride) {
      const int r0 = kRowsAThread * g;
      unsigned int m = 0;   // byte k: a_valid[r0 + k] (past n_rows: 1)
      if (valid_vec && r0 + kRowsAThread <= n_rows) {
        m = reinterpret_cast<const unsigned int*>(a_valid)[g];
      } else {
#pragma unroll
        for (int k = 0; k < kRowsAThread; ++k)
          m |= static_cast<unsigned int>(r0 + k < n_rows ? a_valid[r0 + k]
                                                          : 1)
               << (8 * k);
      }
      if (m == 0u) {   // four invalid rows below n_rows
        E z[kRowsAThread];
#pragma unroll
        for (int k = 0; k < kRowsAThread; ++k) z[k] = E(0);
        store_vec<E, kRowsAThread>(u + r0, z);
        continue;
      }
#pragma unroll
      for (int k = 0; k < kRowsAThread; ++k)
        if (((m >> (8 * k)) & 0xffu) == 0u) u[r0 + k] = E(0);
    }
  }
}

// LR: a thread a slot of f's n_slots = B A (a grid-stride loop); local
// slot (c, s) with s < min(n_atoms[c], A) and row = row_start[c] + s below
// n_rows gets f1[row] (+ f3[row]), every other slot 0; with `kick` the
// half kick and the count, as land_kernel.  n_slots < 2^31.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    land_rows_kernel(T* __restrict__ f, T* __restrict__ p, RowSegs<T> f1,
                     RowSegs<T> f3, int has_f3,
                     const int* __restrict__ row_start,
                     const int* __restrict__ n_atoms, int A, int n_local,
                     int n_slots, int n_rows, int kick, T c_kick,
                     int* n_local_out, int add, Scratch* sc) {
  const int first = blockIdx.x * kThreads + threadIdx.x;
  const int stride = gridDim.x * kThreads;
  const int local = n_local * A;
  for (int i = first; i < n_slots; i += stride) {
    T fv[3] = {T(0), T(0), T(0)};
    if (i < local) {
      const int c = i / A;
      const int s = i - c * A;
      if (s < min(n_atoms[c], A)) {
        const int row = row_start[c] + s;
        if (row < n_rows) {
#pragma unroll
          for (int a = 0; a < 3; ++a) {
            fv[a] = f1.at(a, row);
            if (has_f3) fv[a] = fv[a] + f3.at(a, row);
          }
        }
      }
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const long long k = static_cast<long long>(a) * n_slots + i;
      f[k] = fv[a];
      if (kick) p[k] = p[k] + c_kick * fv[a];
    }
  }
  if (!kick) return;
  unsigned int c = 0;
  for (int b = first; b < n_local; b += stride)
    c += static_cast<unsigned int>(n_atoms[b]);
  c = block_reduce<1>(c);
  if (threadIdx.x == 0) {
    atomicAdd(&sc->land_sum, c);
    if (last_block(&sc->land_ticket)) {
      const unsigned int total = atomicExch(&sc->land_sum, 0u);
      const unsigned int before =
          add ? static_cast<unsigned int>(*n_local_out) : 0u;
      *n_local_out = static_cast<int>(before + total);
      sc->land_ticket = 0;
    }
  }
}

}  // namespace

// `n_shards` shards of a stack, `grid` blocks a shard; `handles`:
// n_handles (0..2) conditional handles of the graph this launch is
// captured into (IfHandles); `img_start` (null: no images; one shard
// only), `img_row`, `img_shift`: the serial ghost images (Images), `A`
// slots a cell, `n_local` local cells.
extern "C" int comd_kick_drift_trigger(int elem, void* p, void* r,
                                       const void* f, const void* last,
                                       long long n, long long n_check,
                                       double c_kick, double c_drift,
                                       double thresh, void* scratch,
                                       void* flag,
                                       const unsigned long long* handles,
                                       int n_handles, const void* img_start,
                                       const void* img_row,
                                       const void* img_shift, int A,
                                       int n_local, int n_shards, int grid,
                                       cudaStream_t stream) {
  Scratch* sc = static_cast<Scratch*>(scratch);
  bool* out = static_cast<bool*>(flag);
  if (n_handles < 0 || n_handles > 2 || (n_handles > 0 && out == nullptr) ||
      n_shards < 1 || n_shards > kMaxShards || grid < 1)
    return cudaErrorInvalidValue;
  if (img_start != nullptr &&
      (A <= 0 || n_shards != 1 ||
       static_cast<long long>(n_local) * A >= (1ll << 31)))
    return cudaErrorInvalidValue;
  const dim3 blocks(grid, n_shards);
  IfHandles ifs{{0, 0}, n_handles};
  for (int k = 0; k < n_handles; ++k) ifs.h[k] = handles[k];
  const int* start = static_cast<const int*>(img_start);
  const int* row = static_cast<const int*>(img_row);
  const int local = img_start == nullptr ? 0 : n_local * A;
  if (elem == 4)
    kick_drift_trigger_kernel<float><<<blocks, kThreads, 0, stream>>>(
        static_cast<float*>(p), static_cast<float*>(r),
        static_cast<const float*>(f), static_cast<const float*>(last), n,
        n_check, static_cast<float>(c_kick), static_cast<float>(c_drift),
        static_cast<float>(thresh), sc, out, ifs,
        Images<float>{start, row, static_cast<const float*>(img_shift), A,
                      local});
  else
    kick_drift_trigger_kernel<double><<<blocks, kThreads, 0, stream>>>(
        static_cast<double*>(p), static_cast<double*>(r),
        static_cast<const double*>(f), static_cast<const double*>(last), n,
        n_check, c_kick, c_drift, thresh, sc, out, ifs,
        Images<double>{start, row, static_cast<const double*>(img_shift), A,
                       local});
  return cudaGetLastError();
}

template <typename T, int W>
static void launch_refresh_w(void* r, void* gid, void* n_atoms,
                             const void* src, const void* shift, int n_halo,
                             int A, int n_local, int n_total, dim3 block,
                             int grid, cudaStream_t stream) {
  refresh_halo_kernel<T, W><<<grid, block, 0, stream>>>(
      static_cast<T*>(r), static_cast<int*>(gid), static_cast<int*>(n_atoms),
      static_cast<const long long*>(src), static_cast<const T*>(shift),
      n_halo, n_local, A / W, n_total * (A / W));
}

// `width`: the slots a thread takes (1, 2, or 4 with f32; A a multiple of
// it, r and gid aligned to its access: the wrapper checks); `gid` null:
// the positions only.  A block is (A / width) threads a row, up to 256,
// times the rows that fit 256 threads; `grid` blocks.
extern "C" int comd_refresh_halo(int elem, int width, void* r, void* gid,
                                 void* n_atoms, const void* src,
                                 const void* shift, int n_halo, int A,
                                 int n_local, int n_total, int grid,
                                 cudaStream_t stream) {
  if (width <= 0 || A % width != 0 || (elem == 8 && width > 2) ||
      width > 4 || width == 3 ||
      static_cast<long long>(n_total) * A >= (1ll << 31))
    return cudaErrorInvalidValue;
  const int per_row = A / width;
  const int bx = per_row < kThreads ? per_row : kThreads;
  const dim3 block(bx, kThreads / bx);
  if (elem == 4) {
    if (width == 1)
      launch_refresh_w<float, 1>(r, gid, n_atoms, src, shift, n_halo, A,
                                 n_local, n_total, block, grid, stream);
    else if (width == 2)
      launch_refresh_w<float, 2>(r, gid, n_atoms, src, shift, n_halo, A,
                                 n_local, n_total, block, grid, stream);
    else
      launch_refresh_w<float, 4>(r, gid, n_atoms, src, shift, n_halo, A,
                                 n_local, n_total, block, grid, stream);
  } else if (width == 1) {
    launch_refresh_w<double, 1>(r, gid, n_atoms, src, shift, n_halo, A,
                                n_local, n_total, block, grid, stream);
  } else {
    launch_refresh_w<double, 2>(r, gid, n_atoms, src, shift, n_halo, A,
                                n_local, n_total, block, grid, stream);
  }
  return cudaGetLastError();
}

// The stacked form's operands: `n_shards` shards, where each lies
// (EmbedStrides), and each range's blocks a shard.
struct EmbedGrid {
  EmbedStrides st;
  int n_shards, local_blocks, halo_blocks;
};

template <typename T, typename E, int W>
static void launch_embed_w(const void* rho, const void* phi,
                           const void* n_atoms, const void* halo_src,
                           void* dfe, void* u, int A, int n_local,
                           int n_rows, const Embed<T>& emb,
                           const EmbedGrid& g, cudaStream_t stream) {
  const dim3 blocks(g.local_blocks + g.halo_blocks, g.n_shards);
  embed_fill_kernel<T, E, W><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(rho), static_cast<const T*>(phi),
      static_cast<const int*>(n_atoms),
      static_cast<const long long*>(halo_src), static_cast<T*>(dfe),
      static_cast<E*>(u), g.st, A, n_local * A / W,
      (n_rows - n_local) * A / W, g.local_blocks, emb);
}

// W slots a thread: 1, 2 or (f32) 4.
template <typename T, typename E>
static cudaError_t launch_embed(int width, const void* rho, const void* phi,
                                const void* n_atoms, const void* halo_src,
                                void* dfe, void* u, int A, int n_local,
                                int n_rows, int table_n, double x0,
                                double inv_dx, const void* table,
                                const EmbedGrid& g, cudaStream_t stream) {
  const Embed<T> emb{table_n, static_cast<T>(x0), static_cast<T>(inv_dx),
                     static_cast<const T*>(table)};
  if (width == 1)
    launch_embed_w<T, E, 1>(rho, phi, n_atoms, halo_src, dfe, u, A, n_local,
                            n_rows, emb, g, stream);
  else if (width == 2)
    launch_embed_w<T, E, 2>(rho, phi, n_atoms, halo_src, dfe, u, A, n_local,
                            n_rows, emb, g, stream);
  else if constexpr (sizeof(T) == 4) {
    if (width != 4) return cudaErrorInvalidValue;
    launch_embed_w<T, E, 4>(rho, phi, n_atoms, halo_src, dfe, u, A, n_local,
                            n_rows, emb, g, stream);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// `width`: the slots a thread takes (A a multiple of it, every shard's
// pointers aligned to its access; the wrapper checks); `n_shards` shards,
// shard s of rho, phi, n_atoms, dfe and u `*_shard` elements after shard
// s - 1's; `local_blocks` and `halo_blocks`: the blocks of the two ranges
// a shard.
extern "C" int comd_embed_fill(int elem, int e_elem, int width,
                               const void* rho, const void* phi,
                               const void* n_atoms, const void* halo_src,
                               void* dfe, void* u, int A, int n_local,
                               int n_rows, int table_n, double x0,
                               double inv_dx, const void* table,
                               int n_shards, long long rho_shard,
                               long long phi_shard, long long n_atoms_shard,
                               long long dfe_shard, long long u_shard,
                               int local_blocks, int halo_blocks,
                               cudaStream_t stream) {
  if (n_shards < 1 || n_shards > 65535)
    return cudaErrorInvalidValue;
  const EmbedGrid g{
      EmbedStrides{rho_shard, phi_shard, n_atoms_shard, dfe_shard, u_shard},
      n_shards, local_blocks, halo_blocks};
  if (elem == 4 && e_elem == 8)
    return launch_embed<float, double>(width, rho, phi, n_atoms, halo_src,
                                       dfe, u, A, n_local, n_rows, table_n,
                                       x0, inv_dx, table, g, stream);
  if (elem == 4)
    return launch_embed<float, float>(width, rho, phi, n_atoms, halo_src,
                                      dfe, u, A, n_local, n_rows, table_n,
                                      x0, inv_dx, table, g, stream);
  if (e_elem == 8)
    return launch_embed<double, double>(width, rho, phi, n_atoms, halo_src,
                                        dfe, u, A, n_local, n_rows, table_n,
                                        x0, inv_dx, table, g, stream);
  return launch_embed<double, float>(width, rho, phi, n_atoms, halo_src, dfe,
                                     u, A, n_local, n_rows, table_n, x0,
                                     inv_dx, table, g, stream);
}

// `n_shards` shards of a stack, `grid` blocks a shard: shard s's f and p
// 3 n slots after shard s - 1's, its f1, f3 and n_atoms `f1_shard`,
// `f3_shard` and `n_atoms_shard` elements after; *n_local_out gets the
// atoms in the first n_local cells of every shard.
extern "C" int comd_land(int elem, void* f, void* p, const void* f1,
                         long long f1_shard, long long f1_plane,
                         const void* f3, long long f3_shard,
                         long long f3_plane, long long n, long long n_force,
                         double c_kick, const void* n_atoms,
                         long long n_atoms_shard, int n_local,
                         void* n_local_out, void* scratch, int n_shards,
                         int grid, cudaStream_t stream) {
  Scratch* sc = static_cast<Scratch*>(scratch);
  const int* na = static_cast<const int*>(n_atoms);
  int* out = static_cast<int*>(n_local_out);
  if (n_shards < 1 || n_shards > 65535 || grid < 1)
    return cudaErrorInvalidValue;
  const dim3 blocks(grid, n_shards);
  if (elem == 4)
    land_kernel<float><<<blocks, kThreads, 0, stream>>>(
        static_cast<float*>(f), static_cast<float*>(p),
        static_cast<const float*>(f1), f1_shard, f1_plane,
        static_cast<const float*>(f3), f3_shard, f3_plane, n, n_force,
        static_cast<float>(c_kick), na, n_atoms_shard, n_local, out, sc);
  else
    land_kernel<double><<<blocks, kThreads, 0, stream>>>(
        static_cast<double*>(f), static_cast<double*>(p),
        static_cast<const double*>(f1), f1_shard, f1_plane,
        static_cast<const double*>(f3), f3_shard, f3_plane, n, n_force,
        c_kick, na, n_atoms_shard, n_local, out, sc);
  return cudaGetLastError();
}

template <typename T>
static RowSegs<T> row_segs(const void* p0, const void* p1, long long plane0,
                           long long plane1, int split) {
  return RowSegs<T>{static_cast<const T*>(p0), static_cast<const T*>(p1),
                    plane0, plane1, split};
}

template <typename T, typename E, int W>
static void launch_embed_rows_w(const RowSegs<T>& rho, const RowSegs<T>& phi,
                                const void* a_valid, const void* row_start,
                                const void* n_atoms, const void* halo_src,
                                void* dfe, void* u, int A, int n_local,
                                int n_slots, int n_rows, const Embed<T>& emb,
                                int slot_blocks, int row_blocks,
                                cudaStream_t stream) {
  const int per_cell = A / W;
  const int shift =
      (per_cell & (per_cell - 1)) == 0 ? __builtin_ctz(per_cell) : -1;
  embed_rows_kernel<T, E, W><<<slot_blocks + row_blocks, kThreads, 0,
                               stream>>>(
      rho, phi, static_cast<const unsigned char*>(a_valid),
      static_cast<const int*>(row_start), static_cast<const int*>(n_atoms),
      static_cast<const long long*>(halo_src), static_cast<T*>(dfe),
      static_cast<E*>(u), A, n_local, n_slots / W, n_rows, shift,
      reinterpret_cast<uintptr_t>(a_valid) % 4 == 0, slot_blocks, emb);
}

// W slots a thread: 16 / sizeof(T) (the vector form: one 16-byte
// store) or 1 (the scalar form, for A that the vector's width does not
// divide).  Two vectors a thread measured slower at the 63^3 list
// headline on an H100.
template <typename T, typename E>
static cudaError_t launch_embed_rows(
    int width, const void* rho0, const void* rho1, int rho_split,
    const void* phi0, const void* phi1, int phi_split, const void* a_valid,
    const void* row_start, const void* n_atoms, const void* halo_src,
    void* dfe, void* u, int A, int n_local, int n_slots, int n_rows,
    int table_n, double x0, double inv_dx, const void* table,
    int slot_blocks, int row_blocks, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  if ((width != 1 && width != kVec) || A % width != 0)
    return cudaErrorInvalidValue;
  const Embed<T> emb{table_n, static_cast<T>(x0), static_cast<T>(inv_dx),
                     static_cast<const T*>(table)};
  const RowSegs<T> rho = row_segs<T>(rho0, rho1, 0, 0, rho_split);
  const RowSegs<T> phi = row_segs<T>(phi0, phi1, 0, 0, phi_split);
  if (width == kVec)
    launch_embed_rows_w<T, E, kVec>(rho, phi, a_valid, row_start, n_atoms,
                                    halo_src, dfe, u, A, n_local, n_slots,
                                    n_rows, emb, slot_blocks, row_blocks,
                                    stream);
  else
    launch_embed_rows_w<T, E, 1>(rho, phi, a_valid, row_start, n_atoms,
                                 halo_src, dfe, u, A, n_local, n_slots,
                                 n_rows, emb, slot_blocks, row_blocks,
                                 stream);
  return cudaGetLastError();
}

// ER.  rho (and phi, null without energy) as one or two row segments
// (rho1 at row rho_split); a_valid [n_rows] bool; row_start [n_local] and
// n_atoms int32 indexed by cell; halo_src [n_slots / A - n_local] int64 or
// null (zero halo rows); writes dfe [n_slots] (16-byte aligned) and, with
// phi, u [n_rows] of the energy dtype (e_elem bytes, 16-byte aligned).
// `width`: the slots a thread (launch_embed_rows); `row_blocks` 0 without
// phi.
extern "C" int comd_embed_rows(int elem, int e_elem, int width,
                               const void* rho0, const void* rho1,
                               int rho_split, const void* phi0,
                               const void* phi1, int phi_split,
                               const void* a_valid, const void* row_start,
                               const void* n_atoms, const void* halo_src,
                               void* dfe, void* u, int A, int n_local,
                               int n_slots, int n_rows, int table_n,
                               double x0, double inv_dx, const void* table,
                               int slot_blocks, int row_blocks,
                               cudaStream_t stream) {
  if (A < 1 || n_local < 0 || n_slots < n_local * A || n_slots % A != 0 ||
      slot_blocks < 1 || (u == nullptr) != (row_blocks == 0) ||
      (u != nullptr && !phi0))
    return cudaErrorInvalidValue;
  if (elem == 4 && e_elem == 8)
    return launch_embed_rows<float, double>(
        width, rho0, rho1, rho_split, phi0, phi1, phi_split, a_valid,
        row_start, n_atoms, halo_src, dfe, u, A, n_local, n_slots, n_rows,
        table_n, x0, inv_dx, table, slot_blocks, row_blocks, stream);
  if (elem == 4)
    return launch_embed_rows<float, float>(
        width, rho0, rho1, rho_split, phi0, phi1, phi_split, a_valid,
        row_start, n_atoms, halo_src, dfe, u, A, n_local, n_slots, n_rows,
        table_n, x0, inv_dx, table, slot_blocks, row_blocks, stream);
  if (e_elem == 8)
    return launch_embed_rows<double, double>(
        width, rho0, rho1, rho_split, phi0, phi1, phi_split, a_valid,
        row_start, n_atoms, halo_src, dfe, u, A, n_local, n_slots, n_rows,
        table_n, x0, inv_dx, table, slot_blocks, row_blocks, stream);
  return launch_embed_rows<double, float>(
      width, rho0, rho1, rho_split, phi0, phi1, phi_split, a_valid,
      row_start, n_atoms, halo_src, dfe, u, A, n_local, n_slots, n_rows,
      table_n, x0, inv_dx, table, slot_blocks, row_blocks, stream);
}

template <typename T>
static void launch_land_rows(void* f, void* p, const RowSegs<T>& f1,
                             const RowSegs<T>& f3, int has_f3,
                             const void* row_start, const void* n_atoms,
                             int A, int n_local, int n_slots, int n_rows,
                             int kick, double c_kick, void* n_local_out,
                             int add, void* scratch, int grid,
                             cudaStream_t stream) {
  land_rows_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<T*>(f), static_cast<T*>(p), f1, f3, has_f3,
      static_cast<const int*>(row_start), static_cast<const int*>(n_atoms),
      A, n_local, n_slots, n_rows, kick, static_cast<T>(c_kick),
      static_cast<int*>(n_local_out), add, static_cast<Scratch*>(scratch));
}

// LR.  f (and, with kick, p) [3, n_slots]; f1 and f3 (null: one pass) as
// one or two row segments of [3, rows] planes (segment k's planes
// f*_plane{k} apart, the second segment at row f*_split); row_start
// [n_local] and n_atoms int32 indexed by cell; with kick also
// n_local_out (0-dim int32) and the scratch words.
extern "C" int comd_land_rows(int elem, void* f, void* p, const void* f1_0,
                              const void* f1_1, long long f1_plane0,
                              long long f1_plane1, int f1_split,
                              const void* f3_0, const void* f3_1,
                              long long f3_plane0, long long f3_plane1,
                              int f3_split, const void* row_start,
                              const void* n_atoms, int A, int n_local,
                              int n_slots, int n_rows, int kick,
                              double c_kick, void* n_local_out, int add,
                              void* scratch, int grid, cudaStream_t stream) {
  if (A < 1 || n_local < 0 || n_slots < n_local * A || grid < 1 ||
      (kick && (p == nullptr || n_local_out == nullptr ||
                scratch == nullptr)))
    return cudaErrorInvalidValue;
  const int has_f3 = f3_0 != nullptr;
  if (elem == 4)
    launch_land_rows<float>(
        f, p, row_segs<float>(f1_0, f1_1, f1_plane0, f1_plane1, f1_split),
        row_segs<float>(f3_0, f3_1, f3_plane0, f3_plane1, f3_split), has_f3,
        row_start, n_atoms, A, n_local, n_slots, n_rows, kick, c_kick,
        n_local_out, add, scratch, grid, stream);
  else
    launch_land_rows<double>(
        f, p, row_segs<double>(f1_0, f1_1, f1_plane0, f1_plane1, f1_split),
        row_segs<double>(f3_0, f3_1, f3_plane0, f3_plane1, f3_split),
        has_f3, row_start, n_atoms, A, n_local, n_slots, n_rows, kick,
        c_kick, n_local_out, add, scratch, grid, stream);
  return cudaGetLastError();
}

extern "C" const char* comd_step_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
