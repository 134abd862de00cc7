// Kernel-initiated halo transports for Hopper (sm_90a): the plane push (K3)
// and the fused embedding-derivative evaluation and push (K4).
//
// K3 `ring_push` replaces comd_tpu/parallel/pallas_comm.py::_ring_push_kernel
// (driven by _ring_push): a remote copy of a halo plane to the +-1 ring
// neighbor of one mesh axis.  Here it fuses what the Pallas path does in
// three steps (the x[send] gather, the push, and x.at[recv].set on the
// receiver, pallas_comm.py:117-124): for every shard s and every field f of
// the launch it copies rows send[k] of s's field into rows recv[k] (or row k
// when recv is null) of the buffer of the shard s pushes to.  A field is a
// stack of planes of rows of 32-bit words, so typed fields (f64 positions,
// int32 gids, int32 counts) move as they are and the Pallas path's int
// packing into float buffers (_pack_ints) is not needed.  Users: the dfEmbed
// exchange (one field, the receiver's own [B, A] field as destination, 6
// pushes per force) and the atom exchange (four fields r, p, gid, counts
// into per-shard arrival buffers, 6 pushes per rebucket).
//
// K4 `pass2_push` replaces pallas_comm.py::_pass2_push_kernel (driven by
// _pass2_push): for the x-face planes of every shard it evaluates
// F'(rhobar) -- the quadratic interpolation of the embedding table F,
// eam.c:557-579, as comd_tpu_torch/potentials/tables.interpolate computes
// it -- and writes the value straight into the x neighbor's dfEmbed halo
// rows, plus a local copy of the plane.  The Pallas kernel's 0/1
// selection-matmul table read was a Mosaic workaround; this is a direct
// table read.
//
// Ordering.  The Pallas kernels signal both ring neighbors on a barrier
// semaphore and wait (the destination must exist before the remote copy
// lands), then wait on DMA semaphores (pallas_comm.py:56-76).  Here every
// shard of the mesh lives on one device and every launch goes on PyTorch's
// current stream, after the kernels that wrote the source planes and before
// those that read the destination, so stream order is the handshake and no
// flag or semaphore is needed.  Inside one launch the shards push along one
// ring direction, so every destination buffer is written by one shard only,
// and the rows a launch reads (send rows) are never rows it writes (recv
// rows: the halo plane on the other side of the axis), which also holds
// when a shard pushes to itself (an axis of size 1).  Shards on several
// cards need the cross-device ready flag of comm_ki.cuh instead.
//
// Bound: bytes.  Both kernels move each word once (K4 also reads its
// table, ~4 KB, from cache) with a few integer operations per word.  K3
// runs one thread per vector of 1, 2 or 4 words (the widest the fields'
// rows and pointers allow), grid-strided over rows; K4 one thread per
// (row, slot).  No reduction, no shared memory.
//
// Built with -fmad=false: K4 must round F' operation by operation, as
// PyTorch's eager kernels do for the interior values of pass 2, so the
// planes it pushes equal the interior values bit for bit.
//
// Plain C interface for ctypes: each entry point returns the cudaError_t of
// its launch (0 = success) and does not synchronize.

#include <cuda_runtime.h>

#include <cstdint>

constexpr int kMaxFields = 4;     // fields per K3 launch
constexpr int kMaxEntries = 192;  // (field, shard) pairs per K3 launch
constexpr int kMaxShards = 128;   // shards per K4 launch

// K3: one field's shape, the same for every shard of the launch.
struct PushField {
  int n_planes;                // planes stacked in the field
  int row_words;               // 32-bit words per row
  long long src_plane_words;   // words from one source plane to the next
  long long dst_plane_words;   // words from one destination plane to the next
};

struct PushArgs {
  int n_fields, n_shards;
  PushField field[kMaxFields];
  const void* src[kMaxEntries];   // [field * n_shards + s]: shard s's field
  void* dst[kMaxEntries];         // the buffer shard s pushes into
};

// K4: the F table, as the host holds it (InterpTable.device_table: [n+4]
// values of the kernel's precision).
struct EmbedParams {
  int n;
  double x0, inv_dx;
  const void* table;
};

struct Pass2Args {
  int n_shards;
  const void* rho[kMaxShards];   // shard s's rhobar [n_local, A]
  void* dst[kMaxShards];         // the dfEmbed [B, A] shard s pushes into
  void* local[kMaxShards];       // shard s's local copy [n_rows, A]
};

namespace {

template <typename V>
__global__ void ring_push_kernel(const PushArgs a, const int* send,
                                 const int* recv, int n_rows) {
  constexpr int W = sizeof(V) / 4;   // words per vector
  const int e = blockIdx.y;
  const PushField f = a.field[e / a.n_shards];
  const long long rv = f.row_words / W;          // vectors per row
  const long long per_plane = rv * n_rows;
  const long long total = per_plane * f.n_planes;
  const long long src_plane = f.src_plane_words / W;
  const long long dst_plane = f.dst_plane_words / W;
  const V* src = static_cast<const V*>(a.src[e]);
  V* dst = static_cast<V*>(a.dst[e]);
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long q = i / per_plane;
    const long long rem = i - q * per_plane;
    const long long k = rem / rv;
    const long long w = rem - k * rv;
    const long long to_row = recv != nullptr ? recv[k] : k;
    dst[q * dst_plane + to_row * rv + w] = src[q * src_plane + send[k] * rv + w];
  }
}

template <typename V>
cudaError_t launch_push(const PushArgs& a, const int* send, const int* recv,
                        int n_rows, cudaStream_t stream) {
  constexpr int W = sizeof(V) / 4;
  long long most = 0;
  for (int f = 0; f < a.n_fields; ++f) {
    const long long t = static_cast<long long>(a.field[f].n_planes) * n_rows *
                        (a.field[f].row_words / W);
    if (t > most) most = t;
  }
  constexpr int kThreads = 256;
  long long blocks = (most + kThreads - 1) / kThreads;
  if (blocks > 8192) blocks = 8192;
  if (blocks == 0) return cudaSuccess;
  const dim3 grid(static_cast<unsigned>(blocks),
                  static_cast<unsigned>(a.n_fields * a.n_shards));
  ring_push_kernel<V><<<grid, kThreads, 0, stream>>>(a, send, recv, n_rows);
  return cudaGetLastError();
}

template <typename T>
struct Embed {
  int n;
  T x0, inv_dx;
  const T* table;
};

// tables.interpolate's derivative output, operation by operation.
template <typename T>
__device__ __forceinline__ T embed_derivative(T rho, const Embed<T>& p) {
  const T r = rho < p.x0 ? p.x0 : rho;
  const T rr = (r - p.x0) * p.inv_dx;
  const T fl = floor(rr);
  long long ii = static_cast<long long>(fl);
  const bool over = ii > p.n;
  if (over) ii = p.n;
  const T frac = over ? T(0) : rr - fl;
  const T tm1 = p.table[ii];
  const T t0 = p.table[ii + 1];
  const T t1 = p.table[ii + 2];
  const T t2 = p.table[ii + 3];
  const T g1 = t1 - tm1;
  const T g2 = t2 - t0;
  return T(0.5) * (g1 + frac * (g2 - g1)) * p.inv_dx;
}

template <typename T>
__global__ void pass2_push_kernel(const Pass2Args a, const Embed<T> p,
                                  const int* send, const int* recv,
                                  int n_rows, int A) {
  const int s = blockIdx.y;
  const T* rho = static_cast<const T*>(a.rho[s]);
  T* dst = static_cast<T*>(a.dst[s]);
  T* local = static_cast<T*>(a.local[s]);
  const long long total = static_cast<long long>(n_rows) * A;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long k = i / A;
    const long long slot = i - k * A;
    const T df = embed_derivative(rho[send[k] * static_cast<long long>(A) +
                                      slot], p);
    local[i] = df;
    dst[recv[k] * static_cast<long long>(A) + slot] = df;
  }
}

template <typename T>
cudaError_t launch_pass2(const Pass2Args& a, const EmbedParams& e,
                         const int* send, const int* recv, int n_rows, int A,
                         cudaStream_t stream) {
  const Embed<T> p{e.n, static_cast<T>(e.x0), static_cast<T>(e.inv_dx),
                   static_cast<const T*>(e.table)};
  constexpr int kThreads = 256;
  long long blocks = (static_cast<long long>(n_rows) * A + kThreads - 1) /
                     kThreads;
  if (blocks > 8192) blocks = 8192;
  if (blocks == 0) return cudaSuccess;
  const dim3 grid(static_cast<unsigned>(blocks),
                  static_cast<unsigned>(a.n_shards));
  pass2_push_kernel<T><<<grid, kThreads, 0, stream>>>(a, p, send, recv,
                                                      n_rows, A);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K3.  vec_words: 1, 2 or 4 words per thread (every field's row_words and
// plane strides, and every pointer, must allow it).  recv may be null
// (row k of the destination).  Returns the launch's cudaError_t.
int comd_ring_push(const PushArgs* args, const void* send, const void* recv,
                   int n_rows, int vec_words, void* stream) {
  if (args == nullptr || send == nullptr || n_rows < 0 ||
      args->n_fields < 1 || args->n_fields > kMaxFields ||
      args->n_shards < 1 ||
      args->n_fields * args->n_shards > kMaxEntries)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int f = 0; f < args->n_fields; ++f) {
    const PushField& fd = args->field[f];
    if (fd.n_planes < 1 || fd.row_words < 1 || fd.row_words % vec_words ||
        fd.src_plane_words % vec_words || fd.dst_plane_words % vec_words)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const int* s = static_cast<const int*>(send);
  const int* r = static_cast<const int*>(recv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec_words == 4) return launch_push<uint4>(*args, s, r, n_rows, st);
  if (vec_words == 2) return launch_push<uint2>(*args, s, r, n_rows, st);
  if (vec_words == 1)
    return launch_push<unsigned int>(*args, s, r, n_rows, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K4.  dtype: 0 float, 1 double.  Returns the launch's cudaError_t.
int comd_pass2_push(const Pass2Args* args, const EmbedParams* embed,
                    int dtype, const void* send, const void* recv, int n_rows,
                    int A, void* stream) {
  if (args == nullptr || embed == nullptr || embed->table == nullptr ||
      send == nullptr || recv == nullptr || n_rows < 0 || A < 1 ||
      args->n_shards < 1 || args->n_shards > kMaxShards || embed->n < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int* s = static_cast<const int*>(send);
  const int* r = static_cast<const int*>(recv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_pass2<float>(*args, *embed, s, r, n_rows, A, st);
  if (dtype == 1)
    return launch_pass2<double>(*args, *embed, s, r, n_rows, A, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* comd_comm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
