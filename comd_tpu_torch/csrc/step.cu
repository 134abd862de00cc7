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
//                       (comd_tpu/ops/neighborlist.py:161-168), written as
//                       the 0-dim bool the step graph's IF nodes read;
//                       without a baseline (-S 0) the kick and drift only;
//   refresh_halo        the ghost refresh r[:, halo] = r[:, halo_src] +
//                       shift (comd_tpu/sim.py:353-358);
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
//                       count (comd_tpu/sim.py:380-383), the count summed
//                       over a mesh's shards launch after launch.
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
// at 63^3: p, f, r, the local baseline in, p and r out, ~96 MB; land ~78
// MB), with a few operations a word; grid-stride loops over slots,
// neighbouring threads on neighbouring words.
//
// Plain C interface for ctypes: each entry point launches on `stream`,
// returns the cudaError_t of its launch (0 = success) and does not
// synchronize.  `elem` is the element size of the floating tensors (4 or
// 8), `e_elem` the energy dtype's.
#include <cuda_runtime.h>

#include "embed.cuh"

namespace {

constexpr int kThreads = 256;

// The scratch words the reductions fold into (a 32-byte device buffer,
// zero before the first launch, left zero by every launch).
struct Scratch {
  unsigned long long trigger_max;  // bit pattern of the largest |dr|^2
  unsigned int trigger_ticket;
  unsigned int land_sum;           // local atoms counted so far
  unsigned int land_ticket;
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
// block that draws the last one (every block's atomic is then visible).
__device__ __forceinline__ bool last_block(unsigned int* ticket) {
  __threadfence();
  return atomicAdd(ticket, 1u) == gridDim.x - 1;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    kick_drift_trigger_kernel(T* __restrict__ p, T* __restrict__ r,
                              const T* __restrict__ f,
                              const T* __restrict__ last, long long n,
                              long long n_check, T c_kick, T c_drift,
                              T thresh, Scratch* sc, bool* flag) {
  unsigned long long m = 0;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < n; i += stride) {
    T x[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const long long k = a * n + i;
      const T pk = p[k] + c_kick * f[k];
      p[k] = pk;
      x[a] = r[k] + pk * c_drift;
      r[k] = x[a];
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
    atomicMax(&sc->trigger_max, m);
    if (last_block(&sc->trigger_ticket)) {
      const unsigned long long v = atomicExch(&sc->trigger_max, 0ull);
      *flag = from_bits<T>(v) > thresh;
      sc->trigger_ticket = 0;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    refresh_halo_kernel(T* r, const long long* __restrict__ src,
                        const T* __restrict__ shift, long long n_halo, int A,
                        long long n_local, long long plane) {
  const long long total = n_halo * A;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long k = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       k < total; k += stride) {
    const long long h = k / A;
    const long long s = k - h * A;
    const long long from = src[h] * A + s;
    const long long to = (n_local + h) * A + s;
#pragma unroll
    for (int a = 0; a < 3; ++a)
      r[a * plane + to] = r[a * plane + from] + shift[3 * h + a];
  }
}

template <typename T, typename E>
__global__ void __launch_bounds__(kThreads)
    embed_fill_kernel(const T* __restrict__ rho, const T* __restrict__ phi,
                      const int* __restrict__ n_atoms,
                      const long long* __restrict__ halo_src,
                      T* __restrict__ dfe, E* __restrict__ u, int A,
                      long long n_local, long long n_rows, Embed<T> emb) {
  const long long total = n_rows * A;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long k = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       k < total; k += stride) {
    const long long row = k / A;
    const long long s = k - row * A;
    if (row < n_local) {
      if (u != nullptr) {
        T fv, dv;
        embed_value_and_derivative(rho[k], emb, &fv, &dv);
        dfe[k] = dv;
        u[k] = s < n_atoms[row]
                   ? E(0.5) * static_cast<E>(phi[k]) + static_cast<E>(fv)
                   : E(0);
      } else {
        dfe[k] = embed_derivative(rho[k], emb);
      }
    } else if (halo_src != nullptr) {
      dfe[k] = embed_derivative(rho[halo_src[row - n_local] * A + s], emb);
    } else {
      dfe[k] = T(0);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    land_kernel(T* __restrict__ f, T* __restrict__ p,
                const T* __restrict__ f1, long long f1_plane,
                const T* __restrict__ f3, long long f3_plane, long long n,
                long long n_force, T c_kick, const int* __restrict__ n_atoms,
                int n_local, int* n_local_out, int add, Scratch* sc) {
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
      const unsigned int total = atomicExch(&sc->land_sum, 0u);
      const unsigned int before =
          add ? static_cast<unsigned int>(*n_local_out) : 0u;
      *n_local_out = static_cast<int>(before + total);
      sc->land_ticket = 0;
    }
  }
}

}  // namespace

extern "C" int comd_kick_drift_trigger(int elem, void* p, void* r,
                                       const void* f, const void* last,
                                       long long n, long long n_check,
                                       double c_kick, double c_drift,
                                       double thresh, void* scratch,
                                       void* flag, int grid,
                                       cudaStream_t stream) {
  Scratch* sc = static_cast<Scratch*>(scratch);
  bool* out = static_cast<bool*>(flag);
  if (elem == 4)
    kick_drift_trigger_kernel<float><<<grid, kThreads, 0, stream>>>(
        static_cast<float*>(p), static_cast<float*>(r),
        static_cast<const float*>(f), static_cast<const float*>(last), n,
        n_check, static_cast<float>(c_kick), static_cast<float>(c_drift),
        static_cast<float>(thresh), sc, out);
  else
    kick_drift_trigger_kernel<double><<<grid, kThreads, 0, stream>>>(
        static_cast<double*>(p), static_cast<double*>(r),
        static_cast<const double*>(f), static_cast<const double*>(last), n,
        n_check, c_kick, c_drift, thresh, sc, out);
  return cudaGetLastError();
}

extern "C" int comd_refresh_halo(int elem, void* r, const void* src,
                                 const void* shift, long long n_halo, int A,
                                 long long n_local, long long plane, int grid,
                                 cudaStream_t stream) {
  const long long* s = static_cast<const long long*>(src);
  if (elem == 4)
    refresh_halo_kernel<float><<<grid, kThreads, 0, stream>>>(
        static_cast<float*>(r), s, static_cast<const float*>(shift), n_halo,
        A, n_local, plane);
  else
    refresh_halo_kernel<double><<<grid, kThreads, 0, stream>>>(
        static_cast<double*>(r), s, static_cast<const double*>(shift),
        n_halo, A, n_local, plane);
  return cudaGetLastError();
}

template <typename T, typename E>
static void launch_embed(const void* rho, const void* phi,
                         const void* n_atoms, const void* halo_src,
                         void* dfe, void* u, int A, long long n_local,
                         long long n_rows, int table_n, double x0,
                         double inv_dx, const void* table, int grid,
                         cudaStream_t stream) {
  const Embed<T> emb{table_n, static_cast<T>(x0), static_cast<T>(inv_dx),
                     static_cast<const T*>(table)};
  embed_fill_kernel<T, E><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(rho), static_cast<const T*>(phi),
      static_cast<const int*>(n_atoms),
      static_cast<const long long*>(halo_src), static_cast<T*>(dfe),
      static_cast<E*>(u), A, n_local, n_rows, emb);
}

extern "C" int comd_embed_fill(int elem, int e_elem, const void* rho,
                               const void* phi, const void* n_atoms,
                               const void* halo_src, void* dfe, void* u,
                               int A, long long n_local, long long n_rows,
                               int table_n, double x0, double inv_dx,
                               const void* table, int grid,
                               cudaStream_t stream) {
  if (elem == 4 && e_elem == 8)
    launch_embed<float, double>(rho, phi, n_atoms, halo_src, dfe, u, A,
                                n_local, n_rows, table_n, x0, inv_dx, table,
                                grid, stream);
  else if (elem == 4)
    launch_embed<float, float>(rho, phi, n_atoms, halo_src, dfe, u, A,
                               n_local, n_rows, table_n, x0, inv_dx, table,
                               grid, stream);
  else if (e_elem == 8)
    launch_embed<double, double>(rho, phi, n_atoms, halo_src, dfe, u, A,
                                 n_local, n_rows, table_n, x0, inv_dx, table,
                                 grid, stream);
  else
    launch_embed<double, float>(rho, phi, n_atoms, halo_src, dfe, u, A,
                                n_local, n_rows, table_n, x0, inv_dx, table,
                                grid, stream);
  return cudaGetLastError();
}

extern "C" int comd_land(int elem, void* f, void* p, const void* f1,
                         long long f1_plane, const void* f3,
                         long long f3_plane, long long n, long long n_force,
                         double c_kick, const void* n_atoms, int n_local,
                         void* n_local_out, int add, void* scratch, int grid,
                         cudaStream_t stream) {
  Scratch* sc = static_cast<Scratch*>(scratch);
  const int* na = static_cast<const int*>(n_atoms);
  int* out = static_cast<int*>(n_local_out);
  if (elem == 4)
    land_kernel<float><<<grid, kThreads, 0, stream>>>(
        static_cast<float*>(f), static_cast<float*>(p),
        static_cast<const float*>(f1), f1_plane,
        static_cast<const float*>(f3), f3_plane, n, n_force,
        static_cast<float>(c_kick), na, n_local, out, add, sc);
  else
    land_kernel<double><<<grid, kThreads, 0, stream>>>(
        static_cast<double*>(f), static_cast<double*>(p),
        static_cast<const double*>(f1), f1_plane,
        static_cast<const double*>(f3), f3_plane, n, n_force, c_kick, na,
        n_local, out, add, sc);
  return cudaGetLastError();
}

extern "C" const char* comd_step_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
