// The round-3 archive probes for Hopper (sm_90a): the pair-window sum (P1-P3)
// and the two table lookups (P4-P6).
//
// window_pair_kernel replaces tools/archive/pallas_probe.py::kernel (P1),
// pallas_probe2.py::kernel (P2) and pallas_probe3.py::kernel_A / kernel_BC
// (P3; its variants A, B and C are three Mosaic loop structures of one
// function).  Positions rp [3, A, L] hold A slots of every lane column.  For
// output column c (0 <= c < D) and i-slot a it sums, over the probe's static
// lane offsets d and all A j-slots b, a pair function of
//   (dx, dy, dz) = rp[:, a, pad + c] - rp[:, b, pad + c + d]
// masked to 0 < r2 <= rcut2: P1 fx += dx / r2 and u += r2; P2/P3 three
// Clenshaw chains of t2 = clip(r2, lo, hi) * scale - shift (fx += -2 dphi dx,
// u += phi, rho += rho); LJ fx += r6 inv (12 r6 - 6) dx, u and rho += r6 (r6
// - 1).  The TPU kernels DMA a [3, A, W] window per chunk of 256 columns into
// VMEM (344 KB at P1's W, 540 KB at P2's), over a block's 227 KB of shared
// memory.  Here every thread owns one (a, c) and reads its j-values through
// the read-only cache: a warp holds 32 neighbouring columns of one slot, so
// each j-read is 128 contiguous bytes, and the A slot-threads of a column
// read the same bytes.  No staging, no chunks.  The offsets and coefficients
// ride in the kernel's parameter block (the constant bank; every thread of a
// warp reads the same word).
//
// The pair function runs on every candidate pair, branch-free (the mask
// selects), as on the TPU: ~156-159 flops a pair for P2/P3 (three degree-15/16
// chains), 21 for LJ, 12 for P1, against three 4-byte cache reads.  At the
// probes' random positions only ~1% of the pairs lie inside the cutoff, and
// the function needs r2 (8 flops) on every pair and the rest on those only,
// so the kernel does ~16 times the arithmetic its result needs (P2/P3).
// r2 is rounded product by product (as csrc/stencil.cu does), so the
// cutoff mask keeps the pairs the plain version keeps; FMA contraction stays
// on elsewhere, the Clenshaw chains' FMAs being what the probe calibrates.
// Per offset the j-sum is taken first and then added to the output, the
// TPU kernels' order.
//
// row_lookup_kernel replaces gather_probe.py::pallas_kernel (P4, driven by
// pallas_take): out = x + scale * (r0 + u * (r1 + u * (r2 + r3))) with
// r = tab[floor(x)] ([rows, 4]) and u = x - floor(x).  lane_lookup_kernel
// replaces gather_probe2.py::k_gather (P5, driven by pgather) and stands for
// k_onehot (P6, driven by ponehot), which means the same function through a
// one-hot select-sum, a TPU MXU workaround: out[r, l] = x + scale *
// (tab[floor(x[r, l]), l] * u).
//
// Bound: bytes (x read and out written once; the table is small).  P4 stages
// its table (8 KB at 512 rows) in shared memory and reads x as float4 (x and
// out 16-byte aligned).  P5's table is 256 KB at [512, 128], over the limit,
// so each block stages one 32-lane column slice of it (64 KB; lanes a whole
// number of slices) and walks rows of x: the 32 lanes of a warp then read 32
// distinct banks, whichever rows they index.  Both round op
// by op (__fmul_rn, __fadd_rn), so they equal PyTorch's eager plain versions
// bit for bit, and clamp floor(x) to the table's rows as XLA's gather clamps
// its indices.
//
// Plain C interface for ctypes: each entry point returns the cudaError_t of
// its launch (0 = success) and does not synchronize.

#include <cuda_runtime.h>

constexpr int kMaxOffsets = 32;   // lane offsets per window probe
constexpr int kMaxCoef = 17;      // coefficients per Clenshaw chain
constexpr int kLaneSlice = 32;    // table columns staged per lane_lookup block

enum WindowPhysics { kInvR2 = 0, kCheb = 1, kLJ = 2 };

struct WindowParams {
  int n_slots;     // A
  int row_len;     // L: lane columns of one slot row of rp
  int n_cols;      // D: output columns
  int pad;         // lane of output column 0
  int n_offsets;
  int offsets[kMaxOffsets];
  float rcut2;                  // pairs with 0 < r2 <= rcut2 count
  float clip_lo, clip_hi;       // t2 = clip(r2, lo, hi) * t_scale - t_shift
  float t_scale, t_shift;
  float phi[kMaxCoef], dphi[kMaxCoef], rho[kMaxCoef];
};

namespace {

__device__ __forceinline__ float dist2(float dx, float dy, float dz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// The probes' clenshaw(): b0, b1 = t2 * b0 - b1 + c[k], b0 for k = N-1 .. 1
// from b0 = b1 = 0, then 0.5 * t2 * b0 - b1 + c[0].  The first step gives
// b0 = c[N-1] exactly, so it starts there.
template <int N>
__device__ __forceinline__ float clenshaw(const float* c, float t2) {
  float b0 = c[N - 1], b1 = 0.f;
#pragma unroll
  for (int k = N - 2; k >= 1; --k) {
    const float nb = t2 * b0 - b1 + c[k];
    b1 = b0;
    b0 = nb;
  }
  return 0.5f * t2 * b0 - b1 + c[0];
}

template <int kPhys, int kNPhi, int kNDphi, int kNRho>
__global__ void __launch_bounds__(256)
    window_pair_kernel(const __grid_constant__ WindowParams p,
                       const float* __restrict__ rp, float* __restrict__ fx,
                       float* __restrict__ u, float* __restrict__ rho) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int a = blockIdx.y * blockDim.y + threadIdx.y;
  if (c >= p.n_cols || a >= p.n_slots) return;
  const long long plane = static_cast<long long>(p.n_slots) * p.row_len;
  const float* xs = rp;
  const float* ys = rp + plane;
  const float* zs = rp + 2 * plane;
  const long long ia = static_cast<long long>(a) * p.row_len + p.pad + c;
  const float xi = xs[ia], yi = ys[ia], zi = zs[ia];
  float acc_f = 0.f, acc_u = 0.f, acc_r = 0.f;
  for (int k = 0; k < p.n_offsets; ++k) {
    const long long col = p.pad + c + p.offsets[k];
    float s_f = 0.f, s_u = 0.f, s_r = 0.f;
#pragma unroll 4
    for (int b = 0; b < p.n_slots; ++b) {
      const long long jb = static_cast<long long>(b) * p.row_len + col;
      const float dx = xi - __ldg(xs + jb);
      const float dy = yi - __ldg(ys + jb);
      const float dz = zi - __ldg(zs + jb);
      const float r2 = dist2(dx, dy, dz);
      const bool in = r2 <= p.rcut2 && r2 > 0.f;
      if constexpr (kPhys == kInvR2) {
        const float inv = in ? __frcp_rn(r2) : 0.f;
        s_f += inv * dx;
        s_u += in ? r2 : 0.f;
      } else if constexpr (kPhys == kLJ) {
        const float inv = in ? __frcp_rn(r2) : 0.f;
        const float r6 = inv * inv * inv;
        const float fc = in ? r6 * inv * (12.f * r6 - 6.f) : 0.f;
        const float e = in ? r6 * (r6 - 1.f) : 0.f;
        s_f += fc * dx;
        s_u += e;
        s_r += e;
      } else {
        const float t2 =
            fminf(fmaxf(r2, p.clip_lo), p.clip_hi) * p.t_scale - p.t_shift;
        const float phi = clenshaw<kNPhi>(p.phi, t2);
        const float dphi = clenshaw<kNDphi>(p.dphi, t2);
        const float rv = clenshaw<kNRho>(p.rho, t2);
        const float fc = in ? -2.f * dphi : 0.f;
        s_f += fc * dx;
        s_u += in ? phi : 0.f;
        s_r += in ? rv : 0.f;
      }
    }
    acc_f += s_f;
    acc_u += s_u;
    acc_r += s_r;
  }
  const long long o = static_cast<long long>(a) * p.n_cols + c;
  fx[o] = acc_f;
  u[o] = acc_u;
  if constexpr (kPhys != kInvR2) rho[o] = acc_r;
}

template <int kPhys, int kNPhi, int kNDphi, int kNRho>
cudaError_t launch_window(const WindowParams& p, const float* rp, float* fx,
                          float* u, float* rho, cudaStream_t stream) {
  const dim3 block(64, 4);
  const dim3 grid((p.n_cols + block.x - 1) / block.x,
                  (p.n_slots + block.y - 1) / block.y);
  window_pair_kernel<kPhys, kNPhi, kNDphi, kNRho>
      <<<grid, block, 0, stream>>>(p, rp, fx, u, rho);
  return cudaGetLastError();
}

// floor(x) as a table row, clamped to [0, n_rows - 1] before the conversion.
__device__ __forceinline__ int table_row(float fl, int n_rows) {
  return static_cast<int>(
      fminf(fmaxf(fl, 0.f), static_cast<float>(n_rows - 1)));
}

__device__ __forceinline__ float row_value(float x, const float4* tab,
                                           int n_rows, float scale) {
  const float fl = floorf(x);
  const float u = __fsub_rn(x, fl);
  const float4 r = tab[table_row(fl, n_rows)];
  float s = __fadd_rn(r.z, r.w);
  s = __fadd_rn(r.y, __fmul_rn(u, s));
  s = __fadd_rn(r.x, __fmul_rn(u, s));
  return __fadd_rn(x, __fmul_rn(scale, s));
}

// Grid-stride over x (16-byte aligned, as out): four values per thread and
// step, then the tail one by one.
__global__ void __launch_bounds__(256)
    row_lookup_kernel(const float* __restrict__ x,
                      const float4* __restrict__ tab, float* __restrict__ out,
                      long long n, int n_rows, float scale) {
  extern __shared__ float4 stab[];
  for (int i = threadIdx.x; i < n_rows; i += blockDim.x) stab[i] = tab[i];
  __syncthreads();
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long t = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  const long long n4 = n / 4;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  float4* o4 = reinterpret_cast<float4*>(out);
  for (long long i = t; i < n4; i += stride) {
    const float4 v = x4[i];
    o4[i] = make_float4(row_value(v.x, stab, n_rows, scale),
                        row_value(v.y, stab, n_rows, scale),
                        row_value(v.z, stab, n_rows, scale),
                        row_value(v.w, stab, n_rows, scale));
  }
  for (long long i = 4 * n4 + t; i < n; i += stride)
    out[i] = row_value(x[i], stab, n_rows, scale);
}

// Block (32 lanes, 16 rows of x); blockIdx.y picks the 32-lane column slice
// of the table that the block stages.
__global__ void __launch_bounds__(512)
    lane_lookup_kernel(const float* __restrict__ x,
                       const float* __restrict__ tab, float* __restrict__ out,
                       long long n_x_rows, int lanes, int n_rows,
                       float scale) {
  extern __shared__ float slice[];   // [n_rows][kLaneSlice]
  const int l0 = blockIdx.y * kLaneSlice;
  const int n_threads = blockDim.x * blockDim.y;
  for (int i = threadIdx.y * blockDim.x + threadIdx.x; i < n_rows * kLaneSlice;
       i += n_threads)
    slice[i] = tab[static_cast<long long>(i / kLaneSlice) * lanes + l0 +
                   i % kLaneSlice];
  __syncthreads();
  const int l = l0 + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.y;
  for (long long r = blockIdx.x * static_cast<long long>(blockDim.y) +
                     threadIdx.y;
       r < n_x_rows; r += stride) {
    const long long i = r * lanes + l;
    const float v = x[i];
    const float fl = floorf(v);
    const float t = slice[table_row(fl, n_rows) * kLaneSlice + threadIdx.x];
    out[i] = __fadd_rn(v, __fmul_rn(scale, __fmul_rn(t, __fsub_rn(v, fl))));
  }
}

// Blocks for a grid-strided launch: as many as fit on the card at once.
template <typename K>
int resident_blocks(K kernel, int threads, size_t smem) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                    smem) != cudaSuccess)
    return 0;
  return sms * per_sm;
}

}  // namespace

extern "C" {

// physics: 0 P1 (1/r2), 1 Clenshaw (n_phi, n_dphi, n_rho of 17/16/17 for
// P2 or 17/16/16 for P3), 2 LJ.  fx and u are [A, D]; rho [A, D] too, except
// for P1 (may be null).
int comd_window_pair(const WindowParams* p, int physics, int n_phi,
                     int n_dphi, int n_rho, const void* rp, void* fx, void* u,
                     void* rho, void* stream) {
  if (p == nullptr || rp == nullptr || fx == nullptr || u == nullptr ||
      (physics != kInvR2 && rho == nullptr) || p->n_slots < 1 ||
      p->n_cols < 1 || p->n_offsets < 1 || p->n_offsets > kMaxOffsets ||
      p->pad < 0 || static_cast<long long>(p->pad) + p->n_cols > p->row_len)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int k = 0; k < p->n_offsets; ++k) {
    const long long lo = static_cast<long long>(p->pad) + p->offsets[k];
    if (lo < 0 || lo + p->n_cols > p->row_len)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* r = static_cast<const float*>(rp);
  float* f = static_cast<float*>(fx);
  float* e = static_cast<float*>(u);
  float* q = static_cast<float*>(rho);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (physics == kInvR2)
    return launch_window<kInvR2, 0, 0, 0>(*p, r, f, e, q, st);
  if (physics == kLJ) return launch_window<kLJ, 0, 0, 0>(*p, r, f, e, q, st);
  if (physics == kCheb && n_phi == 17 && n_dphi == 16 && n_rho == 17)
    return launch_window<kCheb, 17, 16, 17>(*p, r, f, e, q, st);
  if (physics == kCheb && n_phi == 17 && n_dphi == 16 && n_rho == 16)
    return launch_window<kCheb, 17, 16, 16>(*p, r, f, e, q, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// tab: [n_rows, 4] f32; x and out: n values; all 16-byte aligned.
int comd_row_lookup(const void* x, const void* tab, void* out, long long n,
                    int n_rows, float scale, void* stream) {
  if (x == nullptr || tab == nullptr || out == nullptr || n < 0 ||
      n_rows < 1 || n_rows > 4096)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return cudaSuccess;
  const size_t smem = static_cast<size_t>(n_rows) * sizeof(float4);
  constexpr int kThreads = 256;
  cudaError_t err = cudaFuncSetAttribute(
      row_lookup_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  long long blocks = (n + 4 * kThreads - 1) / (4 * kThreads);
  const int most = resident_blocks(row_lookup_kernel, kThreads, smem);
  if (most < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  if (blocks > most) blocks = most;
  row_lookup_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float4*>(tab),
      static_cast<float*>(out), n, n_rows, scale);
  return static_cast<int>(cudaGetLastError());
}

// x and out: [n_x_rows, lanes]; tab: [n_rows, lanes], all f32; lanes a
// multiple of 32.
int comd_lane_lookup(const void* x, const void* tab, void* out,
                     long long n_x_rows, int lanes, int n_rows, float scale,
                     void* stream) {
  if (x == nullptr || tab == nullptr || out == nullptr || n_x_rows < 0 ||
      lanes < 1 || lanes % kLaneSlice != 0 || n_rows < 1 || n_rows > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_x_rows == 0) return cudaSuccess;
  const size_t smem = static_cast<size_t>(n_rows) * kLaneSlice * sizeof(float);
  const dim3 block(kLaneSlice, 16);
  cudaError_t err = cudaFuncSetAttribute(
      lane_lookup_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int slices = lanes / kLaneSlice;
  const int most = resident_blocks(lane_lookup_kernel, block.x * block.y, smem);
  if (most < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  long long per_slice = (n_x_rows + block.y - 1) / block.y;
  const long long room = (most + slices - 1) / slices;
  if (per_slice > room) per_slice = room;
  const dim3 grid(static_cast<unsigned>(per_slice), slices);
  lane_lookup_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(tab),
      static_cast<float*>(out), n_x_rows, lanes, n_rows, scale);
  return static_cast<int>(cudaGetLastError());
}

const char* comd_probe_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
