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
// VMEM and evaluate the pair function on every candidate pair, branch-free.
//
// What bounds it: the flops the sums need are r2 on every candidate pair (8)
// and the pair function on the ~0.7-1% of pairs inside the cutoff at the
// probes' uniform positions (P2/P3: ~156 flops a pair).  The first port ran
// the TPU's design, one thread an output evaluating every candidate
// branch-free in blocks of 64x4, at 2-4% of that bound: ~16 times the
// arithmetic the result needs, too few threads to fill the card at 4 and 8
// chunks, and three j reads a pair from L2 (only 4 i-slots of a column
// shared a block).
//
// Design (one warp per column and offset group; lane a is i-slot a, A <= 32):
//  - A warp stages one offset's 32 j positions in its own shared memory as
//    x, y and z planes (lane b loads slot b; the next offset's loads are
//    issued before the current one is walked), so the j side of four
//    candidates is three broadcast 16-byte loads for all 32 lanes.
//  - The walk tests r2, rounded product by product exactly as the plain
//    version rounds it, so the mask keeps the same pairs, and appends (r2,
//    dx) of each pair inside the cutoff to the lane's own list in shared
//    memory (entry e of lane l at e * 33 + l: a skew, so that neither the
//    appends nor the drain's reads of one owner's entries share a bank),
//    through a 32-bit shared address: two predicated instructions a
//    candidate (a pointer cost four or five).
//  - When any lane's list could overflow in the next batch of 8
//    candidates (__any_sync), and after the walk, the warp drains by entry:
//    a warp prefix sum of the list lengths numbers the warp's entries, lane
//    q evaluates entries q, q + 32, ... (its owner found by a binary search
//    of the prefix sums with shuffles) and writes the terms over the entry;
//    after __syncwarp each owner sums its own entries in list order.  A
//    long list does not hold the other 31 lanes, and the sums take one
//    fixed order: every launch gives the same bits.  The pair function is
//    inlined once (one drain site); FMA contraction stays on in the
//    Clenshaw chains, which is what the probe calibrates.
//  - Occupancy: the offsets of a column are split into n_groups groups, one
//    warp each, when the columns alone do not fill the card (the plan,
//    ops/cuda/probe.py::window_plan, picks the fewest groups that give ~one
//    wave of resident warps); the group warps of a column sit in one block
//    and their partial sums are added in group order through shared
//    memory, so a call stays one launch.  Blocks hold cols_per_block
//    columns (8 warps at most; 4 blocks an SM, 56 registers).
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (probe_timing.py, device
// time): P3 at 72 chunks 0.458 ms (the first port 2.595), 0.90 ps a
// candidate pair, of which the r2 walk is 0.371, the appends 0.058, the
// drain 0.019 and the pair function 0.010; P2/P3 at 8 chunks 0.060 (0.32-
// 0.36).  The walk is 14 instructions a candidate (8 for r2, 2 compares,
// 2 predicated appends, the loads and the batch's test) and issues at
// ~half the SM's rate.
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
// its indices.  Both are grid-strided over as many blocks as the card holds.
//
// Launch plans are made once per device and shape (ops/cuda/probe.py):
// comd_probe_occupancy sets a kernel's dynamic shared-memory limit and
// reports the blocks an SM holds; the launch entry points only check their
// arguments and launch.  Plain C interface for ctypes: each entry point
// returns the cudaError_t of its launch (0 = success) and does not
// synchronize.

#include <cuda_runtime.h>

constexpr int kMaxOffsets = 32;   // lane offsets per window probe
constexpr int kMaxCoef = 17;      // coefficients per Clenshaw chain
constexpr int kLaneSlice = 32;    // table columns staged per lane_lookup block
constexpr int kWarp = 32;
constexpr int kListCap = 16;      // entries a lane's window list holds
constexpr int kBatch = 8;         // candidates tested between capacity checks
constexpr int kListStride = kWarp + 1;  // entry e of lane l at e * 33 + l
constexpr int kMaxWarps = 8;      // warps a window_pair block at most
constexpr int kRowThreads = 256;  // row_lookup block
constexpr int kRowMaxRows = 4096;
constexpr int kLaneRows = 16;     // rows of x a lane_lookup block walks at once
constexpr int kLaneMaxRows = 1024;

enum WindowPhysics { kInvR2 = 0, kCheb = 1, kLJ = 2 };
enum ProbeKernel { kWindowPair = 0, kRowLookup = 1, kLaneLookup = 2 };

struct WindowParams {
  int n_slots;     // A (at most 32: one lane an i-slot)
  int row_len;     // L: lane columns of one slot row of rp
  int n_cols;      // D: output columns
  int pad;         // lane of output column 0
  int n_offsets;
  int group;           // offsets a warp walks (the last group may be shorter)
  int n_groups;        // warps that split one column's offsets
  int cols_per_block;  // columns a block; warps = cols_per_block * n_groups
  int offsets[kMaxOffsets];
  float rcut2;                  // pairs with 0 < r2 <= rcut2 count
  float clip_lo, clip_hi;       // t2 = clip(r2, lo, hi) * t_scale - t_shift
  float t_scale, t_shift;
  float phi[kMaxCoef], dphi[kMaxCoef], rho[kMaxCoef];
};

namespace {

// terms a pair contributes: the force and one (P1, LJ) or two scalars
__host__ __device__ constexpr int window_terms(int physics) {
  return physics == kCheb ? 3 : 2;
}

// shared bytes of one window warp: its 32 staged records and its lanes'
// lists, (r2, dx) an entry and, with three terms, a third plane
__host__ __device__ constexpr size_t window_warp_smem(int physics) {
  return kWarp * sizeof(float4) +
         static_cast<size_t>(kListCap) * kListStride *
             (sizeof(float2) + (window_terms(physics) == 3 ? sizeof(float)
                                                           : 0));
}

// Two floats to a shared address: the list appends keep a 32-bit shared
// address, where a pointer costs the walk 64-bit arithmetic.
__device__ __forceinline__ void st_shared2(unsigned addr, float a, float b) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};" ::"r"(addr), "f"(a),
               "f"(b)
               : "memory");
}

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

// The terms of one pair inside the cutoff: t[0] the force term, then the
// scalars (P1 r2; LJ its energy, which u and rho both sum; Clenshaw phi and
// rho), in the first port's operations.
template <int kPhys, int kNPhi, int kNDphi, int kNRho>
__device__ __forceinline__ void pair_terms(const WindowParams& p, float r2,
                                           float dx, float* t) {
  if constexpr (kPhys == kInvR2) {
    t[0] = __frcp_rn(r2) * dx;
    t[1] = r2;
  } else if constexpr (kPhys == kLJ) {
    const float inv = __frcp_rn(r2);
    const float r6 = inv * inv * inv;
    const float fc = r6 * inv * (12.f * r6 - 6.f);
    t[0] = fc * dx;
    t[1] = r6 * (r6 - 1.f);
  } else {
    const float t2 =
        fminf(fmaxf(r2, p.clip_lo), p.clip_hi) * p.t_scale - p.t_shift;
    const float fc = -2.f * clenshaw<kNDphi>(p.dphi, t2);
    t[0] = fc * dx;
    t[1] = clenshaw<kNPhi>(p.phi, t2);
    t[2] = clenshaw<kNRho>(p.rho, t2);
  }
}

// Warp w of block x walks column x * cols_per_block + w / n_groups over the
// offsets of group w % n_groups (ops/cuda/probe.py::WindowPlan.warp_work
// mirrors this).  Shared memory: [warps][3][32] records (x, y, z planes,
// the region of 32 float4 a warp), [warps][cap * 33] (r2, dx) entries, and
// for three terms [warps][cap * 33] third terms.
template <int kPhys, int kNPhi, int kNDphi, int kNRho>
__global__ void __launch_bounds__(kMaxWarps * kWarp, 4)
    window_pair_kernel(const __grid_constant__ WindowParams p,
                       const float* __restrict__ rp, float* __restrict__ fx,
                       float* __restrict__ u, float* __restrict__ rho) {
  constexpr int NT = window_terms(kPhys);
  constexpr unsigned kAll = 0xffffffffu;
  constexpr int kList = kListCap * kListStride;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x % kWarp;
  const int w = threadIdx.x / kWarp;
  const int n_warps = blockDim.x / kWarp;
  float* rec = reinterpret_cast<float*>(smem_raw) + w * 4 * kWarp;
  unsigned char* lists = smem_raw + n_warps * kWarp * sizeof(float4);
  float2* ent = reinterpret_cast<float2*>(lists) + w * kList;
  float* ent2 = reinterpret_cast<float*>(lists + n_warps * kList *
                                                     sizeof(float2)) +
                w * kList;

  const int cb = w / p.n_groups;
  const int g = w - cb * p.n_groups;
  const int c = blockIdx.x * p.cols_per_block + cb;
  const int k0 = g * p.group;
  const int k1 = min(k0 + p.group, p.n_offsets);
  const bool mine = c < p.n_cols && k0 < k1;   // warp-uniform
  const bool slot = lane < p.n_slots;
  const long long plane = static_cast<long long>(p.n_slots) * p.row_len;
  const float* xs = rp;
  const float* ys = rp + plane;
  const float* zs = rp + 2 * plane;
  // this lane's slot row at column c; lanes past A walk with a NaN position
  // and stage NaN records, which no cutoff test keeps
  const long long row = static_cast<long long>(lane) * p.row_len + p.pad + c;
  const float nan = __int_as_float(0x7fffffff);
  float xi = nan, yi = nan, zi = nan;
  if (mine && slot) {
    xi = xs[row];
    yi = ys[row];
    zi = zs[row];
  }
  float acc[NT];
#pragma unroll
  for (int q = 0; q < NT; ++q) acc[q] = 0.f;

  if (mine) {
    // ``tail``: the shared address of the next free entry of this lane's
    // list (entry e at head + 8 e * kListStride); the warp drains once a
    // list could overflow within the next batch, and after the last batch
    // of its walk
    const unsigned ent0 = static_cast<unsigned>(__cvta_generic_to_shared(ent));
    const unsigned head = ent0 + 8 * lane;
    const unsigned full = head + 8 * (kListCap - kBatch) * kListStride;
    unsigned tail = head;
    float4 nxt = make_float4(nan, nan, nan, 0.f);
    if (slot) {
      const long long j = row + p.offsets[k0];
      nxt = make_float4(xs[j], ys[j], zs[j], 0.f);
    }
    const float4* const rec4 = reinterpret_cast<const float4*>(rec);
    for (int k = k0; k < k1; ++k) {
      __syncwarp();
      rec[lane] = nxt.x;
      rec[kWarp + lane] = nxt.y;
      rec[2 * kWarp + lane] = nxt.z;
      __syncwarp();
      if (k + 1 < k1 && slot) {   // the next offset's records, in flight
        const long long j = row + p.offsets[k + 1];
        nxt = make_float4(xs[j], ys[j], zs[j], 0.f);
      }
      const bool last_k = k == k1 - 1;
#pragma unroll 1
      for (int b0 = 0; b0 < kWarp; b0 += kBatch) {
        // the batch's x, y and z, four candidates a broadcast load
        float vx[kBatch], vy[kBatch], vz[kBatch];
#pragma unroll
        for (int q = 0; q < kBatch; q += 4) {
          const float4 X = rec4[(b0 + q) / 4];
          const float4 Y = rec4[(kWarp + b0 + q) / 4];
          const float4 Z = rec4[(2 * kWarp + b0 + q) / 4];
          vx[q] = X.x, vx[q + 1] = X.y, vx[q + 2] = X.z, vx[q + 3] = X.w;
          vy[q] = Y.x, vy[q + 1] = Y.y, vy[q + 2] = Y.z, vy[q + 3] = Y.w;
          vz[q] = Z.x, vz[q + 1] = Z.y, vz[q + 2] = Z.z, vz[q + 3] = Z.w;
        }
#pragma unroll
        for (int q = 0; q < kBatch; ++q) {
          const float dx = xi - vx[q];
          const float r2 = dist2(dx, yi - vy[q], zi - vz[q]);
          if (r2 <= p.rcut2 && r2 > 0.f) {
            st_shared2(tail, r2, dx);
            tail += 8 * kListStride;
          }
        }
        const unsigned limit = last_k && b0 == kWarp - kBatch ? head : full;
        if (__any_sync(kAll, tail > limit)) {
          __syncwarp();
          const int lo = static_cast<int>((tail - ent0) / 8);
          const int cnt = (lo - lane) / kListStride;
          int incl = cnt;
#pragma unroll
          for (int d = 1; d < kWarp; d <<= 1) {
            const int y = __shfl_up_sync(kAll, incl, d);
            if (lane >= d) incl += y;
          }
          const int excl = incl - cnt;
          const int total = __shfl_sync(kAll, incl, kWarp - 1);
          for (int e0 = 0; e0 < total; e0 += kWarp) {
            const int e = e0 + lane;   // the warp's e-th entry
            // its owner: the last lane whose entries start at or before e
            int o = 0;
#pragma unroll
            for (int s = kWarp / 2; s >= 1; s >>= 1) {
              const int start = __shfl_sync(kAll, excl, o + s);
              if (start <= e) o += s;
            }
            const int at = (e - __shfl_sync(kAll, excl, o)) * kListStride + o;
            if (e < total) {
              const float2 en = ent[at];
              float t[NT];
              pair_terms<kPhys, kNPhi, kNDphi, kNRho>(p, en.x, en.y, t);
              ent[at] = make_float2(t[0], t[1]);
              if constexpr (NT == 3) ent2[at] = t[2];
            }
          }
          __syncwarp();
          // each owner sums its own entries in list order
          for (int at = lane; at < lo; at += kListStride) {
            const float2 t = ent[at];
            acc[0] += t.x;
            acc[1] += t.y;
            if constexpr (NT == 3) acc[2] += ent2[at];
          }
          tail = head;
        }
      }
    }
  }

  if (p.n_groups > 1) {
    // the group warps of a column add their sums in group order, through
    // shared memory laid over the records
    __syncthreads();
    float* part = reinterpret_cast<float*>(smem_raw);   // [warps][NT][32]
#pragma unroll
    for (int q = 0; q < NT; ++q) part[(w * NT + q) * kWarp + lane] = acc[q];
    __syncthreads();
    if (g != 0) return;
    for (int h = 1; h < p.n_groups; ++h) {
#pragma unroll
      for (int q = 0; q < NT; ++q)
        acc[q] += part[((w + h) * NT + q) * kWarp + lane];
    }
  }
  if (c >= p.n_cols || !slot) return;
  const long long o = static_cast<long long>(lane) * p.n_cols + c;
  fx[o] = acc[0];
  u[o] = acc[1];
  if constexpr (kPhys == kCheb) rho[o] = acc[2];
  if constexpr (kPhys == kLJ) rho[o] = acc[1];
}

template <int kPhys, int kNPhi, int kNDphi, int kNRho>
cudaError_t launch_window(const WindowParams& p, const float* rp, float* fx,
                          float* u, float* rho, cudaStream_t stream) {
  const int warps = p.cols_per_block * p.n_groups;
  const size_t smem = warps * window_warp_smem(kPhys);
  const unsigned blocks =
      (p.n_cols + p.cols_per_block - 1) / p.cols_per_block;
  window_pair_kernel<kPhys, kNPhi, kNDphi, kNRho>
      <<<blocks, warps * kWarp, smem, stream>>>(p, rp, fx, u, rho);
  return cudaGetLastError();
}

// The window variant of a physics and its chain lengths, or null.
const void* window_kernel(int physics, int n_phi, int n_dphi, int n_rho) {
  if (physics == kInvR2)
    return reinterpret_cast<const void*>(window_pair_kernel<kInvR2, 0, 0, 0>);
  if (physics == kLJ)
    return reinterpret_cast<const void*>(window_pair_kernel<kLJ, 0, 0, 0>);
  if (physics == kCheb && n_phi == 17 && n_dphi == 16 && n_rho == 17)
    return reinterpret_cast<const void*>(
        window_pair_kernel<kCheb, 17, 16, 17>);
  if (physics == kCheb && n_phi == 17 && n_dphi == 16 && n_rho == 16)
    return reinterpret_cast<const void*>(
        window_pair_kernel<kCheb, 17, 16, 16>);
  return nullptr;
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
__global__ void __launch_bounds__(kRowThreads)
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
__global__ void __launch_bounds__(kLaneSlice * kLaneRows)
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

}  // namespace

extern "C" {

// The launch plan's view of one kernel on the current device: sets the
// kernel's dynamic shared-memory limit to the most any of its launches
// asks, then writes the blocks of ``threads`` threads an SM holds, the SM
// count and the shared bytes a block (a window block's own size; the
// lookups' ``smem`` as given).  kernel: 0 window_pair (physics and chain
// lengths pick the variant), 1 row_lookup, 2 lane_lookup.
int comd_probe_occupancy(int kernel, int physics, int n_phi, int n_dphi,
                         int n_rho, int threads, long long smem,
                         int* blocks_per_sm, int* n_sms, long long* smem_used) {
  if (blocks_per_sm == nullptr || n_sms == nullptr || smem_used == nullptr ||
      threads < 1 || smem < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* fn = nullptr;
  size_t most = 0;
  if (kernel == kWindowPair) {
    fn = window_kernel(physics, n_phi, n_dphi, n_rho);
    if (threads % kWarp != 0 || threads > kMaxWarps * kWarp)
      return static_cast<int>(cudaErrorInvalidValue);
    most = kMaxWarps * window_warp_smem(physics);
    smem = static_cast<long long>(threads / kWarp * window_warp_smem(physics));
  } else if (kernel == kRowLookup) {
    fn = reinterpret_cast<const void*>(row_lookup_kernel);
    most = kRowMaxRows * sizeof(float4);
  } else if (kernel == kLaneLookup) {
    fn = reinterpret_cast<const void*>(lane_lookup_kernel);
    most = static_cast<size_t>(kLaneMaxRows) * kLaneSlice * sizeof(float);
  }
  if (fn == nullptr || static_cast<size_t>(smem) > most)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(most));
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(n_sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, fn, threads, static_cast<size_t>(smem));
  *smem_used = smem;
  return static_cast<int>(err);
}

// physics: 0 P1 (1/r2), 1 Clenshaw (n_phi, n_dphi, n_rho of 17/16/17 for
// P2 or 17/16/16 for P3), 2 LJ.  fx and u are [A, D]; rho [A, D] too, except
// for P1 (may be null).  The plan (comd_probe_occupancy) comes first.
int comd_window_pair(const WindowParams* p, int physics, int n_phi,
                     int n_dphi, int n_rho, const void* rp, void* fx, void* u,
                     void* rho, void* stream) {
  if (p == nullptr || rp == nullptr || fx == nullptr || u == nullptr ||
      (physics != kInvR2 && rho == nullptr) || p->n_slots < 1 ||
      p->n_slots > kWarp || p->n_cols < 1 || p->n_offsets < 1 ||
      p->n_offsets > kMaxOffsets || p->group < 1 || p->n_groups < 1 ||
      p->cols_per_block < 1 || p->cols_per_block * p->n_groups > kMaxWarps ||
      p->group * p->n_groups < p->n_offsets ||
      p->group * (p->n_groups - 1) >= p->n_offsets || p->pad < 0 ||
      static_cast<long long>(p->pad) + p->n_cols > p->row_len)
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
// ``max_blocks``: the blocks the card holds at once (the plan's).
int comd_row_lookup(const void* x, const void* tab, void* out, long long n,
                    int n_rows, float scale, int max_blocks, void* stream) {
  if (x == nullptr || tab == nullptr || out == nullptr || n < 0 ||
      n_rows < 1 || n_rows > kRowMaxRows || max_blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return cudaSuccess;
  const size_t smem = static_cast<size_t>(n_rows) * sizeof(float4);
  long long blocks = (n + 4 * kRowThreads - 1) / (4 * kRowThreads);
  if (blocks > max_blocks) blocks = max_blocks;
  row_lookup_kernel<<<static_cast<unsigned>(blocks), kRowThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float4*>(tab),
      static_cast<float*>(out), n, n_rows, scale);
  return static_cast<int>(cudaGetLastError());
}

// x and out: [n_x_rows, lanes]; tab: [n_rows, lanes], all f32; lanes a
// multiple of 32.  ``max_blocks``: the blocks the card holds at once.
int comd_lane_lookup(const void* x, const void* tab, void* out,
                     long long n_x_rows, int lanes, int n_rows, float scale,
                     int max_blocks, void* stream) {
  if (x == nullptr || tab == nullptr || out == nullptr || n_x_rows < 0 ||
      lanes < 1 || lanes % kLaneSlice != 0 || n_rows < 1 ||
      n_rows > kLaneMaxRows || max_blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_x_rows == 0) return cudaSuccess;
  const size_t smem = static_cast<size_t>(n_rows) * kLaneSlice * sizeof(float);
  const dim3 block(kLaneSlice, kLaneRows);
  const int slices = lanes / kLaneSlice;
  long long per_slice = (n_x_rows + block.y - 1) / block.y;
  const long long room = (max_blocks + slices - 1) / slices;
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
