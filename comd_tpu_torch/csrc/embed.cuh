// The EAM embedding function F and its derivative F', as
// comd_tpu_torch/potentials/tables.interpolate computes them: the
// reference's direct quadratic interpolation of a uniform table
// (eam.c:557-579), operation by operation in PyTorch's order.  Shared by
// comm.cu (K4: F' of an x-face plane) and step.cu (pass 2, embed_fill).
//
// A source that includes this header is built with -fmad=false: nvcc
// would otherwise contract a*b + c into one FMA, and F and F' would no
// longer equal PyTorch's eager kernels (one rounding an operation) bit
// for bit.
#pragma once

// F's table and constants: ``table`` is InterpTable.device_table ([n + 4]),
// ``x0`` and ``inv_dx`` rounded to T (PyTorch rounds a Python float to the
// tensor's dtype in a tensor-by-scalar op).
template <typename T>
struct Embed {
  int n;
  T x0, inv_dx;
  const T* table;
};

// interpolate's index, fraction and the four table values around rho.
template <typename T>
struct EmbedStencil {
  T frac, tm1, t0, t1, t2;
};

template <typename T>
__device__ __forceinline__ EmbedStencil<T> embed_stencil(T rho,
                                                         const Embed<T>& p) {
  const T r = rho < p.x0 ? p.x0 : rho;
  const T rr = (r - p.x0) * p.inv_dx;
  const T fl = floor(rr);
  // a 32-bit index: fl > n is PyTorch's int64(fl) > n for every fl >= 0
  // (NaN compares false, as there), and fl is then within int's range
  const bool over = fl > static_cast<T>(p.n);
  const int ii = over ? p.n : static_cast<int>(fl);
  return {over ? T(0) : rr - fl, p.table[ii], p.table[ii + 1],
          p.table[ii + 2], p.table[ii + 3]};
}

// interpolate's derivative output: 0.5 * (g1 + frac * (g2 - g1)) * inv_dx.
template <typename T>
__device__ __forceinline__ T embed_derivative(T rho, const Embed<T>& p) {
  const EmbedStencil<T> s = embed_stencil(rho, p);
  const T g1 = s.t1 - s.tm1;
  const T g2 = s.t2 - s.t0;
  return T(0.5) * (g1 + s.frac * (g2 - g1)) * p.inv_dx;
}

// interpolate's two outputs: f = t0 + 0.5 * frac * (g1 + frac * (t1 + tm1
// - 2 t0)), and df as embed_derivative.
template <typename T>
__device__ __forceinline__ void embed_value_and_derivative(
    T rho, const Embed<T>& p, T* f, T* df) {
  const EmbedStencil<T> s = embed_stencil(rho, p);
  const T g1 = s.t1 - s.tm1;
  const T g2 = s.t2 - s.t0;
  *f = s.t0 + T(0.5) * s.frac * (g1 + s.frac * (s.t1 + s.tm1 - T(2) * s.t0));
  *df = T(0.5) * (g1 + s.frac * (g2 - g1)) * p.inv_dx;
}
