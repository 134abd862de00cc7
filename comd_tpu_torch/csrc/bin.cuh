// getBoxFromCoord (linkCells.c:448-480) on the card: a coordinate's cell,
// local or halo, in f64 as comd_tpu and the port's plain version
// (ops/binning.py::box_from_coord) take it, whatever the dynamics dtype.
// Shared by rebucket.cu (the redistribution) and arrivals.cu (the atom
// exchange's unload), so both bin by one code.
//
// A source that includes this header is built with -fmad=false; the
// difference and the product are rounded one by one (_rn intrinsics).
#pragma once

// The cell index along one axis: floor((x - lo) * inv), a coordinate
// inside the domain that rounds onto the far face kept in the last cell,
// one outside it (or NaN) past it, clamped to [-1, g].
__device__ __forceinline__ int bin_axis(double x, double lo, double hi,
                                        double inv, int g) {
  const double f = floor(__dmul_rn(__dsub_rn(x, lo), inv));
  if (!(x < hi)) return g;
  if (f == static_cast<double>(g)) return g - 1;
  if (f < -1.0) return -1;
  if (f > static_cast<double>(g)) return g;
  return static_cast<int>(f);
}

// getBoxFromTuple (linkCells.c:299-346): the local cell (dense, or from
// the Hilbert table ``box_of_tuple`` [gx, gy, gz] where there is one), or
// the halo cell's number (z faces over y faces over x faces).
__device__ __forceinline__ int bin_box_from_tuple(const int* grid,
                                                  int n_local,
                                                  const long long* box_of_tuple,
                                                  int ix, int iy, int iz) {
  const int gx = grid[0], gy = grid[1], gz = grid[2];
  const int nl = n_local;
  if (iz == -1 || iz == gz)
    return nl + 2 * gz * gy + 2 * gz * (gx + 2) +
           (iz == gz ? (gx + 2) * (gy + 2) : 0) + (gx + 2) * (iy + 1) +
           (ix + 1);
  if (iy == -1) return nl + 2 * gz * gy + iz * (gx + 2) + (ix + 1);
  if (iy == gy) return nl + 2 * gz * gy + gz * (gx + 2) + (gx + 2) * iz +
                       (ix + 1);
  if (ix == -1) return nl + iz * gy + iy;
  if (ix == gx) return nl + gy * gz + iz * gy + iy;
  if (box_of_tuple != nullptr)
    return static_cast<int>(box_of_tuple[(static_cast<long long>(ix) * gy +
                                          iy) * gz + iz]);
  return ix + iy * gx + iz * gx * gy;
}

// The cell of the coordinate ``x`` (three values of the dynamics dtype,
// cast up to f64): always below n_local + n_halo.
template <typename T>
__device__ __forceinline__ int bin_box(const T* x, const double* lo,
                                       const double* hi, const double* inv,
                                       const int* grid, int n_local,
                                       const long long* box_of_tuple) {
  int t[3];
#pragma unroll
  for (int k = 0; k < 3; ++k)
    t[k] = bin_axis(static_cast<double>(x[k]), lo[k], hi[k], inv[k],
                    grid[k]);
  return bin_box_from_tuple(grid, n_local, box_of_tuple, t[0], t[1], t[2]);
}
