"""Tabulated-function interpolation for EAM.

Numpy half (host, init only): the uniform-grid ``InterpTable`` and the
shared-basis Chebyshev fit ``ChebFused`` (copied from comd_tpu so both
packages fit bit-identical coefficients from the same file).

Torch half: the reference's direct quadratic interpolation (``interpolate``,
src-mpi/eam.c:557-579), the fused Chebyshev evaluator
(``eval_cheb_fused``) and the cubic spline in r^2 of -P
(``interpolate_spline``, src-mpi/gpu_common.h:95-129, on the coefficients
of ``make_spline``, a copy of comd_tpu's).  comd_tpu's TPU gather
workarounds (row-stencil matrices, the two-level one-hot lookup with its
f64 hi/lo planes) are not ported: a device gather is cheap on the GPU, so
the direct interpolation replaces them.  The CUDA pair kernels
(csrc/pair.cuh) evaluate the same forms per pair.
"""
from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class InterpTable:
    """Uniform-grid quadratic-interpolation table (eam.c:496-519)."""

    n: int
    x0: float
    inv_dx: float
    padded: np.ndarray  # [n+3] f64; padded[k] == reference values[k-1]

    @staticmethod
    def from_data(n: int, x0: float, dx: float, data: np.ndarray) -> "InterpTable":
        data = np.asarray(data, dtype=np.float64)
        if data.shape != (n,):
            raise ValueError(f"table data shape {data.shape} != ({n},)")
        padded = np.empty(n + 3, dtype=np.float64)
        padded[1:n + 1] = data
        padded[0] = data[0]           # values[-1] = values[0]
        padded[n + 1] = data[n - 1]   # values[n]   = values[n-1]
        padded[n + 2] = data[n - 1]   # values[n+1] = values[n-1]
        return InterpTable(n=n, x0=float(x0), inv_dx=1.0 / float(dx), padded=padded)

    def device_table(self, dtype: torch.dtype, device) -> torch.Tensor:
        """[n+4] device table: ``padded`` plus one more copy of the last
        entry, so the 4-point stencil at the clamped index ii = n stays in
        range (comd_tpu reads the same value through its clamped gather)."""
        pad4 = np.concatenate([self.padded, self.padded[-1:]])
        return torch.as_tensor(pad4, dtype=dtype, device=device)


def interpolate(table: torch.Tensor, n: int, x0: float, inv_dx: float,
                r: torch.Tensor):
    """Quadratic interpolation (eam.c:557-579) on any-shaped ``r``.

    ``table`` is the [n+4] array of ``InterpTable.device_table``.
    Returns (f, df/dr).
    """
    r = torch.clamp(r, min=x0)
    rr = (r - x0) * inv_dx
    fl = torch.floor(rr)
    ii = fl.to(torch.int64)
    over = ii > n
    ii = torch.clamp(ii, max=n)
    frac = torch.where(over, torch.zeros_like(rr), rr - fl).to(table.dtype)

    tm1 = table[ii]           # values[ii-1]
    t0 = table[ii + 1]        # values[ii]
    t1 = table[ii + 2]        # values[ii+1]
    t2 = table[ii + 3]        # values[ii+2]
    g1 = t1 - tm1
    g2 = t2 - t0
    f = t0 + 0.5 * frac * (g1 + frac * (t1 + tm1 - 2.0 * t0))
    df = 0.5 * (g1 + frac * (g2 - g1)) * inv_dx
    return f, df


@dataclasses.dataclass(frozen=True)
class EmbedTable:
    """A table with its interpolation constants, callable as
    ``interpolate``: ``table`` is the [n+4] device array of
    ``InterpTable.device_table``, ``inv_dx`` rounded to its dtype.  Pass 2
    evaluates the EAM embedding F with it, and the fused push kernel (K4,
    ops/cuda/comm.py) reads the same constants."""
    table: torch.Tensor
    n: int
    x0: float
    inv_dx: float

    def __call__(self, rho: torch.Tensor):
        return interpolate(self.table, self.n, self.x0, self.inv_dx, rho)


def _sample_reference(tab: InterpTable, r: np.ndarray):
    """Reference quadratic interpolation (eam.c:557-579), f64 numpy.

    Returns (f, df/dr) on the sample points ``r`` -- the fit target for the
    Chebyshev representation below.
    """
    rc = np.maximum(r, tab.x0)
    rr = (rc - tab.x0) * tab.inv_dx
    ii = np.floor(rr).astype(np.int64)
    # over-end test BEFORE the clamp, matching interpolate() exactly: past
    # the table the value clamps to the last entry with frac = 0
    over = ii > tab.n
    ii = np.minimum(ii, tab.n)
    frac = np.where(over, 0.0, rr - np.floor(rr))
    pad4 = np.concatenate([tab.padded, tab.padded[-1:]])
    tm1, t0, t1, t2 = (pad4[ii + k] for k in range(4))
    g1, g2 = t1 - tm1, t2 - t0
    f = t0 + 0.5 * frac * (g1 + frac * (t1 + tm1 - 2.0 * t0))
    df = 0.5 * (g1 + frac * (g2 - g1)) * tab.inv_dx
    return f, df


@dataclasses.dataclass(frozen=True)
class ChebFused:
    """Shared-basis Chebyshev fit of several same-domain tables.

    Every table is fit in ONE transformed coordinate w = T(u), u = r^2, at
    one shared degree, so an evaluator runs a single basis recurrence
    T_k(t) = 2t*T_{k-1} - T_{k-2} and accumulates each output as
    coefficient FMAs.  In w = 1/u the Cu funcfl tables fit at degree 8-12;
    the setfl Mishin tables prefer w = log u.  ``make_cheb_fused`` picks
    the cheapest (transform, degree) meeting tolerance for ALL tables.

    Derivatives come back as (1/r) df/dr = 2 * dP/dw * dw/du -- the exact
    gradient of the returned value (conservation by construction), with no
    sqrt or divide-by-r anywhere in the pair kernel.
    """

    transform: str     # "u" | "inv_u" | "log_u"
    u_lo: float
    u_hi: float
    w_lo: float
    w_hi: float
    deg: int
    coef: dict         # name -> np.ndarray [deg+1] (value, in w domain)
    dcoef: dict        # name -> np.ndarray [deg]   (dP/dw)
    # endpoint-constrained fits (see make_cheb_fused ``constraints``): maps
    # name -> exact value at the r2=0 clamp (u_lo); empty if unconstrained.
    self_val: dict = dataclasses.field(default_factory=dict)


_TRANSFORMS = {
    "u": (lambda u: u, 0.0),
    "inv_u": (lambda u: 1.0 / u, 1.0),       # dw/du = -w^2 (1 extra op)
    "log_u": (lambda u: np.log(u), 9.0),     # log + reciprocal for dw/du
}


def _cheb_vander(t, deg):
    """Chebyshev Vandermonde on t in [-1, 1]: [len(t), deg+1]."""
    t = np.atleast_1d(t)
    V = np.zeros((len(t), deg + 1))
    V[:, 0] = 1.0
    if deg >= 1:
        V[:, 1] = t
    for k in range(2, deg + 1):
        V[:, k] = 2.0 * t * V[:, k - 1] - V[:, k - 2]
    return V


def _cheb_dvander(t0, deg, half_span):
    """d T_k / dw at one point: [deg+1] row (T'_k(t) = k U_{k-1}(t))."""
    U = np.zeros(deg + 1)
    U[0] = 1.0
    if deg >= 1:
        U[1] = 2.0 * t0
    for k in range(2, deg + 1):
        U[k] = 2.0 * t0 * U[k - 1] - U[k - 2]
    d = np.zeros(deg + 1)
    for k in range(1, deg + 1):
        d[k] = k * U[k - 1]
    return d / half_span


def _fit_constrained(w, f, deg, w_lo, w_hi, w_end, mode):
    """Chebyshev LSQ with exact endpoint constraints at w_end.

    mode: '' (none), 'val' (P(w_end)=0), 'val_der' (also P'(w_end)=0).
    Constraint elimination via the SVD null space of the constraint rows.
    """
    mid, half = 0.5 * (w_lo + w_hi), 0.5 * (w_hi - w_lo)
    t = (w - mid) / half
    A = _cheb_vander(t, deg)
    if not mode:
        c, *_ = np.linalg.lstsq(A, f, rcond=None)
        return c
    t_end = (w_end - mid) / half
    rows = [_cheb_vander(np.array([t_end]), deg)[0]]
    if mode == "val_der":
        rows.append(_cheb_dvander(t_end, deg, half))
    C = np.stack(rows)
    _, _, Vt = np.linalg.svd(C)
    N = Vt[len(rows):].T
    z, *_ = np.linalg.lstsq(A @ N, f, rcond=None)
    return N @ z


def make_cheb_fused(tabs: dict, r_lo: float, r_hi: float,
                    tol_f: float = 2e-5, tol_df: float = 2e-3,
                    n_sample: int = 100001,
                    constraints: dict = None) -> ChebFused:
    """Fit all ``tabs`` (name -> InterpTable) with one shared basis.

    Candidate (transform, degree) pairs are tried in ascending cost order
    (cost ~ degree * (1 basis + n_out accs) + transform overhead); the
    first meeting (tol_f, tol_df) for every table wins.  Falls back to the
    most accurate candidate seen if none meets tolerance.

    ``constraints`` maps table name -> 'val' | 'val_der', enforcing EXACT
    zeros at the cutoff endpoint (value, optionally also the derivative).
    """
    u_lo, u_hi = float(r_lo) ** 2, float(r_hi) ** 2
    u = np.linspace(u_lo, u_hi, n_sample)
    r = np.sqrt(u)
    refs = {name: _sample_reference(tab, r) for name, tab in tabs.items()}
    n_out = 2 * len(tabs)
    constraints = constraints or {}

    cands = []
    for tr, (fn, extra) in _TRANSFORMS.items():
        for deg in (8, 10, 12, 14, 16, 20, 24, 32):
            cands.append((deg * (1 + n_out) + extra, deg, tr))
    cands.sort()

    def dwdu_np(tr, w, u):
        if tr == "u":
            return np.ones_like(u)
        if tr == "inv_u":
            return -w * w
        return 1.0 / u  # log_u

    best = None        # (max_rel_excess, fused)
    for _cost, deg, tr in cands:
        fn, _ = _TRANSFORMS[tr]
        w = fn(u)
        dw = dwdu_np(tr, w, u)
        w_lo, w_hi = float(np.min(w)), float(np.max(w))
        w_end = float(fn(np.array([u_hi]))[0])
        coef, dcoef, self_val = {}, {}, {}
        worst = 0.0
        for name, (f_ref, df_ref) in refs.items():
            # per-table minimal degree within the shared (transform, deg):
            # each table keeps its own coefficient length
            c, t_err = None, None
            for d in range(max(4, deg - 4), deg + 1, 2):
                cc = _fit_constrained(w, f_ref, d, w_lo, w_hi, w_end,
                                      constraints.get(name, ""))
                ch = np.polynomial.chebyshev.Chebyshev(
                    cc, domain=[w_lo, w_hi])
                err_f = np.max(np.abs(ch(w) - f_ref)) \
                    / np.max(np.abs(f_ref))
                err_df = np.max(
                    np.abs(ch.deriv()(w) * dw * 2.0 * r - df_ref)) \
                    / np.max(np.abs(df_ref))
                c, t_err = ch, max(err_f / tol_f, err_df / tol_df)
                if t_err <= 1.0:
                    break
            worst = max(worst, t_err)
            coef[name] = np.asarray(c.coef, np.float64)
            dcoef[name] = np.asarray(c.deriv().coef, np.float64)
            if constraints.get(name):
                self_val[name] = float(c(float(fn(np.array([u_lo]))[0])))
        fused = ChebFused(transform=tr, u_lo=u_lo, u_hi=u_hi,
                          w_lo=w_lo, w_hi=w_hi, deg=deg,
                          coef=coef, dcoef=dcoef, self_val=self_val)
        if worst <= 1.0:
            return fused
        if best is None or worst < best[0]:
            best = (worst, fused)
    warnings.warn(
        f"Chebyshev fit did not reach the requested tolerance for this "
        f"table (worst error {best[0]:.3g}x the tol_f/tol_df target); "
        f"returning the most accurate candidate.  Consider "
        f"interp_impl='rows' (reference-interpolant-exact) for this "
        f"potential file.", stacklevel=2)
    return best[1]


def as_dtype(x: float, dtype: torch.dtype) -> float:
    """``x`` rounded to ``dtype`` (as a Python float), so every constant an
    evaluator folds into its arithmetic is the one a ``dtype`` kernel sees."""
    if dtype == torch.float32:
        return float(np.float32(x))
    return float(x)


def cheb_wants_coefs(fz: ChebFused, wants) -> list:
    """Coefficient arrays for the (name, kind) outputs in ``wants``."""
    return [fz.coef[n] if k == "val" else fz.dcoef[n] for n, k in wants]


def eval_cheb_fused(fz: ChebFused, r2: torch.Tensor, wants):
    """Evaluate fused-basis outputs on u = r^2 tensors.

    ``wants`` is a sequence of (name, kind) with kind 'val' or 'der';
    returns the list of tensors in order.  'der' entries are
    (1/r) * df/dr = 2 * df/du (the form pair kernels multiply by the
    displacement vector -- no sqrt, no divide).  Every constant is rounded
    to r2's dtype first, as comd_tpu's evaluator does.
    """
    dtype = r2.dtype
    c_ = lambda x: as_dtype(x, dtype)  # noqa: E731
    u = torch.clamp(r2, c_(fz.u_lo), c_(fz.u_hi))
    uinv = None
    if fz.transform == "u":
        w = u
    elif fz.transform == "inv_u":
        uinv = 1.0 / u
        w = uinv
    else:  # log_u
        uinv = 1.0 / u
        w = torch.log(u)

    t = (w - c_(0.5 * (fz.w_lo + fz.w_hi))) * c_(2.0 / (fz.w_hi - fz.w_lo))
    t2 = t + t

    cs = cheb_wants_coefs(fz, wants)
    deg = max(len(c) for c in cs) - 1

    # shared basis recurrence with inline accumulation
    accs = [torch.full_like(u, c_(c[0])) for c in cs]
    if deg >= 1:
        accs = [a + c_(c[1]) * t if len(c) > 1 else a
                for a, c in zip(accs, cs)]
    Tm1, Tk = torch.ones_like(u), t
    for k in range(2, deg + 1):
        Tm1, Tk = Tk, t2 * Tk - Tm1
        accs = [a + c_(c[k]) * Tk if len(c) > k else a
                for a, c in zip(accs, cs)]

    if fz.transform == "u":
        two_dwdu = 2.0
    elif fz.transform == "inv_u":
        two_dwdu = -2.0 * w * w
    else:
        two_dwdu = 2.0 * uinv

    return [a if kind == "val" else two_dwdu * a
            for (_n, kind), a in zip(wants, accs)]


@dataclasses.dataclass(frozen=True)
class SplineTable:
    """Cubic-spline-in-r^2 table (gpu_utility.c:377-430, gpu_common.h:95-129).

    ``coeffs[i] = (a, b, c, d)`` with f(r2) = ((a*r2 + b)*r2 + c)*r2 + d on
    interval i, and (1/r) df/dr = 2*((3*(a*r2 + b) - b)*r2 + c).
    """

    n: int
    x0: float
    xn: float
    inv_dx: float
    coeffs: np.ndarray  # [n, 4] f64


def make_spline(values: np.ndarray, n: int, x0: float,
                inv_dx: float) -> SplineTable:
    """Build spline coefficients over knots x_i = (x0 + i/invDx)^2 (copy of
    comd_tpu.potentials.tables.make_spline, so both packages build the same
    coefficients bit for bit).

    Port of the reference tridiagonal sweep (gpu_utility.c:377-430): natural
    (y''=0) at the left end, clamped (y'=0) at the right end.  ``values`` must
    have at least n+1 entries (the reference reads values[n]).
    """
    values = np.asarray(values, dtype=np.float64)
    if values.shape[0] < n + 1:
        raise ValueError(f"make_spline needs {n + 1} values, got "
                         f"{values.shape[0]}")
    dx = 1.0 / inv_dx
    xs = (x0 + np.arange(n + 2) * dx) ** 2  # knots in r^2 space

    u = np.zeros(n, dtype=np.float64)
    y2 = np.zeros(n + 1, dtype=np.float64)
    for i in range(1, n):
        xi, xp, xn_ = xs[i], xs[i - 1], xs[i + 1]
        sig = (xi - xp) / (xn_ - xp)
        p = sig * y2[i - 1] + 2.0
        y2[i] = (sig - 1.0) / p
        ui = (values[i + 1] - values[i]) / (xn_ - xi) - \
            (values[i] - values[i - 1]) / (xi - xp)
        u[i] = (6.0 * ui / (xn_ - xp) - sig * u[i - 1]) / p
    xn_, xnp = xs[n], xs[n - 1]
    qn = 0.5
    un = (-3.0 / (xn_ - xnp)) * (values[n] - values[n - 1]) / (xn_ - xnp)
    y2[n] = (un - qn * u[n - 1]) / (qn * y2[n - 1] + 1.0)
    for i in range(n - 1, -1, -1):
        y2[i] = y2[i] * y2[i + 1] + u[i]

    coeffs = np.zeros((n, 4), dtype=np.float64)
    for i in range(n):
        x1, x2 = xs[i], xs[i + 1]
        d2y1, d2y2 = y2[i], y2[i + 1]
        y1v, y2v = values[i], values[i + 1]
        h = x2 - x1
        coeffs[i, 0] = (d2y2 - d2y1) / (6.0 * h)
        coeffs[i, 1] = (x2 * d2y1 - x1 * d2y2) / (2.0 * h)
        coeffs[i, 2] = (1.0 / h) * (
            (-3 * x2 * x2 + h * h) * d2y1 / 6.0
            + (3 * x1 * x1 - h * h) * d2y2 / 6.0
            - y1v + y2v)
        coeffs[i, 3] = (1.0 / h) * (
            x2 * y1v - x1 * y2v
            + d2y1 * (x2 ** 3 - x2 * h * h) / 6.0
            + d2y2 * (-x1 ** 3 + x1 * h * h) / 6.0)
    return SplineTable(n=n, x0=float(x0), xn=float(x0 + n * dx),
                       inv_dx=float(inv_dx), coeffs=coeffs)


def interpolate_spline(coeffs: torch.Tensor, n: int, x0: float, xn: float,
                       inv_dx: float, x0_inv_dx: float, r2: torch.Tensor):
    """Spline evaluation on r^2 tensors (gpu_common.h:95-129), op by op as
    comd_tpu.potentials.tables.interpolate_spline: r = sqrt(r2) clipped to
    [x0, xn], interval floor(r * inv_dx - x0 * inv_dx) clipped to [0, n-1],
    then the cubic at r2 itself.  ``x0``, ``xn``, ``inv_dx`` and
    ``x0_inv_dx`` (the product taken in f64) come rounded to r2's dtype, as
    comd_tpu's Python-float constants are.  Returns (f, (1/r) df/dr).
    """
    r = torch.clamp(torch.sqrt(r2), x0, xn)
    idx = torch.floor(r * inv_dx - x0_inv_dx).to(torch.int64)
    idx = torch.clamp(idx, 0, n - 1)
    a, b, c, d = coeffs[idx].unbind(-1)
    tmp = a * r2 + b
    f = (tmp * r2 + c) * r2 + d
    df = 2.0 * ((3.0 * tmp - b) * r2 + c)
    return f, df
