"""P1-P3, the archive's pair-window probes, on the ``window_pair`` kernel.

tools/archive/pallas_probe.py (P1), pallas_probe2.py (P2) and
pallas_probe3.py (P3) time a branch-free pair sum on random positions rp
[3, A, L] (A = 32 slots of L lane columns).  Output column c (grid chunks
of C = 256 columns) and i-slot a sum over static lane offsets d and all A
j-slots b a pair function of dr = rp[:, a, PAD + c] - rp[:, b, PAD + c + d],
masked to 0 < r2 <= rcut2:

- P1: 8 offsets, rcut2 36: fx += dx / r2, u += r2.
- P2: 26 offsets drawn by RandomState(1) (unsorted) and 0, rcut2 29:
  t2 = clip(r2, 4, 29) * 0.16 - 2.64, degree-16 Clenshaw chains phi on
  COEF, dphi on DCOEF, rho on COEF[::-1]; fx += -2 dphi dx, u += phi,
  rho += rho.
- P3: P2 with the offsets sorted and rho on COEF[1:]; or ``lj``:
  inv = 1/r2, r6 = inv^3, fx += r6 inv (12 r6 - 6) dx, u, rho += r6 (r6 - 1).
  P3's variants A, B and C are three Mosaic loop structures (a fori_loop
  over staged neighbor slabs, unrolled offsets accumulating into the output
  refs, unrolled offsets with register accumulators) of one function, so
  the port has one kernel and no variant option.

The constants are private copies of the archive's (nothing is imported
from tools/).  ``window_pair`` runs csrc/probe.cu on CUDA tensors and the
plain version on CPU tensors.  ``window_pair_magnitude`` gives each output
element the scale its rounding error is held against, ``n_in_cutoff`` the
pairs whose terms the sums need (``in_cutoff_counts`` per offset and
output).

    python -m comd_tpu_torch.probes.window {1,2,3} [--lj] [--chunks N]
        [--reps N] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from . import time_ms

SLOTS, CHUNK = 32, 256        # A and C of every window probe


def _window(pad: int) -> int:
    """W: a chunk's window, C + 2 PAD rounded up to whole lane tiles."""
    return -(-(CHUNK + 2 * pad) // 128) * 128


def _f32(values) -> tuple:
    return tuple(float(np.float32(v)) for v in values)


_P23_PAD = 553
_DRAWN = np.random.RandomState(1).choice(
    np.arange(-_P23_PAD, _P23_PAD), 26, replace=False).tolist()
COEF = _f32(np.random.RandomState(2).uniform(-1, 1, 17))
DCOEF = _f32(np.random.RandomState(3).uniform(-1, 1, 16))


@dataclasses.dataclass(frozen=True)
class WindowSpec:
    """One window probe: its geometry, its inputs and its pair function.
    ``physics``: "inv_r2" (P1), "cheb" (P2, P3) or "lj" (P3 --lj)."""
    name: str
    physics: str
    pad: int
    offsets: tuple
    rcut2: float
    span: float               # positions uniform in [0, span)
    chunks: int               # the probe's own grid
    phi: tuple = ()           # Clenshaw coefficients (f32 values)
    dphi: tuple = ()
    rho: tuple = ()
    clip: tuple = (4.0, 29.0)
    t_scale: float = float(np.float32(0.16))
    t_shift: float = float(np.float32(2.64))

    @property
    def window(self) -> int:
        return _window(self.pad)

    @property
    def n_out(self) -> int:
        return 2 if self.physics == "inv_r2" else 3


P1 = WindowSpec("P1", "inv_r2", 300, (-300, -299, -1, 0, 1, 37, 299, 300),
                36.0, 50.0, 4)
P2 = WindowSpec("P2", "cheb", _P23_PAD, tuple(_DRAWN) + (0,), 29.0, 40.0, 8,
                COEF, DCOEF, COEF[::-1])
P3 = WindowSpec("P3", "cheb", _P23_PAD, tuple(sorted(_DRAWN)) + (0,), 29.0,
                40.0, 8, COEF, DCOEF, COEF[1:])
P3_LJ = dataclasses.replace(P3, name="P3 LJ", physics="lj", phi=(), dphi=(),
                            rho=())


def spec(probe: int, lj: bool = False) -> WindowSpec:
    """The WindowSpec of probe 1, 2 or 3 (``lj``: P3's LJ physics)."""
    if lj and probe != 3:
        raise ValueError("only P3 has the LJ physics")
    return {1: P1, 2: P2, 3: P3_LJ if lj else P3}[probe]


def make_inputs(probe: int, n_chunks: int = None) -> np.ndarray:
    """rp [3, A, L] f32 exactly as the archive's main() draws it for
    ``n_chunks`` chunks (default: the probe's own), L = (n_chunks - 1) C + W
    so that the last chunk's window fits."""
    sp = spec(probe)
    n = sp.chunks if n_chunks is None else n_chunks
    L = (n - 1) * CHUNK + sp.window
    rng = np.random.RandomState(0)
    return rng.uniform(0, sp.span, size=(3, SLOTS, L)).astype(np.float32)


def n_columns(sp: WindowSpec, row_len: int) -> int:
    """D, the output columns of an rp with ``row_len`` lanes: whole chunks
    whose windows fit."""
    if row_len < sp.window or (row_len - sp.window) % CHUNK:
        raise ValueError(f"rp's {row_len} lanes are not (n - 1) * {CHUNK} + "
                         f"{sp.window} for {sp.name}")
    return row_len - sp.window + CHUNK


def n_pairs(sp: WindowSpec, n_cols: int, slots: int = SLOTS) -> int:
    """Candidate pairs of one sum: every (i-slot, column, offset, j-slot)."""
    return n_cols * slots * len(sp.offsets) * slots


# --------------------------------------------------------------------------
# plain PyTorch version
# --------------------------------------------------------------------------

def _clenshaw(coef, t2, magnitude=False):
    """The probes' chain; with ``magnitude`` instead the sum over its steps
    of their operands' magnitudes, |t2 b0| + |b1| + |c|: the scale of the
    chain's rounding, however much its value cancels."""
    b0 = torch.zeros_like(t2)
    b1 = torch.zeros_like(t2)
    s = torch.zeros_like(t2)
    for k in range(len(coef) - 1, 0, -1):
        if magnitude:
            s = s + (t2 * b0).abs() + b1.abs() + abs(coef[k])
        b0, b1 = t2 * b0 - b1 + coef[k], b0
    if magnitude:
        return s + (0.5 * t2 * b0).abs() + b1.abs() + abs(coef[0])
    return 0.5 * t2 * b0 - b1 + coef[0]


def _in_cutoff(sp: WindowSpec, r2):
    return (r2 <= sp.rcut2) & (r2 > 0)


def _pair_terms(sp: WindowSpec, dx, r2, magnitude=False):
    """(fc * dx, [scalar terms]) of one offset's [A, A, cols] pair block,
    in the probes' own operations.  With ``magnitude`` each term's scale
    instead: LJ's differences taken as sums, dx as |dx|, a chain's
    operands' magnitudes (``_clenshaw``), so a term that cancels to ~0
    keeps the size of its parts."""
    zero = r2.new_zeros(())
    mask = _in_cutoff(sp, r2)
    sign = 1.0 if magnitude else -1.0
    if magnitude:
        dx = dx.abs()
    if sp.physics in ("inv_r2", "lj"):
        inv = torch.where(mask, 1.0 / torch.where(mask, r2, torch.ones_like(
            r2)), zero)
        if sp.physics == "inv_r2":
            return inv * dx, [torch.where(mask, r2, zero)]
        r6 = inv * inv * inv
        fc = torch.where(mask, r6 * inv * (12.0 * r6 + sign * 6.0), zero)
        phi = torch.where(mask, r6 * (r6 + sign * 1.0), zero)
        return fc * dx, [phi, phi]
    t2 = torch.clamp(r2, *sp.clip) * sp.t_scale - sp.t_shift
    phi = _clenshaw(sp.phi, t2, magnitude)
    dphi = _clenshaw(sp.dphi, t2, magnitude)
    rho = _clenshaw(sp.rho, t2, magnitude)
    fc = torch.where(mask, sign * 2.0 * dphi, zero)
    return fc * dx, [torch.where(mask, phi, zero),
                     torch.where(mask, rho, zero)]


def _pair_blocks(rp: torch.Tensor, sp: WindowSpec, col_chunk: int):
    """(c0, c1, dx, r2) of every offset's [A, A, c1 - c0] pair block,
    ``col_chunk`` output columns at a time, offsets in the probe's order."""
    D = n_columns(sp, rp.shape[2])
    for c0 in range(0, D, col_chunk):
        c1 = min(D, c0 + col_chunk)
        ri = rp[:, :, sp.pad + c0:sp.pad + c1]
        for d in sp.offsets:
            rj = rp[:, :, sp.pad + c0 + d:sp.pad + c1 + d]
            dx, dy, dz = ri[:, :, None, :] - rj[:, None, :, :]
            yield c0, c1, dx, dx * dx + dy * dy + dz * dz


def _sums(rp: torch.Tensor, sp: WindowSpec, col_chunk: int,
          magnitude: bool) -> tuple:
    A = rp.shape[1]
    outs = rp.new_zeros((sp.n_out, A, n_columns(sp, rp.shape[2])))
    for c0, c1, dx, r2 in _pair_blocks(rp, sp, col_chunk):
        fdx, scal = _pair_terms(sp, dx, r2, magnitude)
        for k, v in enumerate([fdx] + scal):
            outs[k, :, c0:c1] += v.sum(1)
    return tuple(outs.unbind(0))


def window_pair_plain(rp: torch.Tensor, sp: WindowSpec, col_chunk: int = 2048
                      ) -> tuple:
    """The probe's sums in eager PyTorch: per offset, in the probe's order,
    the j-sum of each output is taken and added to it.  ``col_chunk``
    columns at a time bound the [3, A, A, cols] temporaries.  Returns (fx,
    u) for P1, else (fx, u, rho), each [A, D]."""
    return _sums(rp, sp, col_chunk, False)


def window_pair_magnitude(rp: torch.Tensor, sp: WindowSpec,
                          col_chunk: int = 2048) -> tuple:
    """Per output element, the sum of its terms' magnitudes (see
    ``_pair_terms``): the scale that element's rounding error is held
    against, whatever the terms cancel to."""
    return _sums(rp, sp, col_chunk, True)


def n_in_cutoff(rp: torch.Tensor, sp: WindowSpec, col_chunk: int = 2048
                ) -> int:
    """Candidate pairs with 0 < r2 <= rcut2: the pairs whose terms the sums
    need (the rest add exact zeros)."""
    n = torch.zeros((), dtype=torch.int64, device=rp.device)
    for *_, r2 in _pair_blocks(rp, sp, col_chunk):
        n += _in_cutoff(sp, r2).sum()
    return int(n)


def in_cutoff_counts(rp: torch.Tensor, sp: WindowSpec, col_chunk: int = 2048
                     ) -> torch.Tensor:
    """[offsets, A, D] int32: per offset and output, the j-slots inside the
    cutoff (what the kernel lists for that output and offset)."""
    A = rp.shape[1]
    D = n_columns(sp, rp.shape[2])
    out = torch.zeros((len(sp.offsets), A, D), dtype=torch.int32,
                      device=rp.device)
    k = 0
    for c0, c1, _dx, r2 in _pair_blocks(rp, sp, col_chunk):
        out[k, :, c0:c1] = _in_cutoff(sp, r2).sum(1, dtype=torch.int32)
        k = (k + 1) % len(sp.offsets)
    return out


def element_error(got, want, scale) -> float:
    """max over outputs and elements of |got - want| / scale, ``scale``
    from ``window_pair_magnitude``; inf where the scale is 0 (no pair in
    the cutoff, an exact 0 in both) and the two differ."""
    worst = 0.0
    for a, b, s in zip(got, want, scale):
        d = (a.double() - b.double()).abs()
        if bool(((s == 0) & (d != 0)).any()):
            return float("inf")
        worst = max(worst, float((d / s.double().clamp_min(1e-300)).max()))
    return worst


def window_pair(rp: torch.Tensor, sp: WindowSpec) -> tuple:
    """The probe's sums over every whole chunk of ``rp`` [3, A, L] f32.
    CPU tensors run the plain version; CUDA tensors the kernel."""
    if rp.device.type == "cpu":
        return window_pair_plain(rp, sp)
    from ..ops.cuda import probe
    return probe.window_pair(rp, sp, n_columns(sp, rp.shape[2]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m comd_tpu_torch.probes.window",
        description="Time the pair-window probe P1, P2 or P3 on its kernel.")
    ap.add_argument("probe", type=int, choices=(1, 2, 3))
    ap.add_argument("--lj", action="store_true", help="P3's LJ physics")
    ap.add_argument("--chunks", type=int, default=None,
                    help="chunks of 256 columns (default: the probe's own, "
                         "4 for P1, 8 for P2 and P3)")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.probe != 3 and args.lj:
        ap.error("--lj is P3's")
    if args.chunks is not None and args.chunks < 1:
        ap.error("--chunks must be at least 1")
    device = torch.device(args.device)
    sp = spec(args.probe, args.lj)
    rp = torch.from_numpy(make_inputs(args.probe, args.chunks)).to(device)
    outs = window_pair(rp, sp)
    if not all(bool(torch.isfinite(o).all()) for o in outs):
        raise RuntimeError(f"{sp.name}: non-finite sums")
    ms = time_ms(lambda: window_pair(rp, sp), args.reps, device)
    D = outs[0].shape[1]
    pairs = n_pairs(sp, D)
    where = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    print(f"{sp.name} on {where}: {D // CHUNK} chunks, {pairs / 1e6:.2f}M "
          f"pairs; {ms:8.3f} ms/call  {pairs / ms / 1e6:7.2f} Gpairs/s",
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
