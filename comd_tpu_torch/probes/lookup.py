"""P4-P6, the archive's table-lookup probes, on the ``row_lookup`` and
``lane_lookup`` kernels.

tools/archive/gather_probe.py and gather_probe2.py time the lookup of
~7.1M values (N = 256 * 32 * 864, uniform in [0, 510)) in a 512-row
table, the work of EAM pass 2 and of the exact-table evaluator:

- P4 (gather_probe.py, pallas_take): a row r = tab[floor(x)] of a [512, 4]
  table (four shifted views of a flat [515] table), u = x - floor(x),
  out = x + scale * (r0 + u * (r1 + u * (r2 + r3))).
- P5 (gather_probe2.py, pgather): x as [N / 128, 128] and a [512, 128]
  table (the probe tiles one column), out[r, l] = x + scale *
  (tab[floor(x[r, l]), l] * u).
- P6 (gather_probe2.py, ponehot) means P5's function through a one-hot
  select-sum, a workaround for the TPU's matrix unit; as written it does
  not trace, and the probe never calls it.  Here it is P5's kernel.

``scale`` defaults to the probes' 1e-12, at which the f32 output is x
itself; scale 1 shows the lookup.  floor(x) is clamped to the table's rows,
as XLA's gather clamps.  The plain versions round op by op as the kernels
do, so the two agree bit for bit.

    python -m comd_tpu_torch.probes.lookup {4,5,6} [--n N] [--reps N]
        [--device cuda|cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from . import time_ms

N = 256 * 32 * 864        # one chunk's pair lookups
NTAB = 512
LANES = 128
SCALE = float(np.float32(1e-12))
NAMES = {4: "pallas", 5: "pgather", 6: "ponehot"}


def make_inputs(probe: int, n: int = N) -> tuple:
    """(x, tab) f32 exactly as the archive's main() draws them with N = n:
    P4 x [n], tab [512, 4]; P5 and P6 x [n / 128, 128], tab [512, 128]."""
    rng = np.random.default_rng(0)
    x = rng.uniform(0, NTAB - 2, n).astype(np.float32)
    if probe == 4:
        flat = rng.normal(size=NTAB + 3).astype(np.float32)
        return x, np.stack([flat[i:i + NTAB] for i in range(4)], axis=1)
    if probe in (5, 6):
        col = rng.normal(size=(NTAB, 1)).astype(np.float32)
        return x.reshape(-1, LANES), np.tile(col, (1, LANES))
    raise ValueError(f"no lookup probe P{probe}")


def _row_and_frac(x, n_rows: int):
    fl = torch.floor(x)
    return fl.clamp(0, n_rows - 1).long(), x - fl


def row_lookup_plain(x: torch.Tensor, tab: torch.Tensor,
                     scale: float = SCALE) -> torch.Tensor:
    """P4 in eager PyTorch, op by op as gather_probe.py's ``rows``."""
    ii, u = _row_and_frac(x, tab.shape[0])
    r = tab[ii]
    s = r[..., 2] + r[..., 3]
    s = r[..., 1] + u * s
    s = r[..., 0] + u * s
    return x + float(np.float32(scale)) * s


def lane_lookup_plain(x: torch.Tensor, tab: torch.Tensor,
                      scale: float = SCALE) -> torch.Tensor:
    """P5 in eager PyTorch, op by op as gather_probe2.py's k_gather."""
    ii, u = _row_and_frac(x, tab.shape[0])
    t = torch.gather(tab, 0, ii)
    return x + float(np.float32(scale)) * (t * u)


def row_lookup(x: torch.Tensor, tab: torch.Tensor,
               scale: float = SCALE) -> torch.Tensor:
    """P4: CPU tensors run the plain version; CUDA tensors the kernel."""
    if x.device.type == "cpu":
        return row_lookup_plain(x, tab, scale)
    from ..ops.cuda import probe
    return probe.row_lookup(x, tab, scale)


def lane_lookup(x: torch.Tensor, tab: torch.Tensor,
                scale: float = SCALE) -> torch.Tensor:
    """P5: CPU tensors run the plain version; CUDA tensors the kernel."""
    if x.device.type == "cpu":
        return lane_lookup_plain(x, tab, scale)
    from ..ops.cuda import probe
    return probe.lane_lookup(x, tab, scale)


# P6 computes P5's function
onehot_lookup = lane_lookup


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m comd_tpu_torch.probes.lookup",
        description="Time the table-lookup probe P4, P5 or P6 on its kernel.")
    ap.add_argument("probe", type=int, choices=(4, 5, 6))
    ap.add_argument("--n", type=int, default=N,
                    help=f"values looked up (default {N}; P5 and P6: a "
                         f"multiple of {LANES})")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.n < 1 or (args.probe != 4 and args.n % LANES):
        ap.error(f"--n must be positive, and for P5/P6 a multiple of {LANES}")
    device = torch.device(args.device)
    x, tab = (torch.from_numpy(a).to(device)
              for a in make_inputs(args.probe, args.n))
    fn = {4: row_lookup, 5: lane_lookup, 6: onehot_lookup}[args.probe]
    out = fn(x, tab)
    if not bool(torch.isfinite(out).all()):
        raise RuntimeError(f"P{args.probe}: non-finite values")
    ms = time_ms(lambda: fn(x, tab), args.reps, device)
    where = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    print(f"{NAMES[args.probe]:8s} {ms:10.3f} ms per {args.n / 1e6:.1f}M "
          f"lookups ({args.n / ms / 1e6:.2f} G/s) on {where}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
