"""The archive's probe modules (tools/archive/) for the probe tests, loaded
by path; nothing in tools/ changes.  Tests patch the loaded module objects
only (with pytest's monkeypatch)."""
import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from comd_tpu_torch.probes import window

ARCHIVE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools", "archive")
WINDOW_MODULES = {1: "pallas_probe", 2: "pallas_probe2", 3: "pallas_probe3"}


@functools.cache
def load(name):
    spec = importlib.util.spec_from_file_location(
        f"archive_{name}", os.path.join(ARCHIVE, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def window_call(probe, variant, lj, n_chunks):
    """The archive's window kernel of probe 1, 2 or 3 (P3: ``variant`` A,
    B or C, ``lj``) in its own pallas_call over ``n_chunks`` chunks, in
    interpret mode, with its main()'s specs."""
    mod = load(WINDOW_MODULES[probe])
    A = mod.A if probe < 3 else mod.A_
    C, W = mod.C, mod.W
    f32 = jnp.float32
    if probe == 1:
        kern, n_out = mod.kernel, 2
        scratch = [pltpu.VMEM((3, A, W), f32), pltpu.SemaphoreType.DMA]
    elif probe == 2 or variant == "A":
        kern = mod.kernel if probe == 2 else functools.partial(mod.kernel_A,
                                                               lj=lj)
        n_out = 3
        scratch = [pltpu.VMEM((3, A, W), f32),
                   pltpu.VMEM((27, 3, A, mod.CB), f32),
                   pltpu.SemaphoreType.DMA((1,))]
    else:
        kern = functools.partial(mod.kernel_BC, lj=lj, ref_acc=variant == "B")
        n_out = 3
        scratch = [pltpu.VMEM((3, A, W), f32), pltpu.SemaphoreType.DMA((1,))]
    return pl.pallas_call(
        kern, grid=(n_chunks,),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=[pl.BlockSpec((A, C), lambda i: (0, i),
                                memory_space=pltpu.VMEM)] * n_out,
        out_shape=[jax.ShapeDtypeStruct((A, n_chunks * C), f32)] * n_out,
        scratch_shapes=scratch, interpret=True)


def norm_rel(a, b) -> float:
    """max |a - b| / max |b|."""
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-300)


def bit_equal(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(
        a.view(np.int32), b.view(np.int32))


def check_plain_against_archive(probe, variant, lj, n_chunks):
    """The port's plain version against the archive's kernel on the same
    make_inputs array: every element within 1e-5 of its own scale (the sum
    of its terms' magnitudes, window_pair_magnitude) and every output
    within 1e-5 of its largest value."""
    rp = window.make_inputs(probe, n_chunks)
    sp = window.spec(probe, lj)
    want = [np.asarray(o) for o in window_call(probe, variant, lj,
                                               n_chunks)(rp)]
    got = window.window_pair_plain(torch.from_numpy(rp), sp)
    scale = window.window_pair_magnitude(torch.from_numpy(rp), sp)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.numpy()
        assert g.shape == w.shape == (window.SLOTS, n_chunks * window.CHUNK)
        assert np.isfinite(g).all()
        assert norm_rel(g, w) <= 1e-5
    assert window.element_error(
        [torch.tensor(w) for w in want], got, scale) <= 1e-5
