"""comd_tpu_torch: the comd_tpu molecular-dynamics engine on PyTorch + CUDA.

The port of comd_tpu (JAX on a TPU) to PyTorch on an NVIDIA H100: the same
Config, CLI flags, cell layout and goldens, with the Pallas cell-stencil
force kernel rewritten as a hand-written CUDA kernel (csrc/stencil.cu).
This slice covers the serial EAM run; other options raise
NotImplementedError naming the ROADMAP.md item that ports them.

The package imports torch and numpy only (never jax or comd_tpu).  Energy
sums are taken in Config.energy_dtype (f64) whatever the dynamics dtype.
"""
from .config import Config
from .sim import Simulation, init_simulation

__all__ = ["Config", "Simulation", "init_simulation"]
__version__ = "0.1.0"
