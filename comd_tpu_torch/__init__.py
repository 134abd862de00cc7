"""comd_tpu_torch: the comd_tpu molecular-dynamics engine on PyTorch + CUDA.

The port of comd_tpu (JAX on a TPU) to PyTorch on an NVIDIA H100: the same
Config, CLI flags, cell layout and goldens, with comd_tpu's Pallas kernels
rewritten as hand-written CUDA kernels (csrc/).  Everything comd_tpu runs
runs here, in one process or in a multi-process launch (one block of the
mesh's shards a process, parallel/dist.py), the kernel-initiated
transports too (across processes through CUDA IPC receive planes,
parallel/ki_comm.py).

The package imports torch and numpy only (never jax or comd_tpu).  Energy
sums are taken in Config.energy_dtype (f64) whatever the dynamics dtype.
"""
from .config import Config
from .sim import Simulation, init_simulation

__all__ = ["Config", "Simulation", "init_simulation"]
__version__ = "0.1.0"
