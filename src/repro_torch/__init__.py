"""repro_torch: the PyTorch + CUDA port of the SAH reverse k-MIPS system.

A second package beside the JAX reference ``repro``, with the same
subpackage layout (``core/``, ``kernels/``, ``engine/``, ``data/``): each
module is the twin of the reference module at the same relative path.
It imports neither JAX nor ``repro``. The Pallas kernels on the main path
are hand-written CUDA kernels for Hopper (``kernels/csrc/``), built at
first use; on CPU tensors their plain PyTorch versions run instead.
"""

from repro_torch.engine.config import EngineConfig, get_config
from repro_torch.engine.engine import RkMIPSEngine

__all__ = ["EngineConfig", "RkMIPSEngine", "get_config"]
