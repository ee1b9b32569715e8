"""repro_torch: the PyTorch + CUDA port of the SAH reverse k-MIPS system
and of the LM the reference serves.

A second package beside the JAX reference ``repro``, with the same
subpackage layout (``core/``, ``kernels/``, ``engine/``, ``data/``,
``models/``, ``configs/``): each module is the twin of the reference
module at the same relative path. It imports neither JAX nor ``repro``.
The Pallas kernels on its paths are hand-written CUDA kernels for Hopper
(``kernels/csrc/``), built at first use; on CPU tensors their plain
PyTorch versions run instead.
"""

from repro_torch.engine.config import EngineConfig, get_config
from repro_torch.engine.engine import RkMIPSEngine
from repro_torch.models.transformer import (LMConfig, decode_step,
                                            init_params, prefill)

__all__ = ["EngineConfig", "LMConfig", "RkMIPSEngine", "decode_step",
           "get_config", "init_params", "prefill"]
