"""repro_torch: the PyTorch + CUDA port of the SAH reverse k-MIPS system
and of the LM the reference serves.

A second package beside the JAX reference ``repro``, with the same
subpackage layout (``core/``, ``kernels/``, ``engine/``, ``data/``,
``models/``, ``configs/``, ``examples/``): each module is the twin of the
reference module at the same relative path. It imports neither JAX nor
``repro``. The Pallas kernels on its paths are hand-written CUDA kernels
for Hopper (``kernels/csrc/``), built at first use; on CPU tensors their
plain PyTorch versions run instead.

The front door is the reference's: the engine registry (every paper
baseline a named preset of one ``RkMIPSEngine``), the artifact and the
serving runtime, plus the LM entry points.
"""

from repro_torch.engine import (PAPER_BASELINES, EngineConfig, IndexArtifact,
                                RkMIPSEngine, ServingRuntime, TicketExpired,
                                display_name, get_config, load_artifact,
                                method_names, register)
from repro_torch.models.transformer import (LMConfig, decode_step,
                                            init_params, prefill)

__all__ = [
    "EngineConfig",
    "IndexArtifact",
    "LMConfig",
    "PAPER_BASELINES",
    "RkMIPSEngine",
    "ServingRuntime",
    "TicketExpired",
    "decode_step",
    "display_name",
    "get_config",
    "init_params",
    "load_artifact",
    "method_names",
    "prefill",
    "register",
]
