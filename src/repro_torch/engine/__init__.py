"""The port's engine layer: ``EngineConfig``, the registry and
``RkMIPSEngine``."""

from repro_torch.engine.config import (PAPER_BASELINES, EngineConfig,
                                       get_config, method_names)
from repro_torch.engine.engine import (PruningFunnel, QueryResult,
                                       RkMIPSEngine)

__all__ = ["EngineConfig", "PAPER_BASELINES", "PruningFunnel",
           "QueryResult", "RkMIPSEngine", "get_config", "method_names"]
