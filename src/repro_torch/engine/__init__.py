"""The port's engine layer: ``EngineConfig``, the registry,
``IndexArtifact`` (save, load, staged deltas, compact), the staged build
and ``RkMIPSEngine``."""

from repro_torch.engine.artifact import (IndexArtifact, corpus_fingerprint,
                                         load_artifact, reconcile_compaction)
from repro_torch.engine.build import (BuildTimings, build_sah_index,
                                      validate_build_knobs)
from repro_torch.engine.config import (PAPER_BASELINES, EngineConfig,
                                       get_config, method_names)
from repro_torch.engine.engine import (KMIPSResult, PruningFunnel,
                                       QueryResult, RkMIPSEngine)

__all__ = ["BuildTimings", "EngineConfig", "IndexArtifact", "KMIPSResult",
           "PAPER_BASELINES", "PruningFunnel", "QueryResult", "RkMIPSEngine",
           "build_sah_index", "corpus_fingerprint", "get_config",
           "load_artifact", "method_names", "reconcile_compaction",
           "validate_build_knobs"]
