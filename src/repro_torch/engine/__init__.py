"""The port's engine layer: ``EngineConfig``, the registry,
``IndexArtifact`` (save, load, staged deltas, compact), the staged build,
``RkMIPSEngine``, and the serving stack: the micro-batched servers
(``engine/serving.py``), the threaded runtime with background compaction
(``engine/runtime.py``) and the multi-tenant gateway
(``engine/gateway.py``). The names are the reference's ``__all__``."""

from repro_torch.engine.artifact import (IndexArtifact, corpus_fingerprint,
                                         load_artifact, reconcile_compaction)
from repro_torch.engine.build import (BuildTimings, build_sah_index,
                                      validate_build_knobs)
from repro_torch.engine.config import (PAPER_BASELINES, TIE_EPS_DEFAULT,
                                       EngineConfig, display_name,
                                       get_config, method_names, register)
from repro_torch.engine.engine import (KMIPSResult, PruningFunnel,
                                       QueryResult, RkMIPSEngine,
                                       serving_codes)
from repro_torch.engine.gateway import (GatewayStats, ServingGateway,
                                        TenantPolicy)
from repro_torch.engine.runtime import (RuntimeStats, ServeTicket,
                                        ServingRuntime, TicketExpired,
                                        WorkerPool)
from repro_torch.engine.serving import (RetrievalServer, ReverseResult,
                                        ReverseServer, ServeResult,
                                        ServingCache, ServingState,
                                        build_serving_state,
                                        state_from_index,
                                        validate_query_rows)

__all__ = [
    "BuildTimings",
    "EngineConfig",
    "GatewayStats",
    "IndexArtifact",
    "KMIPSResult",
    "PAPER_BASELINES",
    "PruningFunnel",
    "QueryResult",
    "RetrievalServer",
    "ReverseResult",
    "ReverseServer",
    "RkMIPSEngine",
    "RuntimeStats",
    "ServeResult",
    "ServeTicket",
    "ServingCache",
    "ServingGateway",
    "ServingRuntime",
    "ServingState",
    "TIE_EPS_DEFAULT",
    "TenantPolicy",
    "TicketExpired",
    "WorkerPool",
    "build_sah_index",
    "build_serving_state",
    "corpus_fingerprint",
    "display_name",
    "get_config",
    "load_artifact",
    "method_names",
    "reconcile_compaction",
    "register",
    "serving_codes",
    "state_from_index",
    "validate_build_knobs",
]
