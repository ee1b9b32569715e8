"""The paper's algorithms as plain functions on tensors (twins of
``repro.core``; no state, no meshes, no device binding: those live in
``repro_torch.engine`` and ``repro_torch.launch``):

  transforms   SAT / QNF asymmetric item transforms
  srp          sign-random-projection hashing helpers
  partitions   norm-range partitioning (Algorithm 1 lines 3-6)
  sa_alsh      SA-ALSH index build + sketch/exact scans (Algorithms 1-2)
  cone         cone blocking of users (Algorithm 3)
  simpfer      Simpfer lower-bound arrays and O(1) decisions
  sah          the SAH index and query (Algorithms 4-5)
  exact        brute-force kMIPS / RkMIPS oracles
  metrics      F1 / recall scoring

``rows.py`` (fixed-shape row chunks) is a helper of the port's own.
Application code should normally go through ``repro_torch.engine``.
"""

from repro_torch.core import (cone, exact, metrics, partitions, sa_alsh, sah,
                              simpfer, srp, transforms)

__all__ = [
    "cone",
    "exact",
    "metrics",
    "partitions",
    "sa_alsh",
    "sah",
    "simpfer",
    "srp",
    "transforms",
]
