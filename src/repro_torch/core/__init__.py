"""The paper's algorithms as plain functions on tensors (twins of
``repro.core``): srp, partitions, cone, simpfer, sa_alsh, sah, exact,
metrics."""
