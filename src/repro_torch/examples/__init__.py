"""Twins of the reference's walkthroughs (``examples/*.py``), one module
each with the same basename, run as

    PYTHONPATH=src python -m repro_torch.examples.<name> [--device cpu]

  quickstart          an engine from a registry preset, reverse queries,
                      F1 against the exact oracle, the pruning funnel
  update_stream       artifact v1 -> v4 under a live ``ReverseServer``:
                      inserts, deletes, ``swap``, ``compact``, save/load
  serve_async         the threaded runtime with background compaction,
                      deadlines and ``close()``
  serve_multitenant   two tenants on one worker pool, warmup, a scan
                      budget, admission control, churn
  reverse_recommend   two-tower embeddings -> the SAH index -> the
                      audience of promoted items, beside forward top-k
  serve_retrieval     two-tower retrieval through the forward server
                      against the exact ``ip_topk``: recall@k and QPS
  train_lm            an LM trained with checkpoints and a resume

Each keeps its reference's flags and defaults and adds ``--device``
(default ``cuda``) and ``--seed``. ``main(argv)`` parses the flags, draws
the data from a ``torch.Generator`` and calls ``run(...)``, which takes
the arrays (or the model config), prints the reference's lines in the
same order and format, and returns a dict of what it printed. Every
``assert`` of a reference example is a check that raises under
``python -O`` too (``_common.check``).
"""
