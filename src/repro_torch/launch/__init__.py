"""Serving entry points of the port (twin of ``repro.launch``): so far
``serve.py``, two-tower retrieval through the SAH sketch index. The
dry-run cells, launchers and roofline tools wait for their slice
(ROADMAP.md)."""
