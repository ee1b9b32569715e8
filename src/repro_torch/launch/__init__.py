"""Entry points of the port (twin of ``repro.launch``): ``serve.py``,
two-tower retrieval through the SAH sketch index, and ``train.py``, the
train launcher with failure recovery. The dry-run cells, the mesh and
roofline tools wait for their slice (ROADMAP.md)."""
