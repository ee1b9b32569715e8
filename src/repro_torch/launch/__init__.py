"""Entry points of the port (twin of ``repro.launch``): ``serve.py``,
two-tower retrieval through the SAH sketch index; ``train.py``, the
train launcher with failure recovery; ``cells.py``, ``dryrun.py``,
``roofline.py`` and ``perf.py``, the cell catalogue on one device; and
``mesh.py``, the production and test meshes over an initialized world."""
