"""Training of the port (twin of ``repro.train``): the optimizers
(``optimizer.py``), int8 error-feedback compression (``compression.py``),
the train step and loop (``trainer.py``) and the checkpoint layout that
train states and index artifacts are saved in (``checkpoint.py``)."""
