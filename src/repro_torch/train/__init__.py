"""Training-side helpers of the port; so far the checkpoint layout that
index artifacts are saved in (``checkpoint.py``)."""
