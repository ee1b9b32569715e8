"""Synthetic datasets on a ``torch.Generator`` and the numpy graph
sampler (twin of ``repro.data``)."""
