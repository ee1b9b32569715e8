"""Synthetic datasets on a ``torch.Generator`` (twin of ``repro.data``)."""
