"""The LM model of the port (twin of ``repro.models``): attention,
the dense transformer and the converter of the reference's parameters."""
