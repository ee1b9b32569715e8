"""The models of the port (twin of ``repro.models``): attention, the
dense transformer, the recsys models and their embedding bag, the GAT,
and the converter of the reference's parameters and train states."""
