"""Compute primitives of the port: dense and clustered graph batching, the
graph-diagonal aggregation and slot max-pool kernels, segment ops and
community pooling, losses and the optimizer."""
