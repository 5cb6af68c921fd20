"""Compute primitives of the port: dense graph batching, the graph-diagonal
aggregation kernels, losses and the optimizer."""
