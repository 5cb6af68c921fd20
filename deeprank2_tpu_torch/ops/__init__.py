"""Compute primitives of the port: dense, clustered, block-sparse,
blocked-edge and COO graph batching, the aggregation, slot max-pool,
message-sum and sorted segment-sum kernels, segment ops and community
pooling, losses and the optimizer."""
