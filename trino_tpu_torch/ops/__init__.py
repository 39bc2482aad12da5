"""Device operators: aggregation, key packing and the hand-written kernels."""
