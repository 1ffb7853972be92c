"""Training pieces of the port: the LR schedule and the optimiser."""
