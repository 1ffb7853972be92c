"""Training pieces of the port: the LR schedule, the optimiser, metrics, checkpoints and the trainer."""
