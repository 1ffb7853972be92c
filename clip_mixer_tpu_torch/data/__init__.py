"""Training data of the port: sources of uint8 batches and their prefetch."""
