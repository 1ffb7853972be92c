"""Model modules of the port: layers, mixer blocks, towers, CLIP, weight bridge."""
