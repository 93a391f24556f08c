"""Training loop and checkpoints of the port."""
