"""Training: stage curriculum, optimizer and step, data, sources, checkpoints, loop."""
