"""Training: optimizer, train/eval steps, state and checkpoints, the loop."""
