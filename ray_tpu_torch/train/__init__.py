"""Training on one card: state, optimizer, trainer and checkpoints."""
