"""Training: losses, optimizer, state, steps, checkpoints and the Trainer
(counterparts of ``dasmtl/train/``)."""
