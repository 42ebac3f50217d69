"""CTR training: the trainer, its train step, AdamW for the tower and
checkpoints."""
