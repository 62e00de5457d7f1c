"""Training: the AdamW optimizer, seeded data streams, checkpoints and the
train step and loop."""
