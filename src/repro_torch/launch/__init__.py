"""Entry points: serving and training."""
