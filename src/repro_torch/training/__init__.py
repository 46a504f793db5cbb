"""Training: synthetic data, AdamW and the train step (port of repro/training)."""
