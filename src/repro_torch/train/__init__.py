"""Training: AdamW, the train step, checkpoints and the fault-tolerant loop."""
