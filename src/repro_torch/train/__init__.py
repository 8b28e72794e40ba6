"""Training (port of ``repro.train``): AdamW, checkpoints, the loop,
supervised restarts and gradient compression."""
