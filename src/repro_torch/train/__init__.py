"""The train step (microbatch gradient accumulation, AdamW) and the
restartable training loop."""
