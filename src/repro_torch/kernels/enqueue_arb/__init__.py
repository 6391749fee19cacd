"""enqueue_arb kernel: plain version (ref), CUDA wrapper (kernel), dispatch (ops)."""
