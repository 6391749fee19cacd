"""cc_update kernel: plain version (ref), CUDA wrapper (kernel), dispatch (ops)."""
