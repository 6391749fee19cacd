"""red_mark kernel: plain version (ref), CUDA wrapper (kernel), dispatch (ops)."""
