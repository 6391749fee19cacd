"""ssd_chunk_scan kernel: plain version (ref), CUDA wrapper (kernel), dispatch (ops)."""
