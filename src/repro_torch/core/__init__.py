"""Congestion control (SMaRTT) and load balancing (REPS and baselines)."""
