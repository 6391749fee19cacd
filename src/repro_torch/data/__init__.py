"""The deterministic synthetic token stream that training reads."""
