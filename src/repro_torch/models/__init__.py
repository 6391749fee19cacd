"""Serving path of the model zoo: config, layers, attention, Mamba-2,
decoder layers and the language model (prefill + decode)."""
