"""Serving path of the model zoo: config, layers, attention (self and
cross), MLA, Mamba-2, MoE, decoder layers and the language model
(prefill + decode)."""
