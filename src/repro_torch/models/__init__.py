"""The model zoo: config, layers, attention (self and cross), MLA,
Mamba-2, MoE, decoder layers and the language model (the training
forward and loss, prefill + decode)."""
