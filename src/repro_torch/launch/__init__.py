"""Launch layer: the production meshes, the spec trees of parameters,
optimizer state and step inputs, and the dry run."""
