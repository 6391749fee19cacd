"""Hand-written Hopper kernels (the simulator's tick and the serving
path's prefill), each beside its plain version.

Every ``kernels/<name>/`` holds ``ref.py`` (the plain PyTorch version,
which the CPU tests run and the card compares against), ``kernel.py``
(the ctypes wrapper of the CUDA source in ``csrc/``, with its launch
count) and ``ops.py`` (backend dispatch: ``"kernel"`` launches the CUDA
kernel for a CUDA tensor and takes the plain version for a CPU tensor;
``"plain"`` always takes the plain version).
"""
