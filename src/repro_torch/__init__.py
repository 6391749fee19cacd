"""PyTorch/CUDA port of the SMaRTT packet simulator.

Mirrors the layout of the JAX package (``netsim/``, ``core/``,
``kernels/<name>/{ref,kernel,ops}.py``) so every counterpart is easy to
find.  The hot-loop kernels are hand-written CUDA C++ for Hopper
(``csrc/*.cu``), built at first use into ``build/repro_torch/`` at the
repository root and bound with ``ctypes``.

Entry points run on the card unless the caller asks for the CPU::

    from repro_torch.netsim import scenarios
    sim = scenarios.scenario("perm_1024n_3t").build()            # cuda
    sim = scenarios.scenario("tiny_perm4").build(device="cpu")   # plain
    st = sim.run(20_000)
"""
